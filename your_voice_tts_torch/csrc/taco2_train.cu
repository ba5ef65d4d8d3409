// Tacotron2 teacher-forced training decoder for Hopper (sm_90a): the
// forward recurrence and its reverse-time backward.
//
// Replaces: your_voice_tts_tpu/ops/pallas/taco2_train.py
//           `taco2_train_fwd_pallas` (its `_fwd_kernel`) and
//           `taco2_train_bwd_pallas` (its `_bwd_kernel`): the teacher-forced
//           scan of models/decoder_grad.py, forward and reverse, each as one
//           Pallas launch with the weights in VMEM.
//
// What bounds it on the H100: every step is a chain of dependent batched
// matrix-vector products (B rows, a few dozen) over ~19M weights (~38 MB in
// bf16 at full width, forward; the same again transposed, backward), plus a
// per-row attention block of T_in x A work. The weights come from L2 or HBM
// on every step, and the serial chain of 3 (forward) or 4 (backward)
// stages per step cannot overlap. The arithmetic bound is far below what
// the chain costs; a step is bound by how fast each stage streams its
// weights and how many SMs its work spreads over.
//
// Forward: 2 launches a step plus one, all issued from C in one call
// (taco2_train_fwd_scan) as programmatic dependent launches. The attention
// LSTM of step t + 1 and the decoder LSTM of step t read nothing the other
// writes, so one launch runs both on disjoint blocks; of their inputs only
// the context depends on the attention of step t. Each kernel signals the
// next one only after its own wait, so a launch that starts finds the one
// two before it finished: the LSTM launch runs its products over every
// input but the context while the attention runs, and the attention its
// location features while the LSTM launch finishes. The step's serial chain
// is the attention after its wait and the LSTM launch's context products,
// cluster exchange and cell update. The LSTM products (bf16) run on the
// tensor cores from the interleaved gate rows in fragment order, each
// weight read once a step for every batch row, the reduction over the
// inputs split over a cluster of blocks (one an SM beside an attention
// block) whose partial sums meet in distributed shared memory; the block
// that sums a unit's four gate rows adds the biases and runs the cell
// update. The attention runs as a cluster of up to four blocks a batch row
// (a part of the text positions, of H1 and of E each), exchanging the
// query projection's partials, the norm's partials and the alignments.
// float32 keeps the FMA products (lstm_fwd_kernel).
//
// Backward (redesigned): 4 launches a step, all Ts x 4 issued from C in one
// call (taco2_train_bwd_scan). The decoder cell backward is elementwise.
// The two W^T products (bf16) run on the tensor cores (mma.sync m16n8k16)
// from a fragment-ordered copy of W^T that ops/taco2_train.py builds once
// per optimizer step, reading each weight once a step for every batch row;
// the 4H reduction is split over a thread-block cluster of up to 8 blocks
// whose partial sums meet in distributed shared memory, so that ~20 bands of
// 128 rows fill the card. The attention backward (recomputed energies, the
// norm and energy backward, the location backward as a correlation with
// the [2, K, A] filter folded with the location dense: no banded T x T
// matrix, the query's backward and the attention LSTM's gate backward) runs
// as a cluster of up to four blocks a batch row, each owning a part of the
// text positions, the attention units and H1, exchanging the projection,
// the norm's sums, dpq and the location correlation's halo rows through
// distributed shared memory; in bf16 the correlation runs on mma.sync. The
// launches are programmatic dependent launches: each kernel starts while
// its predecessor runs and waits for it only where it first touches the
// scan's carries, so the products' weight loads and the attention's
// recomputation leave the step's serial chain. float32 keeps the FMA
// products (matT_kernel).
//
// Numerics follow the Pallas kernels: h, c and the context are held in the
// working type T (bf16 or float32) between steps, gate math and sums run in
// float32, gates, cells and gate cotangents are stored in T, alignments,
// energy cotangents and the backward carries in float32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "decode_common.cuh"

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// x rounded to the working type
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// Programmatic dependent launch (sm_90): the scans' kernels let the next
// kernel of the stream start at once (pdl_release) and wait for the
// previous one's results (pdl_wait) only where they first read or write
// what the scan's other launches touch; before that they read only the
// weights and the scan's inputs (the prenet frames, the encoder's, the
// forward's residuals). Both are no-ops in a launch
// without the attribute.
__device__ __forceinline__ void pdl_release() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// two floats rounded to bf16, lo in the low half: one register of an mma
// operand
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive elements as floats (16-byte aligned for bf16, 32 for f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
    unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float f[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, float f[8]) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}
__device__ __forceinline__ void ldg8(const float* p, float f[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// acc[bb] += sum_i w[i] * xs[bb * ld + i] over one warp (partial per lane);
// ld is a multiple of 8.
template <typename T, int NB>
__device__ __forceinline__ void warp_gemv(const T* __restrict__ w, const T* xs, int ld,
                                          float acc[NB]) {
    const int lane = threadIdx.x & 31;
    for (int i = lane * 8; i < ld; i += 256) {
        float wf[8];
        ldg8(w + i, wf);
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
            float xf[8];
            load8(xs + bb * ld + i, xf);
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) s = fmaf(wf[k], xf[k], s);
            acc[bb] += s;
        }
    }
}

// Where element i of row b of [x0 | x1 | x2] lives; null past the inputs,
// past B, and for a null input.
template <typename T>
__device__ __forceinline__ const T* source(int b, int i, int B, const T* x0, int n0,
                                           const T* x1, int n1, const T* x2, int n2) {
    if (b >= B) return nullptr;
    if (i < n0) return x0 ? x0 + (size_t)b * n0 + i : nullptr;
    if (i < n0 + n1) return x1 ? x1 + (size_t)b * n1 + i - n0 : nullptr;
    if (i < n0 + n1 + n2) return x2 ? x2 + (size_t)b * n2 + i - n0 - n1 : nullptr;
    return nullptr;
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Stage [x0 | x1 | x2] of batch rows b0 .. b0 + kBT - 1 into xs [kBT][ld]
// (ld a multiple of 8), zero where `source` is null: 16-byte copies of 8
// elements when every segment is a multiple of 8 long and 16-byte
// aligned, else element by element.
template <typename T>
__device__ void stage(T* xs, int ld, int b0, int B, const T* x0, int n0,
                      const T* x1, int n1, const T* x2, int n2) {
    const bool vec = ((n0 | n1 | n2) & 7) == 0 && aligned16(x0) && aligned16(x1) &&
                     aligned16(x2);
    for (int bb = 0; bb < kBT; ++bb) {
        T* row = xs + bb * ld;
        if (vec) {
            for (int i = threadIdx.x * 8; i < ld; i += blockDim.x * 8) {
                const T* src = source(b0 + bb, i, B, x0, n0, x1, n1, x2, n2);
                uint4* dst = reinterpret_cast<uint4*>(row + i);
#pragma unroll
                for (int q = 0; q < (int)sizeof(T) / 2; ++q)
                    dst[q] = src ? reinterpret_cast<const uint4*>(src)[q] : make_uint4(0, 0, 0, 0);
            }
        } else {
            for (int i = threadIdx.x; i < ld; i += blockDim.x) {
                const T* src = source(b0 + bb, i, B, x0, n0, x1, n1, x2, n2);
                row[i] = src ? *src : from_f<T>(0.f);
            }
        }
    }
}

// Backward through an LSTM cell's nonlinearity from its stored
// pre-activations pre[4] (i, f, g, o): d_g[4] and the cotangent of the
// previous cell (decoder_grad._lstm_bwd_local).
__device__ __forceinline__ float lstm_cell_bwd(const float pre[4], float c_prev, float c,
                                               float d_h, float d_c, float d_g[4]) {
    const float i = sigmoidf_(pre[0]), f = sigmoidf_(pre[1]);
    const float g = tanhf(pre[2]), o = sigmoidf_(pre[3]);
    const float tc = tanhf(c);
    const float d_o = d_h * tc;
    const float d_ct = d_c + d_h * o * (1.f - tc * tc);
    d_g[0] = (d_ct * g) * i * (1.f - i);
    d_g[1] = (d_ct * c_prev) * f * (1.f - f);
    d_g[2] = (d_ct * i) * (1.f - g * g);
    d_g[3] = d_o * o * (1.f - o);
    return d_ct * f;
}

// --------------------------------------------------------------- backward

// Decoder LSTM cell backward, elementwise over [B, H]: d_h = d_h_carry +
// d_y * mask, through the gates; writes d_gates (T, block layout) and the
// cell carry d_c in place.
template <typename T>
__global__ void cell_bwd_kernel(const T* gates, const T* c_prev, const T* c,
                                const float* d_h_carry, const T* d_y, const T* mask,
                                float* d_c, T* d_gates, int B, int H) {
    pdl_release();
    pdl_wait();
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= B * H) return;
    const int b = idx / H, j = idx - b * H;
    const size_t k = (size_t)b * H + j;
    float pre[4], dg[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] = to_f(gates[(size_t)b * 4 * H + g * H + j]);
    const float dy = to_f(d_y[k]);
    const float dh = d_h_carry[k] + (mask ? dy * to_f(mask[k]) : dy);
    d_c[k] = lstm_cell_bwd(pre, c_prev ? to_f(c_prev[k]) : 0.f, to_f(c[k]), dh, d_c[k], dg);
#pragma unroll
    for (int g = 0; g < 4; ++g) d_gates[(size_t)b * 4 * H + g * H + j] = from_f<T>(dg[g]);
}

// Products with the transposed weights: v[b, row] = sum_k dg[b, k] WT[row, k]
// for the rows [seg 0 | seg 1 | seg 2] of an LSTM's input [x0 | x1 | h].
// mode 0 (decoder LSTM, segments q | ctx | h2):
//   f0 = v (d_q); tot = v + add1 + carry1 -> f1 (f32) and t1 (T) (the total
//   context cotangent); f2 = v (d_h2 carry).
// mode 1 (attention LSTM, segments prenet | ctx | h1):
//   t0 = v in T (d_prenet); carry1 = v (d_ctx carry); f2 = v (d_h1 carry).
// Each warp takes kMatRows rows, so a block's staged cotangents serve
// kWarps * kMatRows rows.
constexpr int kMatRows = 4;

template <typename T>
__device__ __forceinline__ void matT_store(float v, int row, int b, int n0, int n1, int n2,
                                           int mode, float* f0, T* t0, const T* add1,
                                           float* carry1, float* f1, T* t1, float* f2) {
    if (row < n0) {
        const size_t k = (size_t)b * n0 + row;
        if (mode == 0) f0[k] = v;
        else t0[k] = from_f<T>(v);
    } else if (row < n0 + n1) {
        const size_t k = (size_t)b * n1 + row - n0;
        if (mode == 0) {
            const float tot = v + to_f(add1[k]) + carry1[k];
            f1[k] = tot;
            t1[k] = from_f<T>(tot);
        } else {
            carry1[k] = v;
        }
    } else {
        f2[(size_t)b * n2 + row - n0 - n1] = v;
    }
}

template <typename T>
__global__ void matT_kernel(const T* WT, int ld, const T* dg, int n_in, int n0, int n1,
                            int n2, int B, int mode, float* f0, T* t0, const T* add1,
                            float* carry1, float* f1, T* t1, float* f2) {
    extern __shared__ __align__(16) unsigned char smem[];
    pdl_release();
    pdl_wait();
    T* xs = reinterpret_cast<T*>(smem);
    const int b0 = blockIdx.y * kBT;
    stage<T>(xs, ld, b0, B, dg, n_in, nullptr, 0, nullptr, 0);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = b0 + lane;
    for (int r = 0; r < kMatRows; ++r) {
        const int row = (blockIdx.x * kMatRows + r) * kWarps + warp;
        if (row >= n0 + n1 + n2) break;
        float acc[kBT] = {};
        warp_gemv<T, kBT>(WT + (size_t)row * ld, xs, ld, acc);
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) acc[bb] = warp_sum(acc[bb]);
        if (lane < kBT && b < B)
            matT_store<T>(pick(acc, lane), row, b, n0, n1, n2, mode, f0, t0, add1, carry1, f1,
                          t1, f2);
    }
}

// Products with the transposed weights on the tensor cores (bf16): the
// same v and epilogue as matT_kernel, for every batch row at once. A block
// owns a band of kBand weight rows (a warp a 16-row tile) and one of the
// cluster's `cs` slices of the 4H reduction (k-tiles of 16); a batch slice
// of up to kMmaNT n-tiles of 8 rows is the grid's z. Each warp streams its
// tile's A fragments from W^T in fragment order (16 bytes a lane a k-tile,
// read once a step for every batch row) a chunk ahead of the mma.sync
// that use them; d_g's chunks of kChunk k-tiles come through shared memory
// with cp.async, double-buffered. The cluster's partial sums meet through
// distributed shared memory: block `rank` sums its share of the band's
// rows over the cluster's blocks in rank order and runs matT_store on them.
constexpr int kMmaWarps = 8;                  // 16-row tiles a block
constexpr int kBand = kMmaWarps * 16;         // weight rows a block
constexpr int kMmaNT = 8;                     // n-tiles a batch slice holds at most
constexpr int kChunk = 8;                     // k-tiles a staged chunk of d_g
constexpr int kChunkLd = kChunk * 16 + 8;     // its row stride in bf16: rows 4 banks apart

struct MatMma {
    const uint4* Wf;                          // W^T [RT][K16][32] fragments of 8 bf16
    int RT, K16;                              // row tiles, k-tiles
    const bf16* dg;                           // d_g [B, n_in]
    int n_in, n0, n1, n2, B, mode, ntl;       // ntl: n-tiles a slice (staged rows / 8)
    float* f0;
    bf16* t0;
    const bf16* add1;
    float* carry1;
    float* f1;
    bf16* t1;
    float* f2;
};

size_t mat_mma_smem(int ntl) {
    return (size_t)2 * ntl * 8 * kChunkLd * sizeof(bf16) + (size_t)kBand * (ntl * 8 + 4) * 4;
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying k-tiles c0 .. c0 + kChunk - 1 of d_g's rows b0 .. b0 + 8 ntl
// - 1 into xs [8 ntl][kChunkLd]: zeros past B and past n_in; 16-byte copies
// where d_g's rows are 16-byte aligned, else element by element.
__device__ void stage_dg(bf16* xs, const MatMma& p, int b0, int c0, bool vec) {
    constexpr int nv = kChunk * 2;                             // 8-element vectors a row
    const int n = p.ntl * 8 * nv;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int bb = i / nv, v = i - bb * nv, b = b0 + bb, k = c0 * 16 + 8 * v;
        bf16* dst = xs + bb * kChunkLd + 8 * v;
        const bf16* src = p.dg + (size_t)b * p.n_in + k;
        if (vec && b < p.B && k < p.n_in) {
            cp_async16(dst, src);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                dst[e] = b < p.B && k + e < p.n_in ? src[e] : __float2bfloat16_rn(0.f);
        }
    }
}

__global__ void __launch_bounds__(kMmaWarps * 32, 2) matT_mma_kernel(const MatMma p) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int band = blockIdx.x / cs;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int rt = band * kMmaWarps + warp;
    const bool live = rt < p.RT;
    const int per = (p.K16 + cs - 1) / cs;
    const int kt0 = min(p.K16, rank * per), kt1 = min(p.K16, kt0 + per);
    const int nch = (kt1 - kt0 + kChunk - 1) / kChunk;
    const int b0 = blockIdx.z * kMmaNT * 8, rows = p.ntl * 8, pld = rows + 4;
    const int stage_elems = rows * kChunkLd;
    bf16* xs = reinterpret_cast<bf16*>(smem);
    float* part = reinterpret_cast<float*>(xs + 2 * stage_elems);     // [kBand][pld]
    const bool vec = (p.n_in & 7) == 0 && aligned16(p.dg);
    const uint4* wa = p.Wf + (size_t)rt * p.K16 * 32 + lane;
    float acc[kMmaNT][4];
#pragma unroll
    for (int j = 0; j < kMmaNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    uint4 a[kChunk], nx[kChunk];
    auto fetch = [&](uint4 (&dst)[kChunk], int c) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
            const int k = kt0 + c * kChunk + i;
            dst[i] = live && k < kt1 ? __ldg(wa + (size_t)k * 32) : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    // the weights need nothing of the previous launch: the first chunk into
    // registers and the rest of the slice into L2 while it runs
    pdl_release();
    fetch(a, 0);
    if (live)
        for (int k = kt0 + kChunk; k < kt1; ++k)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(wa + (size_t)k * 32));
    pdl_wait();
    if (nch > 0) stage_dg(xs, p, b0, kt0, vec);
    cp_async_commit();
    for (int c = 0; c < nch; ++c) {
        if (c + 1 < nch)
            stage_dg(xs + ((c + 1) & 1) * stage_elems, p, b0, kt0 + (c + 1) * kChunk, vec);
        cp_async_commit();
        fetch(nx, c + 1);                                      // in flight during the mma
        cp_async_wait_group<1>();
        __syncthreads();
        if (live) {
            const bf16* xb = xs + (c & 1) * stage_elems + g * kChunkLd + 2 * q;
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
                if (kt0 + c * kChunk + i >= kt1) break;
#pragma unroll
                for (int j = 0; j < kMmaNT; ++j)
                    if (j < p.ntl) {
                        const bf16* xk = xb + j * 8 * kChunkLd + 16 * i;
                        mma16816(acc[j], a[i], *reinterpret_cast<const uint32_t*>(xk),
                                 *reinterpret_cast<const uint32_t*>(xk + 8));
                    }
            }
        }
        __syncthreads();                                       // the buffer is restaged next
#pragma unroll
        for (int i = 0; i < kChunk; ++i) a[i] = nx[i];
    }
    float* pw = part + warp * 16 * pld;
#pragma unroll
    for (int j = 0; j < kMmaNT; ++j)
        if (j < p.ntl) {
            pw[g * pld + j * 8 + 2 * q] = acc[j][0];
            pw[g * pld + j * 8 + 2 * q + 1] = acc[j][1];
            pw[(g + 8) * pld + j * 8 + 2 * q] = acc[j][2];
            pw[(g + 8) * pld + j * 8 + 2 * q + 1] = acc[j][3];
        }
    cluster.sync();                                            // every block's partials
    const int r0 = rank * kBand / cs, r1 = (rank + 1) * kBand / cs;
    const int nb = min(rows, p.B - b0), R = p.n0 + p.n1 + p.n2;
    for (int i = threadIdx.x; i < (r1 - r0) * nb; i += blockDim.x) {
        const int lr = r0 + i / nb, bb = i - (i / nb) * nb, row = band * kBand + lr;
        if (row >= R) continue;
        float v = 0.f;
        for (int o = 0; o < cs; ++o) v += cluster.map_shared_rank(part, o)[lr * pld + bb];
        matT_store<bf16>(v, row, b0 + bb, p.n0, p.n1, p.n2, p.mode, p.f0, p.t0, p.add1, p.carry1,
                         p.f1, p.t1, p.f2);
    }
    cluster.sync();                                            // no block leaves while read
}

// Which of the `cs` even parts [r n / cs, (r + 1) n / cs) of [0, n) holds i.
__device__ __forceinline__ int part_of(int i, int n, int cs) {
    int r = cs - 1;
    while (r * n / cs > i) --r;
    return r;
}

// The attention backward's arguments, one step.
template <typename T>
struct AttnBwd {
    const T *g_a, *c_a, *c_a_prev, *m_a, *q_w, *u, *pinp, *enc;
    const float *v_w, *v_b, *maskadd, *att_prev, *cum_prev, *d_align_out, *d_ctx, *d_q, *d_h1;
    float *d_att, *d_cum, *d_c1, *d_e_out;
    T* d_g_a;
    int ldq, H1, K, loc, Tn, A, E, softmax;
    int probe;                        // 0, or the phase to stop after (probe launches)
};

constexpr int kAttnThreads = 512;
constexpr int kQ2Parts = 4;          // parts of A a d_q2 sum is split into

// One block's shared memory in the attention backward's cluster: the float
// offset of each array (hq, the query in T, 16-byte aligned) and the bytes.
// Tq text positions at most a block; th in [A][TLD], TLD odd, so that a warp
// over t or over a reads without bank conflicts.
struct AttnLayout {
    int Tq, TLD, Jq, K2, S;
    int us, pq, dpq, dpqf, vw, xa, xc, sv, dal, red, nrm, comb, th, G, Gh, dctx, q2, hq;
    size_t bytes;
};

__host__ __device__ inline AttnLayout attn_layout(int Tn, int A, int K, int E, int ldq, int H1,
                                                  int cs, int esize) {
    AttnLayout L;
    L.Tq = (Tn + cs - 1) / cs;
    L.TLD = L.Tq | 1;
    L.Jq = (H1 + cs - 1) / cs;
    L.K2 = 2 * K;
    L.S = 2 * K + 1;
    int o = 0;
    L.us = o;   o += L.S * A;                 // u[c, k, a] at a * S + c * K + k
    L.pq = o;   o += A;                       // the query projection, every unit
    L.dpq = o;  o += A;                       // sum over this block's t of d_tanh
    L.dpqf = o; o += A;                       // over every t, rounded to T
    L.vw = o;   o += A;                       // v
    L.xa = o;   o += L.Tq + L.K2;             // rounded att_prev over the window
    L.xc = o;   o += L.Tq + L.K2;             // rounded cum_prev
    L.sv = o;   o += L.Tq;                    // energies, then s or exp(e - m)
    L.dal = o;  o += L.Tq;                    // d_align, then d_e
    L.red = o;  o += 32;
    L.nrm = o;  o += 4;                       // this block's norm partials
    L.comb = o; o += 4;                       // the cluster's combined norm
    L.th = o;   o += A * L.TLD;               // tanh, then d_tanh
    L.G = o;    o += L.Tq * L.K2;             // location correlation of this block's t
    L.Gh = o;   o += (L.Tq + K - 1) * L.K2;   // the rows its location backward reads
    L.dctx = o; o += E;                       // d_ctx_total of the batch row
    L.q2 = o;   o += kQ2Parts * L.Jq;         // d_q2 partial sums
    L.hq = (o + 3) & ~3;
    L.bytes = (size_t)L.hq * sizeof(float) + (size_t)ldq * esize;
    return L;
}

// The attention block's backward and the attention LSTM's gate backward for
// one step, a cluster of `cs` blocks a batch row. Block r owns the r-th of
// cs even parts of the text positions, of the attention units and of H1.
// Every block recomputes the query (q = sigmoid(o) tanh(c) * mask) and
// projects its units; the cluster gathers the projection (cluster barrier
// 1). Each block recomputes its positions' energies from the previous
// alignments and d_align = d_align_out + d_ctx_total . enc + d_att + d_cum,
// and publishes its partial norm sums (softmax: max, sum of exp, sum of
// d_align exp; sigmoid: sum of s, sum of d_align s; barrier 2). From the
// combined sums: d_e, d_tanh, this block's part of dpq = sum_t d_tanh (a
// warp a unit) and its rows of the location correlation G[t, c, k] =
// sum_a rnd(d_tanh[t, a]) u[c, k, a] (a warp a position, lanes over (c, k);
// barrier 3). Then dpq summed over the cluster in rank order, the location
// backward d_prev[c, t'] = sum_k G[t' - k + pad, c, k], reading the rows of
// G past its part's edges from their owners (d_att replaced, d_cum
// accumulated; barrier 4: no block leaves while another reads it), and, for
// its H1 units, d_q2 = rnd(dpq) q_w and the cell backward of
// d_h1 = d_h1_carry + (d_q + d_q2) * mask.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads, 2) attn_bwd_kernel(const AttnBwd<T> p) {
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
    const int Tn = p.Tn, A = p.A, K = p.K, H1 = p.H1;
    const AttnLayout L = attn_layout(Tn, A, K, p.E, p.ldq, H1, cs, (int)sizeof(T));
    float *us = sm + L.us, *pq = sm + L.pq, *dpq = sm + L.dpq, *dpqf = sm + L.dpqf;
    float *xa = sm + L.xa, *xc = sm + L.xc, *sv = sm + L.sv, *dal = sm + L.dal;
    float *red = sm + L.red, *nrm = sm + L.nrm, *comb = sm + L.comb, *th = sm + L.th;
    float *G = sm + L.G, *Gh = sm + L.Gh, *dctx = sm + L.dctx, *q2 = sm + L.q2, *vw = sm + L.vw;
    T* hq = reinterpret_cast<T*>(sm + L.hq);
    const int b = blockIdx.x / cs, tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
    const int pad = (K - 1) / 2, K2 = L.K2, S = L.S, TLD = L.TLD;
    const int t0 = r * Tn / cs, ntl = (r + 1) * Tn / cs - t0;
    const int a0 = r * A / cs, a1 = (r + 1) * A / cs;
    const int j0 = r * H1 / cs, nj = (r + 1) * H1 / cs - j0;
    const size_t gb = (size_t)b * 4 * H1, rb = (size_t)b * Tn;

    pdl_release();
    for (int a = tid; a < A; a += nt) vw[a] = p.v_w[a];
    if (p.loc) {
        if ((K2 * A & 7) == 0 && aligned16(p.u)) {
            for (int i = tid * 8; i < K2 * A; i += nt * 8) {
                float f[8];
                ldg8(p.u + i, f);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int ck = (i + e) / A, a = i + e - ck * A;
                    us[a * S + ck] = f[e];
                }
            }
        } else {
#pragma unroll 4
            for (int i = tid; i < K2 * A; i += nt) {
                const int ck = i / A, a = i - ck * A;
                us[a * S + ck] = to_f(p.u[i]);
            }
        }
    }
    for (int j = tid; j < p.ldq; j += nt) {
        float qv = 0.f;
        if (j < H1) {
            qv = sigmoidf_(to_f(p.g_a[gb + 3 * H1 + j])) * tanhf(to_f(p.c_a[(size_t)b * H1 + j]));
            if (p.m_a) qv *= to_f(p.m_a[(size_t)b * H1 + j]);
        }
        hq[j] = from_f<T>(qv);
    }
    for (int i = tid; i < ntl + K - 1; i += nt) {
        const int t = t0 + i - pad;
        float va = 0.f, vc = 0.f;
        if (t >= 0 && t < Tn) {
            va = p.att_prev ? rnd<T>(p.att_prev[rb + t]) : 0.f;
            vc = p.cum_prev ? rnd<T>(p.cum_prev[rb + t]) : 0.f;
        }
        xa[i] = va;
        xc[i] = vc;
    }
    __syncthreads();
    if (p.probe == 1) {
        cp_async_wait_all();
        pdl_wait();
        return;
    }
    for (int a = a0 + warp; a < a1; a += nw) {
        const T* wr = p.q_w + (size_t)a * p.ldq;
        float s = 0.f;
#pragma unroll 4
        for (int i = lane * 8; i < p.ldq; i += 256) {
            float wf[8], xf[8];
            ldg8(wr + i, wf);
            load8(hq + i, xf);
#pragma unroll
            for (int e = 0; e < 8; ++e) s = fmaf(wf[e], xf[e], s);
        }
        s = warp_sum(s);
        if (lane == 0) pq[a] = s;
    }
    cluster.sync();                                             // 1: the projection
    for (int a = tid; a < A; a += nt) {
        const int o = part_of(a, A, cs);
        if (o != r) pq[a] = cluster.map_shared_rank(pq, o)[a];
    }
    __syncthreads();
    if (p.probe == 2) {
        cp_async_wait_all();
        pdl_wait();
        cluster.sync();
        return;
    }
    // energies of this block's positions (tanh kept), a warp two positions
    // at once (the filter's shared-memory reads serve both), each pass's
    // global loads issued before its arithmetic
    const float vb = p.v_b[0];
    for (int tl = warp; tl < ntl; tl += 2 * nw) {
        const int tl2 = tl + nw, d2 = tl2 < ntl ? nw : 0;
        const size_t k = rb + t0 + tl, k2 = k + d2;
        float s = 0.f, s2 = 0.f;
        for (int c0 = 0; c0 < A; c0 += 128) {
            float f[4], g[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int a = c0 + lane + 32 * i;
                f[i] = a < A ? to_f(p.pinp[k * A + a]) : 0.f;
                g[i] = a < A ? to_f(p.pinp[k2 * A + a]) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int a = c0 + lane + 32 * i;
                const float q = a < A ? pq[a] : 0.f;
                f[i] = q + f[i];
                g[i] = q + g[i];
            }
            if (p.loc) {
                const float* u0 = us + (c0 + lane) * S;
#pragma unroll 2
                for (int kk = 0; kk < K; ++kk) {
                    const float x0 = xa[tl + kk], x1 = xc[tl + kk];
                    const float y0 = xa[tl + d2 + kk], y1 = xc[tl + d2 + kk];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        if (c0 + lane + 32 * i < A) {
                            const float ua = u0[32 * i * S + kk], uc = u0[32 * i * S + K + kk];
                            f[i] = fmaf(ua, x0, fmaf(uc, x1, f[i]));
                            g[i] = fmaf(ua, y0, fmaf(uc, y1, g[i]));
                        }
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int a = c0 + lane + 32 * i;
                if (a >= A) continue;
                const float h = tanhf(f[i]), h2 = tanhf(g[i]);
                th[a * TLD + tl] = h;
                if (d2) th[a * TLD + tl2] = h2;
                s += h * vw[a];
                s2 += h2 * vw[a];
            }
        }
        s = warp_sum(s);
        s2 = warp_sum(s2);
        if (lane == 0) {
            sv[tl] = s + vb + p.maskadd[k];
            if (d2) sv[tl2] = s2 + vb + p.maskadd[k2];
        }
    }
    // d_align = d_align_out + d_ctx_total . enc + d_att + d_cum: the first
    // reads of the scan's carries; two positions a warp
    pdl_wait();
    for (int i = tid; i < p.E; i += nt) dctx[i] = p.d_ctx[(size_t)b * p.E + i];
    __syncthreads();
    const bool enc8 = (p.E & 7) == 0 && aligned16(p.enc);
    for (int tl = warp; tl < ntl; tl += 2 * nw) {
        const int tl2 = tl + nw, d2 = tl2 < ntl ? nw : 0;
        const size_t k = rb + t0 + tl, k2 = k + d2;
        float o[3] = {0.f, 0.f, 0.f}, o2[3] = {0.f, 0.f, 0.f};
        if (lane == 0) {
            o[0] = p.d_align_out[k]; o[1] = p.d_att[k]; o[2] = p.d_cum[k];
            o2[0] = p.d_align_out[k2]; o2[1] = p.d_att[k2]; o2[2] = p.d_cum[k2];
        }
        float dc = 0.f, dc2 = 0.f;
        const T *row = p.enc + k * p.E, *row2 = p.enc + k2 * p.E;
        if (enc8) {
#pragma unroll 2
            for (int i = lane * 8; i < p.E; i += 256) {
                float ef[8], eg[8];
                ldg8(row + i, ef);
                ldg8(row2 + i, eg);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    dc = fmaf(dctx[i + e], ef[e], dc);
                    dc2 = fmaf(dctx[i + e], eg[e], dc2);
                }
            }
        } else {
            for (int i = lane; i < p.E; i += 32) {
                dc = fmaf(dctx[i], to_f(row[i]), dc);
                dc2 = fmaf(dctx[i], to_f(row2[i]), dc2);
            }
        }
        dc = warp_sum(dc);
        dc2 = warp_sum(dc2);
        if (lane == 0) {
            dal[tl] = o[0] + dc + o[1] + o[2];
            if (d2) dal[tl2] = o2[0] + dc2 + o2[1] + o2[2];
        }
    }
    __syncthreads();
    if (p.probe == 3) {
        cp_async_wait_all();
        cluster.sync();
        return;
    }
    // this block's partial norm sums
    if (p.softmax) {
        float m = -INFINITY;
        for (int tl = tid; tl < ntl; tl += nt) m = fmaxf(m, sv[tl]);
        m = block_reduce<true>(m, red);
        float se = 0.f, sd = 0.f;
        for (int tl = tid; tl < ntl; tl += nt) {
            const float e = expf(sv[tl] - m);
            sv[tl] = e;
            se += e;
            sd += dal[tl] * e;
        }
        se = block_reduce<false>(se, red);
        sd = block_reduce<false>(sd, red);
        if (tid == 0) { nrm[0] = m; nrm[1] = se; nrm[2] = sd; }
    } else {
        float se = 0.f, sd = 0.f;
        for (int tl = tid; tl < ntl; tl += nt) {
            const float s = sigmoidf_(sv[tl]);
            sv[tl] = s;
            se += s;
            sd += dal[tl] * s;
        }
        se = block_reduce<false>(se, red);
        sd = block_reduce<false>(sd, red);
        if (tid == 0) { nrm[0] = 0.f; nrm[1] = se; nrm[2] = sd; }
    }
    cluster.sync();                                             // 2: the norm's sums
    if (tid == 0) {
        float tot = 0.f, dot = 0.f;
        if (p.softmax) {
            float M = -INFINITY;
            for (int o = 0; o < cs; ++o) M = fmaxf(M, cluster.map_shared_rank(nrm, o)[0]);
            for (int o = 0; o < cs; ++o) {
                const float* n = cluster.map_shared_rank(nrm, o);
                const float sc = expf(n[0] - M);
                tot += n[1] * sc;
                dot += n[2] * sc;
            }
            comb[0] = expf(nrm[0] - M) / tot;          // exp(e - m) -> alignment
            comb[1] = dot / tot;                        // sum_t d_align alignment
        } else {
            for (int o = 0; o < cs; ++o) {
                const float* n = cluster.map_shared_rank(nrm, o);
                tot += n[1];
                dot += n[2];
            }
            comb[0] = fmaxf(tot, 1e-8f);
            comb[1] = dot / comb[0];
        }
    }
    __syncthreads();
    for (int tl = tid; tl < ntl; tl += nt) {
        float de;
        if (p.softmax) {
            de = sv[tl] * comb[0] * (dal[tl] - comb[1]);
        } else {
            const float s = sv[tl];
            de = (dal[tl] - comb[1]) / comb[0] * s * (1.f - s);
        }
        dal[tl] = de;
    }
    __syncthreads();
    if (p.probe == 4) {
        cp_async_wait_all();
        cluster.sync();
        return;
    }
    // energy backward: d_tanh in place of tanh
    for (int i = tid; i < A * ntl; i += nt) {
        const int a = i / ntl, tl = i - a * ntl;
        const float h = th[a * TLD + tl];
        th[a * TLD + tl] = dal[tl] * vw[a] * (1.f - h * h);
    }
    __syncthreads();
    for (int a = warp; a < A; a += nw) {
        float s = 0.f;
        for (int tl = lane; tl < ntl; tl += 32) s += th[a * TLD + tl];
        s = warp_sum(s);
        if (lane == 0) dpq[a] = s;
    }
    if (p.loc) {
        if constexpr (std::is_same<T, bf16>::value) {
            // bf16: 16-position x 8-tap tiles of mma.sync m16n8k16, a warp
            // a tile, the fragments packed from th (rounded) and the filter
            const int g = lane >> 2, q = lane & 3;
            const int NT8 = (K2 + 7) / 8, tiles = (ntl + 15) / 16 * NT8;
            for (int it = warp; it < tiles; it += nw) {
                const int mt = it / NT8, n8 = it - mt * NT8;
                const int r0 = mt * 16 + g, r1 = r0 + 8, ck = n8 * 8 + g;
                auto dt = [&](int r, int a) { return r < ntl && a < A ? th[a * TLD + r] : 0.f; };
                auto uf = [&](int a) { return ck < K2 && a < A ? us[a * S + ck] : 0.f; };
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                for (int a0 = 2 * q; a0 < A + 2 * q; a0 += 16) {
                    uint4 af;
                    af.x = pack_bf16(dt(r0, a0), dt(r0, a0 + 1));
                    af.y = pack_bf16(dt(r1, a0), dt(r1, a0 + 1));
                    af.z = pack_bf16(dt(r0, a0 + 8), dt(r0, a0 + 9));
                    af.w = pack_bf16(dt(r1, a0 + 8), dt(r1, a0 + 9));
                    mma16816(d, af, pack_bf16(uf(a0), uf(a0 + 1)),
                             pack_bf16(uf(a0 + 8), uf(a0 + 9)));
                }
                const int c = n8 * 8 + 2 * q;
                if (r0 < ntl && c < K2) G[r0 * K2 + c] = d[0];
                if (r0 < ntl && c + 1 < K2) G[r0 * K2 + c + 1] = d[1];
                if (r1 < ntl && c < K2) G[r1 * K2 + c] = d[2];
                if (r1 < ntl && c + 1 < K2) G[r1 * K2 + c + 1] = d[3];
            }
        } else {
            for (int tl = warp; tl < ntl; tl += 2 * nw) {
                const int tl2 = min(tl + nw, ntl - 1);
                for (int c0 = 0; c0 < K2; c0 += 64) {
                    const int ck0 = min(c0 + lane, K2 - 1), ck1 = min(c0 + lane + 32, K2 - 1);
                    float g00 = 0.f, g01 = 0.f, g10 = 0.f, g11 = 0.f;
#pragma unroll 4
                    for (int a = 0; a < A; ++a) {
                        const float d0 = rnd<T>(th[a * TLD + tl]), d1 = rnd<T>(th[a * TLD + tl2]);
                        const float u0 = us[a * S + ck0], u1 = us[a * S + ck1];
                        g00 = fmaf(d0, u0, g00);
                        g01 = fmaf(d0, u1, g01);
                        g10 = fmaf(d1, u0, g10);
                        g11 = fmaf(d1, u1, g11);
                    }
                    if (c0 + lane < K2) G[tl * K2 + c0 + lane] = g00;
                    if (c0 + lane + 32 < K2) G[tl * K2 + c0 + lane + 32] = g01;
                    if (tl + nw < ntl) {
                        if (c0 + lane < K2) G[tl2 * K2 + c0 + lane] = g10;
                        if (c0 + lane + 32 < K2) G[tl2 * K2 + c0 + lane + 32] = g11;
                    }
                }
            }
        }
    }
    cluster.sync();                                             // 3: dpq parts, G
    if (p.probe == 5) {
        cp_async_wait_all();
        cluster.sync();
        return;
    }
    for (int a = tid; a < A; a += nt) {
        float s = 0.f;
        for (int o = 0; o < cs; ++o) s += cluster.map_shared_rank(dpq, o)[a];
        dpqf[a] = rnd<T>(s);
    }
    for (int tl = tid; tl < ntl; tl += nt) p.d_e_out[rb + t0 + tl] = dal[tl];
    // location backward of this block's positions: the rows of G its
    // window reads (t0 - (K - 1 - pad) .. t1 - 1 + pad) copied from their
    // owners, then summed here
    const int h0 = t0 - (K - 1 - pad), nh = ntl + K - 1;
    if (p.loc)
        for (int i = tid; i < nh * K2; i += nt) {
            const int hr = i / K2, ck = i - hr * K2, t = h0 + hr;
            float v = 0.f;
            if (t >= 0 && t < Tn) {
                const int o = part_of(t, Tn, cs);
                v = cluster.map_shared_rank(G, o)[(t - o * Tn / cs) * K2 + ck];
            }
            Gh[i] = v;
        }
    cluster.sync();                                             // 4: reads done
    if (p.probe == 6) {
        cp_async_wait_all();
        return;
    }
    for (int i = tid; i < 2 * ntl; i += nt) {
        const int c = i / ntl, tl = i - c * ntl;
        float s = 0.f;
        if (p.loc)
            for (int k = 0; k < K; ++k) s += Gh[(tl + K - 1 - k) * K2 + c * K + k];
        if (c == 0) p.d_att[rb + t0 + tl] = s;
        else p.d_cum[rb + t0 + tl] += s;
    }
    // d_q2 = rnd(dpq) q_w over this block's H1 units, in kQ2Parts parts of A
    for (int i = tid; i < kQ2Parts * nj; i += nt) {
        const int part = i / nj, jl = i - part * nj;
        const T* col = p.q_w + j0 + jl;
        float s = 0.f;
#pragma unroll 8
        for (int a = part * A / kQ2Parts; a < (part + 1) * A / kQ2Parts; ++a)
            s = fmaf(dpqf[a], to_f(col[(size_t)a * p.ldq]), s);
        q2[part * L.Jq + jl] = s;
    }
    __syncthreads();
    for (int jl = tid; jl < nj; jl += nt) {
        const int j = j0 + jl;
        float s = 0.f;
        for (int part = 0; part < kQ2Parts; ++part) s += q2[part * L.Jq + jl];
        const size_t k = (size_t)b * H1 + j;
        float dq = p.d_q[k] + s;
        if (p.m_a) dq *= to_f(p.m_a[k]);
        float pre[4], dg[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] = to_f(p.g_a[gb + g * H1 + j]);
        p.d_c1[k] = lstm_cell_bwd(pre, p.c_a_prev ? to_f(p.c_a_prev[k]) : 0.f, to_f(p.c_a[k]),
                                  p.d_h1[k] + dq, p.d_c1[k], dg);
#pragma unroll
        for (int g = 0; g < 4; ++g) p.d_g_a[gb + g * H1 + j] = from_f<T>(dg[g]);
    }
}

// ---------------------------------------------------------------- forward
// (after the backward's kernels: it shares their tensor-core tiles and
// cluster helpers)

// One LSTM step of the forward scan: gates = W [x0 | x1 | h_in] + bias over
// interleaved gate rows (row 4 j + g is unit j's gate g), then the cell
// update. Writes the pre-activations (block layout [B, 4H]), the new cell
// and h in T, and y = h * mask (or h) in T. Null x1 / h_in / c_prev read
// as 0.
struct LstmJob {
    const void* W;               // bf16: fragments [RT][K16][32] x 8; float: rows [4H, ld]
    const float* bias;           // [4H], interleaved
    int ld;
    const void *x0, *x1, *h_in, *c_prev, *mask;
    int n0, n1, H;
    void *h_out, *c_out, *gates_out, *y_out;
    int blocks;                  // blocks of the grid's x the job takes
};

// One launch: one or two LSTM steps on disjoint ranges of blocks (the
// decoder LSTM of step t and the attention LSTM of step t + 1 read nothing
// the other writes). ntl: n-tiles of 8 batch rows a batch slice (bf16).
struct LstmFwd {
    LstmJob job[2];
    int B, ntl;
    int probe;                   // 0, or the phase to stop after (probe launches)
};

// The cell update of unit j, batch row b, from its four pre-activations.
template <typename T>
__device__ __forceinline__ void lstm_cell_fwd(const LstmJob& J, const float pre[4], int b, int j) {
    const int H = J.H;
    const size_t k = (size_t)b * H + j;
    const float cp = J.c_prev ? to_f(static_cast<const T*>(J.c_prev)[k]) : 0.f;
    const float cn = sigmoidf_(pre[1]) * cp + sigmoidf_(pre[0]) * tanhf(pre[2]);
    const float h = sigmoidf_(pre[3]) * tanhf(cn);
    T* gates = static_cast<T*>(J.gates_out) + (size_t)b * 4 * H + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) gates[g * H] = from_f<T>(pre[g]);
    static_cast<T*>(J.c_out)[k] = from_f<T>(cn);
    static_cast<T*>(J.h_out)[k] = from_f<T>(h);
    const T* mask = static_cast<const T*>(J.mask);
    static_cast<T*>(J.y_out)[k] = from_f<T>(mask ? h * to_f(mask[k]) : h);
}

// float32: one warp a unit (its four gate rows) with FMA, an 8-row batch
// tile a block row of the grid.
__global__ void lstm_fwd_kernel(const __grid_constant__ LstmFwd p) {
    extern __shared__ __align__(16) unsigned char smem[];
    pdl_wait();
    pdl_release();
    const int jb = (int)blockIdx.x >= p.job[0].blocks;
    const LstmJob& J = p.job[jb];
    const int bx = (int)blockIdx.x - (jb ? p.job[0].blocks : 0);
    float* xs = reinterpret_cast<float*>(smem);
    const int b0 = blockIdx.y * kBT;
    stage<float>(xs, J.ld, b0, p.B, static_cast<const float*>(J.x0), J.n0,
                 static_cast<const float*>(J.x1), J.n1, static_cast<const float*>(J.h_in), J.H);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = bx * kWarps + warp;
    if (j >= J.H) return;
    const float* W = static_cast<const float*>(J.W);
    float acc[4][kBT] = {};
#pragma unroll
    for (int g = 0; g < 4; ++g)
        warp_gemv<float, kBT>(W + (size_t)(4 * j + g) * J.ld, xs, J.ld, acc[g]);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) acc[g][bb] = warp_sum(acc[g][bb]);
    const int b = b0 + lane;
    if (lane >= kBT || b >= p.B) return;
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] = pick(acc[g], lane) + J.bias[4 * j + g];
    lstm_cell_fwd<float>(J, pre, b, j);
}

// Stage batch rows b0 .. b0 + rows - 1 of the k-tiles k = rank + cs kk,
// kk in [kk0, kk1), of [x0 | x1 | h_in] into xs [rows][xld] at column
// 16 kk (cp.async; the caller waits), zeros past B, past the inputs and for
// a null input. 16-byte copies where every segment is a multiple of 8 long
// and 16-byte aligned, else element by element; either way through L2 only
// (cp.async.cg, __ldcg), as the carries come from earlier launches.
__device__ void stage_tiles(bf16* xs, int xld, const LstmJob& J, int B, int b0, int rows,
                            int rank, int cs, int kk0, int kk1) {
    const bf16 *x0 = static_cast<const bf16*>(J.x0), *x1 = static_cast<const bf16*>(J.x1);
    const bf16* x2 = static_cast<const bf16*>(J.h_in);
    const int n0 = J.n0, n1 = J.n1, n2 = J.H;
    const bool vec = ((n0 | n1 | n2) & 7) == 0 && aligned16(x0) && aligned16(x1) && aligned16(x2);
    const int per_el = vec ? 8 : 1, nv = 16 / per_el * (kk1 - kk0);
    for (int i = threadIdx.x; i < rows * nv; i += blockDim.x) {
        const int bb = i / nv, e = (i - bb * nv) * per_el;
        const int kk = kk0 + e / 16, c = e % 16;
        const bf16* src = source(b0 + bb, (rank + cs * kk) * 16 + c, B, x0, n0, x1, n1, x2, n2);
        bf16* dst = xs + bb * xld + kk * 16 + c;
        if (!vec) *dst = src ? __ldcg(src) : __float2bfloat16_rn(0.f);
        else if (src) cp_async16(dst, src);
        else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
}

// bf16: the LSTM products on the tensor cores (mma.sync m16n8k16) from W
// in fragment order, for every batch row at once. A block owns a band of
// kBand interleaved gate rows (a warp a 16-row tile: 4 units x 4 gates)
// and the k-tiles k = rank + cs kk of the cluster's `cs` (interleaved, so
// that each block holds an even share of the context's tiles); a batch
// slice of up to kMmaNT n-tiles is the grid's z. Every input but the
// context (x1) is final before the launch starts (the scan's kernels
// signal the next one only after their own wait), so the block stages
// and multiplies all its other tiles before it waits for the attention,
// and only the context's tiles after. Each warp streams its tile's A
// fragments (16 bytes a lane a k-tile, read once a step for every batch
// row) a chunk of kFwdChunk k-tiles ahead of the mma.sync that use them,
// in two register buffers used in turn. At up to 32 batch rows (NT = 4) a
// thread has 64 registers, so that two blocks sit on an SM beside an
// attention block and every block's products run while the attention
// does. The cluster's partial sums meet in distributed shared memory:
// block `rank` sums its share of the band's units (all four gate rows of
// each) over the cluster's blocks in rank order, adds the biases and runs
// the cell update.
size_t lstm_mma_smem(int ntl, int per) {
    const size_t xs = (size_t)ntl * 8 * (per * 16 + 8) * sizeof(bf16);
    const size_t part = (size_t)kBand * (ntl * 8 + 1) * sizeof(float);
    return xs > part ? xs : part;
}

constexpr int kFwdChunk = 4;                  // k-tiles of weights a warp loads at once

template <int NT>                             // n-tiles of 8 batch rows a block, at most
__global__ void __launch_bounds__(kMmaWarps * 32, NT <= 4 ? 4 : 2)
    lstm_mma_kernel(const __grid_constant__ LstmFwd p) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int jb = (int)blockIdx.x >= p.job[0].blocks;
    const LstmJob& J = p.job[jb];
    const int band = ((int)blockIdx.x - (jb ? p.job[0].blocks : 0)) / cs;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int H = J.H, RT = (4 * H + 15) / 16, K16 = (J.n0 + J.n1 + H + 15) / 16;
    const int rt = band * kMmaWarps + warp;
    const bool live = rt < RT;
    // this block's k-tiles, and [kp0, kp1), the ones over the context
    const int nk = rank < K16 ? (K16 - rank + cs - 1) / cs : 0;
    const int kf = J.n0 / 16, kl = (J.n0 + J.n1 - 1) / 16;
    const int kp0 = min(nk, kf > rank ? (kf - rank + cs - 1) / cs : 0);
    const int kp1 = max(kp0, min(nk, kl >= rank ? (kl - rank) / cs + 1 : 0));
    const int npost = kp1 - kp0, npre = nk - npost;
    constexpr int C = kFwdChunk;
    const int ncp = (npre + C - 1) / C, nch = ncp + (npost + C - 1) / C;
    // chunk c covers positions [s0, s1) of the order: the tiles before the
    // wait, then the context's
    auto s0_of = [&](int c) { return c < ncp ? c * C : npre + (c - ncp) * C; };
    auto s1_of = [&](int c) {
        return c < ncp ? min(npre, (c + 1) * C) : min(nk, npre + (c + 1 - ncp) * C);
    };
    auto tile_of = [&](int s) { return s < npre ? (s < kp0 ? s : s + npost) : kp0 + s - npre; };
    const int b0 = blockIdx.z * kMmaNT * 8, rows = p.ntl * 8, xld = nk * 16 + 8, pld = rows + 1;
    bf16* xs = reinterpret_cast<bf16*>(smem);                  // [rows][xld]
    float* part = reinterpret_cast<float*>(smem);              // [kBand][pld], after the products
    const uint4* wa = static_cast<const uint4*>(J.W) + (size_t)rt * K16 * 32 + lane;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    uint4 a[kFwdChunk], b[kFwdChunk];
    auto fetch = [&](uint4 (&dst)[kFwdChunk], int c) {
        const int s0 = c < nch ? s0_of(c) : 0, s1 = c < nch ? s1_of(c) : 0;
#pragma unroll
        for (int i = 0; i < kFwdChunk; ++i) {
            const int k = rank + cs * tile_of(s0 + i);
            dst[i] = live && s0 + i < s1 ? __ldg(wa + (size_t)k * 32) : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    // chunk c's products; before the first of the context's tiles, the wait
    // for the attention that writes the context, and its staging
    auto run = [&](const uint4 (&w)[kFwdChunk], int c) {
        if (c == ncp) {
            pdl_wait();
            pdl_release();
            stage_tiles(xs, xld, J, p.B, b0, rows, rank, cs, kp0, kp1);
            cp_async_wait_all();
            __syncthreads();
        }
        if (!live) return;
        const int s0 = s0_of(c), s1 = s1_of(c);
        const bf16* xb = xs + g * xld + 2 * q;
#pragma unroll
        for (int i = 0; i < kFwdChunk; ++i) {
            if (s0 + i >= s1) break;
            const bf16* xt = xb + 16 * tile_of(s0 + i);
#pragma unroll
            for (int j = 0; j < NT; ++j)
                if (j < p.ntl) {
                    const bf16* xk = xt + j * 8 * xld;
                    mma16816(acc[j], w[i], *reinterpret_cast<const uint32_t*>(xk),
                             *reinterpret_cast<const uint32_t*>(xk + 8));
                }
        }
    };
    fetch(a, 0);
    stage_tiles(xs, xld, J, p.B, b0, rows, rank, cs, 0, kp0);
    stage_tiles(xs, xld, J, p.B, b0, rows, rank, cs, kp1, nk);
    cp_async_wait_all();
    __syncthreads();
    if (p.probe == 1) {
        pdl_wait();
        pdl_release();
        return;
    }
    // two buffers in turn, so that the next chunk's loads are in flight
    // while a chunk's products run
    for (int c = 0; c < nch; c += 2) {
        fetch(b, c + 1);
        run(a, c);
        fetch(a, c + 2);
        if (c + 1 < nch) run(b, c + 1);
    }
    if (ncp == nch) {                                          // no context tile here
        pdl_wait();
        pdl_release();
    }
    __syncthreads();                                           // xs becomes the partial sums
    float* pw = part + warp * 16 * pld;
#pragma unroll
    for (int j = 0; j < NT; ++j)
        if (j < p.ntl) {
            pw[g * pld + j * 8 + 2 * q] = acc[j][0];
            pw[g * pld + j * 8 + 2 * q + 1] = acc[j][1];
            pw[(g + 8) * pld + j * 8 + 2 * q] = acc[j][2];
            pw[(g + 8) * pld + j * 8 + 2 * q + 1] = acc[j][3];
        }
    if (p.probe == 2) return;
    cluster.sync();                                            // every block's partials
    if (p.probe == 3) {
        cluster.sync();
        return;
    }
    // this block's units, lanes over units (coalesced stores; pld odd: the
    // lanes' reads fall in distinct banks), four ranks' loads issued at once
    constexpr int kUnits = kBand / 4;                          // units a band
    const int u0 = rank * kUnits / cs, nu = (rank + 1) * kUnits / cs - u0;
    const int nb = min(rows, p.B - b0);
    for (int i = threadIdx.x; i < nu * nb; i += blockDim.x) {
        const int bb = i / nu, lu = u0 + i - bb * nu, j = band * kUnits + lu;
        if (j >= H) continue;
        float pre[4] = {0.f, 0.f, 0.f, 0.f};
        for (int o0 = 0; o0 < cs; o0 += 4) {
            float v[4][4];
#pragma unroll
            for (int o = 0; o < 4; ++o) {
                const float* po = o0 + o < cs
                    ? cluster.map_shared_rank(part, o0 + o) + 4 * lu * pld + bb : nullptr;
#pragma unroll
                for (int gg = 0; gg < 4; ++gg) v[o][gg] = po ? po[gg * pld] : 0.f;
            }
#pragma unroll
            for (int o = 0; o < 4; ++o)
#pragma unroll
                for (int gg = 0; gg < 4; ++gg) pre[gg] += v[o][gg];
        }
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) pre[gg] += J.bias[4 * j + gg];
        lstm_cell_fwd<bf16>(J, pre, b0 + bb, j);
    }
    cluster.sync();                                            // no block leaves while read
}

// A cluster barrier in two halves: arrive once this block reads no other
// block's shared memory, wait before it leaves.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 8 consecutive elements of T as loaded from global memory (bf16: one
// 16-byte word), unpacked when used.
template <typename T>
struct Vec8;
template <>
struct Vec8<bf16> {
    uint4 v;
    __device__ __forceinline__ void ldg(const bf16* p) {
        v = __ldg(reinterpret_cast<const uint4*>(p));
    }
    __device__ __forceinline__ void zero() { v = make_uint4(0u, 0u, 0u, 0u); }
    __device__ __forceinline__ void get(float f[8]) const { unpack8(v, f); }
};
template <>
struct Vec8<float> {
    float4 a, b;
    __device__ __forceinline__ void ldg(const float* p) {
        a = __ldg(reinterpret_cast<const float4*>(p));
        b = __ldg(reinterpret_cast<const float4*>(p + 4));
    }
    __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ __forceinline__ void get(float f[8]) const {
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
};

// The attention forward's arguments, one step. cum is updated in place.
template <typename T>
struct AttnFwd {
    const T *q, *q_w, *u, *pinp, *enc;
    const float *v_w, *v_b, *maskadd, *att_prev;
    float *cum, *align_out;
    T* ctx_out;
    int ldq, H1, K, loc, Tn, A, E, softmax;
    int probe;                        // 0, or the phase to stop after (probe launches)
};

// One block's shared memory in the attention forward's cluster: the float
// offset of each array (hq, its part of the query, and enc, its columns of
// the encoder's rows, both in T and 16-byte aligned) and the bytes. Tq text
// positions at most a block, Jq elements of H1, Ec columns of E; enc's row
// stride ELD is an odd multiple of 16 bytes, so that the 16-byte reads of
// eight lanes over eight rows fall in distinct banks. The encoder's columns
// are staged (stage) only where they fit beside the rest (at full width,
// K = 31: up to T_in 484 in bf16, 296 in float32); past that the context
// reads them from global memory, and the rest fits up to T_in 1,460.
constexpr size_t kSmemOptin = 232448;         // dynamic shared memory a block may use on the H100

struct AttnFwdLayout {
    int Tq, Jq, Ec, ELD, S, W;
    int us, vw, pp, pq, xa, xc, pin, sv, al, red, nrm, sc, hq, enc;
    bool stage;
    size_t bytes;
};

__host__ __device__ inline AttnFwdLayout attn_fwd_layout(int Tn, int A, int K, int H1, int E,
                                                         int cs, int esize) {
    AttnFwdLayout L;
    L.Tq = (Tn + cs - 1) / cs;
    L.Jq = ((H1 + 7) / 8 + cs - 1) / cs * 8;
    L.Ec = ((E + 7) / 8 + cs - 1) / cs * 8;
    L.ELD = (L.Ec * esize / 16 | 1) * 16 / esize;
    L.S = 2 * K + 1;
    L.W = L.Tq + K - 1;
    int o = 0;
    L.us = o;  o += L.S * A;                  // u[c, k, a] at a * S + c * K + k
    L.vw = o;  o += A;                        // v
    L.pp = o;  o += A;                        // this block's part of the projection
    L.pq = o;  o += A;                        // the projection, summed over the cluster
    L.xa = o;  o += L.W;                      // rounded att over the window
    L.xc = o;  o += L.W;                      // rounded cum
    L.pin = o; o += L.Tq * A;                 // W_k m of this block's positions
    L.sv = o;  o += L.Tq;                     // mask + v_b, energies, then s or exp(e - m)
    L.al = o;  o += Tn;                       // the alignments of the row
    L.red = o; o += 32;
    L.nrm = o; o += 4;                        // this block's norm partials
    L.sc = o;  o += 8;                        // each block's scale to alignments
    L.hq = (o + 3) & ~3;
    L.enc = L.hq + (L.Jq * esize + 15) / 16 * 4;
    const size_t rest = (size_t)L.enc * sizeof(float), enc = (size_t)Tn * L.ELD * esize;
    L.stage = rest + enc <= kSmemOptin;
    L.bytes = rest + (L.stage ? enc : 0);
    return L;
}

// The location-sensitive attention of one step, a cluster of `cs` blocks a
// batch row. Block r owns the r-th of cs even parts of the text positions,
// of H1 (in chunks of 8) and of E (in chunks of 8). Before the wait it
// loads the scan's inputs: v, the folded filter u, W_k m and the mask of
// its positions, starts copying its columns of the encoder's rows into
// shared memory (cp.async; where they fit, else the context reads them
// from global memory), reads the rounded att / cum over its
// positions' location window (the positions past its part's edges written
// by their owners in the previous step, which finished before this launch
// started) and adds its positions' location features to W_k m. After the
// wait: its part of the query q (T), the partial query projection over its
// part of H1 for every unit, summed over the cluster in rank order (cluster
// barrier 1); the energies of its positions (a warp a position), its norm
// partials: softmax max and sum of exp(e - max), or the sum of sigmoids
// (barrier 2). Every block combines the partials and gathers the whole
// row's alignments from their owners, then writes the alignments and
// cum += alignment of its positions and the context (rounded to T) of its
// columns of E over every position (a warp 8 columns).
template <typename T>
__global__ void __launch_bounds__(kAttnThreads, 2) attn_fwd_kernel(const AttnFwd<T> p) {
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
    const int Tn = p.Tn, A = p.A, K = p.K, H1 = p.H1, E = p.E;
    const AttnFwdLayout L = attn_fwd_layout(Tn, A, K, H1, E, cs, (int)sizeof(T));
    float *us = sm + L.us, *vw = sm + L.vw, *pp = sm + L.pp, *pq = sm + L.pq;
    float *xa = sm + L.xa, *xc = sm + L.xc, *pin = sm + L.pin, *sv = sm + L.sv, *al = sm + L.al;
    float *red = sm + L.red, *nrm = sm + L.nrm, *sc = sm + L.sc;
    T* hq = reinterpret_cast<T*>(sm + L.hq);
    T* encs = reinterpret_cast<T*>(sm + L.enc);
    const int b = blockIdx.x / cs, tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
    const int pad = (K - 1) / 2, S = L.S;
    const int t0 = r * Tn / cs, ntl = (r + 1) * Tn / cs - t0;
    const int nc = (H1 + 7) / 8, j0 = r * nc / cs * 8, nj = (r + 1) * nc / cs * 8 - j0;
    const int ne = (E + 7) / 8, e0 = r * ne / cs, e1 = (r + 1) * ne / cs;
    const size_t rb = (size_t)b * Tn;

    for (int a = tid; a < A; a += nt) vw[a] = p.v_w[a];
    if (p.loc) {
        const int K2 = 2 * K;
        if ((K2 * A & 7) == 0 && aligned16(p.u)) {
            for (int i = tid * 8; i < K2 * A; i += nt * 8) {
                float f[8];
                ldg8(p.u + i, f);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int ck = (i + e) / A, a = i + e - ck * A;
                    us[a * S + ck] = f[e];
                }
            }
        } else {
            for (int i = tid; i < K2 * A; i += nt) {
                const int ck = i / A, a = i - ck * A;
                us[a * S + ck] = to_f(p.u[i]);
            }
        }
    }
    for (int i = tid; i < ntl * A; i += nt) pin[i] = to_f(p.pinp[(rb + t0) * A + i]);
    const float vb = p.v_b[0];
    for (int tl = tid; tl < ntl; tl += nt) sv[tl] = p.maskadd[rb + t0 + tl] + vb;
    // the encoder's rows, this block's columns (zeros past E), where staged
    const bool e8 = (E & 7) == 0 && aligned16(p.enc);
    const int ncol = 8 * (e1 - e0);
    const T* enc0 = p.enc + (size_t)b * Tn * E + 8 * e0;
    if (L.stage && e8) {
        constexpr int kPer = 16 / sizeof(T);                   // elements a 16-byte copy
        const int nv = ncol / kPer;
        for (int i = tid; i < Tn * nv; i += nt) {
            const int t = i / nv, v = i - t * nv;
            cp_async16(encs + t * L.ELD + kPer * v, enc0 + (size_t)t * E + kPer * v);
        }
    } else if (L.stage) {
        for (int i = tid; i < Tn * ncol; i += nt) {
            const int t = i / ncol, c = i - t * ncol;
            encs[t * L.ELD + c] = 8 * e0 + c < E ? enc0[(size_t)t * E + c] : from_f<T>(0.f);
        }
    }
    // the alignment state over the window: final before this launch started
    // (loads that skip L1)
    for (int i = tid; i < ntl + K - 1; i += nt) {
        const int t = t0 + i - pad;
        float va = 0.f, vc = 0.f;
        if (t >= 0 && t < Tn) {
            va = p.att_prev ? rnd<T>(__ldcg(p.att_prev + rb + t)) : 0.f;
            vc = rnd<T>(__ldcg(p.cum + rb + t));
        }
        xa[i] = va;
        xc[i] = vc;
    }
    __syncthreads();
    // the location features of this block's positions, added to W_k m: a
    // warp two positions at once (the filter's shared-memory reads serve
    // both)
    if (p.loc)
        for (int tl = warp; tl < ntl; tl += 2 * nw) {
            const int d2 = tl + nw < ntl ? nw : 0;
            for (int c0 = 0; c0 < A; c0 += 128) {
                float f[4] = {0.f, 0.f, 0.f, 0.f}, g[4] = {0.f, 0.f, 0.f, 0.f};
                const float* u0 = us + (c0 + lane) * S;
#pragma unroll 2
                for (int kk = 0; kk < K; ++kk) {
                    const float x0 = xa[tl + kk], x1 = xc[tl + kk];
                    const float y0 = xa[tl + d2 + kk], y1 = xc[tl + d2 + kk];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        if (c0 + lane + 32 * i < A) {
                            const float ua = u0[32 * i * S + kk], uc = u0[32 * i * S + K + kk];
                            f[i] = fmaf(ua, x0, fmaf(uc, x1, f[i]));
                            g[i] = fmaf(ua, y0, fmaf(uc, y1, g[i]));
                        }
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int a = c0 + lane + 32 * i;
                    if (a >= A) continue;
                    pin[tl * A + a] += f[i];
                    if (d2) pin[(tl + d2) * A + a] += g[i];
                }
            }
        }
    // the scan's carries from here on; the next launch may start once every
    // block is past this wait (so a launch that starts finds the one two
    // before it finished)
    pdl_wait();
    pdl_release();
    for (int i = tid; i < nj; i += nt)
        hq[i] = j0 + i < H1 ? p.q[(size_t)b * H1 + j0 + i] : from_f<T>(0.f);
    cp_async_wait_all();
    __syncthreads();
    if (p.probe == 1) return;
    // this block's part of the projection, four units a warp at once
    for (int a = warp; a < A; a += 4 * nw) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int i = lane * 8; i < nj; i += 256) {
            Vec8<T> wv[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int am = a + m * nw;
                if (am < A) wv[m].ldg(p.q_w + (size_t)am * p.ldq + j0 + i);
                else wv[m].zero();
            }
            float xf[8];
            load8(hq + i, xf);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                float wf[8];
                wv[m].get(wf);
#pragma unroll
                for (int e = 0; e < 8; ++e) s[m] = fmaf(wf[e], xf[e], s[m]);
            }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const float v = warp_sum(s[m]);
            if (lane == 0 && a + m * nw < A) pp[a + m * nw] = v;
        }
    }
    cluster.sync();                                             // 1: the projection's parts
    for (int a = tid; a < A; a += nt) {
        float s = 0.f;
        for (int o = 0; o < cs; ++o) s += cluster.map_shared_rank(pp, o)[a];
        pq[a] = s;
    }
    __syncthreads();
    if (p.probe == 2) {
        cluster.sync();
        return;
    }
    // energies of this block's positions, a warp a position
    for (int tl = warp; tl < ntl; tl += nw) {
        float s = 0.f;
        for (int a = lane; a < A; a += 32) s += tanhf(pq[a] + pin[tl * A + a]) * vw[a];
        s = warp_sum(s);
        if (lane == 0) sv[tl] += s;
    }
    __syncthreads();
    if (p.probe == 3) {
        cluster.sync();
        return;
    }
    // this block's norm partials
    if (p.softmax) {
        float m = -INFINITY;
        for (int tl = tid; tl < ntl; tl += nt) m = fmaxf(m, sv[tl]);
        m = block_reduce<true>(m, red);
        float se = 0.f;
        for (int tl = tid; tl < ntl; tl += nt) {
            const float e = expf(sv[tl] - m);
            sv[tl] = e;
            se += e;
        }
        se = block_reduce<false>(se, red);
        if (tid == 0) { nrm[0] = m; nrm[1] = se; }
    } else {
        float se = 0.f;
        for (int tl = tid; tl < ntl; tl += nt) {
            const float s = sigmoidf_(sv[tl]);
            sv[tl] = s;
            se += s;
        }
        se = block_reduce<false>(se, red);
        if (tid == 0) { nrm[0] = 0.f; nrm[1] = se; }
    }
    cluster.sync();                                             // 2: the norm's partials
    if (tid == 0) {
        float tot = 0.f;
        if (p.softmax) {
            float M = -INFINITY;
            for (int o = 0; o < cs; ++o) M = fmaxf(M, cluster.map_shared_rank(nrm, o)[0]);
            for (int o = 0; o < cs; ++o) {
                const float* n = cluster.map_shared_rank(nrm, o);
                sc[o] = expf(n[0] - M);
                tot += n[1] * sc[o];
            }
            for (int o = 0; o < cs; ++o) sc[o] /= tot;
        } else {
            for (int o = 0; o < cs; ++o) tot += cluster.map_shared_rank(nrm, o)[1];
            const float inv = 1.f / fmaxf(tot, 1e-8f);
            for (int o = 0; o < cs; ++o) sc[o] = inv;
        }
    }
    __syncthreads();
    for (int t = tid; t < Tn; t += nt) {
        const int o = part_of(t, Tn, cs);
        al[t] = cluster.map_shared_rank(sv, o)[t - o * Tn / cs] * sc[o];
    }
    cluster_arrive();                                           // 3: no more remote reads
    __syncthreads();
    if (p.probe == 4) {
        cluster_wait();
        return;
    }
    for (int tl = tid; tl < ntl; tl += nt) {
        const size_t k = rb + t0 + tl;
        const float a = al[t0 + tl];
        p.align_out[k] = a;
        p.cum[k] = __ldcg(p.cum + k) + a;
    }
    // the context of this block's 8-column chunks of E from shared memory
    // (or global memory where not staged), a warp a chunk, lanes over
    // positions
    for (int ch = e0 + warp; ch < e1; ch += nw) {
        const int col = 8 * ch, w8 = min(8, E - col);
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (L.stage) {
            const T* en = encs + (col - 8 * e0);
#pragma unroll 4
            for (int t = lane; t < Tn; t += 32) {
                float f[8];
                load8(en + t * L.ELD, f);
                const float a = al[t];
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[e] = fmaf(a, f[e], acc[e]);
            }
        } else {
            const T* en = p.enc + rb * E + col;
            for (int t = lane; t < Tn; t += 32) {
                float f[8];
                if (e8) {
                    ldg8(en + (size_t)t * E, f);
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e) f[e] = e < w8 ? to_f(en[(size_t)t * E + e]) : 0.f;
                }
                const float a = al[t];
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[e] = fmaf(a, f[e], acc[e]);
            }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = warp_sum(acc[e]);
        if (lane < w8) p.ctx_out[(size_t)b * E + col + lane] = from_f<T>(pick(acc, lane));
    }
    cluster_wait();
}

// A launch of `kernel` as clusters of `cs` blocks along x that, with
// `pdl`, may start while the previous launch of the stream runs
// (programmatic dependent launch: the kernel waits in pdl_wait). The error
// of a launch the card refuses (a cluster too large, or one that cannot be
// resident) is returned, as any other.
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, int cs, bool pdl,
              cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 2 : 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    return launch_status();
}

// The reverse scan's arguments (ctypes mirror: ops/taco2_train.py
// `_Scan`). Stacks are contiguous [Ts, B, n]: step t of one lies t * B * n
// elements past its base. a_wT / d_wT are W^T in fragment order for bf16,
// rows [n, ld] for float32. Null m_a / m_d: no dropout. attn_probe: 0, or
// the phase the attention backward stops after; serial: launches without
// the programmatic dependence (each starts when the previous ends).
struct BwdScan {
    int use_bf16, Ts, B, Tn, P, E, H1, H2, A, K, loc, softmax, ldq, ld_a, ld_d;
    int cluster_a, cluster_d, cluster_attn, attn_probe, serial;
    const void *a_wT, *d_wT, *q_w, *u, *v_w, *v_b;
    const void *g_a, *g_d, *c_a, *c_d, *d_dech, *d_ctx_out, *d_align_out, *enc, *pinp,
        *maskadd, *m_a, *m_d, *att_prev, *cum_prev;
    void *d_g_a, *d_g_d, *d_ctx, *d_prenet, *d_e;
    void *dh1, *dc1, *dh2, *dc2, *dctx, *datt, *dcum, *d_q, *d_ctx_tot;
    void* stream;
};

// One W^T product launch: bf16 on the tensor cores over a cluster, float32
// on matT_kernel.
template <typename T>
int matT_launch(const BwdScan& s, const void* WT, int ld, int cs, const T* dg, int n_in, int n0,
                int n1, int n2, int mode, float* f0, T* t0, const T* add1, float* carry1,
                float* f1, T* t1, float* f2, cudaStream_t stream) {
    if constexpr (std::is_same<T, bf16>::value) {
        MatMma p;
        p.Wf = (const uint4*)WT;
        p.RT = (n0 + n1 + n2 + 15) / 16;
        p.K16 = (n_in + 15) / 16;
        p.dg = dg;
        p.n_in = n_in; p.n0 = n0; p.n1 = n1; p.n2 = n2; p.B = s.B; p.mode = mode;
        p.ntl = min(kMmaNT, (s.B + 7) / 8);
        p.f0 = f0; p.t0 = t0; p.add1 = add1; p.carry1 = carry1; p.f1 = f1; p.t1 = t1; p.f2 = f2;
        const int bands = (p.RT + kMmaWarps - 1) / kMmaWarps;
        const int slices = (s.B + kMmaNT * 8 - 1) / (kMmaNT * 8);
        return launch_ex(matT_mma_kernel, dim3(bands * cs, 1, slices), dim3(kMmaWarps * 32),
                         mat_mma_smem(p.ntl), cs, !s.serial, stream, p);
    } else {
        const int per_block = kWarps * kMatRows;
        dim3 grid((n0 + n1 + n2 + per_block - 1) / per_block, (s.B + kBT - 1) / kBT);
        return launch_ex(matT_kernel<T>, grid, dim3(32 * kWarps), (size_t)kBT * ld * sizeof(T), 1,
                         !s.serial, stream, (const T*)WT, ld, dg, n_in, n0, n1, n2, s.B, mode, f0,
                         t0, add1, carry1, f1, t1, f2);
    }
}

// The whole reverse scan: for t = Ts - 1 .. 0 the decoder cell backward,
// the decoder W^T products, the attention backward (a cluster a row), the
// attention W^T products, on `stream`. Returns the first launch's error.
template <typename T>
int bwd_scan(const BwdScan& s) {
    const cudaStream_t stream = (cudaStream_t)s.stream;
    const int B = s.B, Tn = s.Tn, P = s.P, E = s.E, H1 = s.H1, H2 = s.H2;
    const AttnLayout L = attn_layout(Tn, s.A, s.K, E, s.ldq, H1, s.cluster_attn, (int)sizeof(T));
    if (int err = set_smem((const void*)attn_bwd_kernel<T>, L.bytes)) return err;
    if constexpr (std::is_same<T, bf16>::value) {
        const size_t smem = mat_mma_smem(min(kMmaNT, (B + 7) / 8));
        if (int err = set_smem((const void*)matT_mma_kernel, smem)) return err;
    } else {
        const int ld = s.ld_a > s.ld_d ? s.ld_a : s.ld_d;
        const size_t smem = (size_t)kBT * ld * sizeof(T);
        if (int err = set_smem((const void*)matT_kernel<T>, smem)) return err;
    }
    const T *g_a = (const T*)s.g_a, *g_d = (const T*)s.g_d, *c_a = (const T*)s.c_a;
    const T *c_d = (const T*)s.c_d, *d_dech = (const T*)s.d_dech;
    const T *d_ctx_out = (const T*)s.d_ctx_out, *m_a = (const T*)s.m_a, *m_d = (const T*)s.m_d;
    const float *d_align_out = (const float*)s.d_align_out, *att_prev = (const float*)s.att_prev;
    const float* cum_prev = (const float*)s.cum_prev;
    T *d_g_a = (T*)s.d_g_a, *d_g_d = (T*)s.d_g_d, *d_ctx = (T*)s.d_ctx, *d_prenet = (T*)s.d_prenet;
    float* d_e = (float*)s.d_e;
    float *dh1 = (float*)s.dh1, *dh2 = (float*)s.dh2, *dctx = (float*)s.dctx;
    float *d_q = (float*)s.d_q, *d_ctx_tot = (float*)s.d_ctx_tot;
    const size_t sB = B, sG1 = sB * 4 * H1, sG2 = sB * 4 * H2, sH1 = sB * H1, sH2 = sB * H2;
    const size_t sE = sB * E, sP = sB * P, sT = sB * Tn;
    AttnBwd<T> at;
    at.q_w = (const T*)s.q_w; at.u = (const T*)s.u; at.pinp = (const T*)s.pinp;
    at.enc = (const T*)s.enc; at.v_w = (const float*)s.v_w; at.v_b = (const float*)s.v_b;
    at.maskadd = (const float*)s.maskadd; at.d_ctx = d_ctx_tot; at.d_q = d_q; at.d_h1 = dh1;
    at.d_att = (float*)s.datt; at.d_cum = (float*)s.dcum; at.d_c1 = (float*)s.dc1;
    at.ldq = s.ldq; at.H1 = H1; at.K = s.K; at.loc = s.loc; at.Tn = Tn; at.A = s.A; at.E = E;
    at.softmax = s.softmax;
    at.probe = s.attn_probe;
    for (int t = s.Ts - 1; t >= 0; --t) {
        const int n_cell = B * H2;
        if (int err = launch_ex(cell_bwd_kernel<T>, dim3((n_cell + 255) / 256), dim3(256), 0, 1,
                                !s.serial, stream, g_d + t * sG2, t ? c_d + (t - 1) * sH2 : nullptr,
                                c_d + t * sH2, (const float*)dh2, d_dech + t * sH2,
                                m_d ? m_d + t * sH2 : nullptr, (float*)s.dc2, d_g_d + t * sG2,
                                B, H2))
            return err;
        if (int err = matT_launch<T>(s, s.d_wT, s.ld_d, s.cluster_d, d_g_d + t * sG2, 4 * H2, H1,
                                     E, H2, 0, d_q, nullptr, d_ctx_out + t * sE, dctx,
                                     d_ctx_tot, d_ctx + t * sE, dh2, stream))
            return err;
        at.g_a = g_a + t * sG1; at.c_a = c_a + t * sH1;
        at.c_a_prev = t ? c_a + (t - 1) * sH1 : nullptr;
        at.m_a = m_a ? m_a + t * sH1 : nullptr;
        at.att_prev = att_prev + t * sT; at.cum_prev = cum_prev + t * sT;
        at.d_align_out = d_align_out + t * sT; at.d_e_out = d_e + t * sT;
        at.d_g_a = d_g_a + t * sG1;
        if (int err = launch_ex(attn_bwd_kernel<T>, dim3(B * s.cluster_attn), dim3(kAttnThreads),
                                L.bytes, s.cluster_attn, !s.serial, stream, at))
            return err;
        if (int err = matT_launch<T>(s, s.a_wT, s.ld_a, s.cluster_a, d_g_a + t * sG1, 4 * H1, P,
                                     E, H1, 1, nullptr, d_prenet + t * sP, nullptr, dctx,
                                     nullptr, nullptr, dh1, stream))
            return err;
    }
    return 0;
}

// The forward scan's arguments (ctypes mirror: ops/taco2_train.py
// `_FwdScan`). Stacks are contiguous [Ts, B, n]. a_w / d_w are the
// interleaved gate rows in fragment order for bf16, rows [4H, ld] for
// float32. h1 / h2 / q: two [B, H] buffers each (step t reads t % 2, writes
// the other; q is written by the attention LSTM of step t into buffer t % 2);
// cum: [B, Tn] float32, zero. Null m_a / m_d: no dropout. attn_probe /
// lstm_probe: 0, or the phase the attention / the bf16 LSTM products stop
// after; serial: launches without the programmatic dependence.
struct FwdScan {
    int use_bf16, Ts, B, Tn, P, E, H1, H2, A, K, loc, softmax, ldq, ld_a, ld_d;
    int cluster_lstm, cluster_attn, attn_probe, lstm_probe, serial;
    const void *a_w, *a_b, *d_w, *d_b, *q_w, *u, *v_w, *v_b;
    const void *prenet, *enc, *pinp, *maskadd, *m_a, *m_d;
    void *dech, *ctx, *align, *g_a, *g_d, *c_a, *c_d;
    void *h1, *h2, *q, *cum;
    void* stream;
};

// The whole forward scan on `stream`: the attention LSTM of step 0, then
// for each step t the attention (a cluster a row) and one launch of the
// decoder LSTM of t beside the attention LSTM of t + 1 (2 Ts + 1
// launches). Returns the first launch's error.
template <typename T>
int fwd_scan(const FwdScan& s) {
    constexpr bool kBf16 = std::is_same<T, bf16>::value;
    const cudaStream_t stream = (cudaStream_t)s.stream;
    const int B = s.B, Tn = s.Tn, P = s.P, E = s.E, H1 = s.H1, H2 = s.H2;
    const int cs = kBf16 ? s.cluster_lstm : 1;
    const int ntl = min(kMmaNT, (B + 7) / 8), slices = (B + kMmaNT * 8 - 1) / (kMmaNT * 8);
    auto blocks = [&](int H) {
        return kBf16 ? ((4 * H + 15) / 16 + kMmaWarps - 1) / kMmaWarps * cs
                     : (H + kWarps - 1) / kWarps;
    };
    auto per = [&](int n) { return ((n + 15) / 16 + cs - 1) / cs; };
    size_t lstm_smem;
    const void* lstm_fn;
    if constexpr (kBf16) {
        lstm_smem = std::max(lstm_mma_smem(ntl, per(P + E + H1)),
                             lstm_mma_smem(ntl, per(H1 + E + H2)));
        lstm_fn = ntl <= 4 ? (const void*)lstm_mma_kernel<4> : (const void*)lstm_mma_kernel<8>;
    } else {
        lstm_smem = (size_t)kBT * std::max(s.ld_a, s.ld_d) * sizeof(float);
        lstm_fn = (const void*)lstm_fwd_kernel;
    }
    if (int err = set_smem(lstm_fn, lstm_smem)) return err;
    const AttnFwdLayout L = attn_fwd_layout(Tn, s.A, s.K, H1, E, s.cluster_attn, (int)sizeof(T));
    if (int err = set_smem((const void*)attn_fwd_kernel<T>, L.bytes)) return err;

    const T *prenet = (const T*)s.prenet, *m_a = (const T*)s.m_a, *m_d = (const T*)s.m_d;
    T *dech = (T*)s.dech, *ctx = (T*)s.ctx, *g_a = (T*)s.g_a, *g_d = (T*)s.g_d;
    T *c_a = (T*)s.c_a, *c_d = (T*)s.c_d, *h1 = (T*)s.h1, *h2 = (T*)s.h2, *q = (T*)s.q;
    float* align = (float*)s.align;
    const size_t sB = B, sH1 = sB * H1, sH2 = sB * H2, sE = sB * E, sT = sB * Tn;
    auto att_job = [&](int t) {
        LstmJob j = {};
        j.W = s.a_w; j.bias = (const float*)s.a_b; j.ld = s.ld_a;
        j.x0 = prenet + t * sB * P; j.n0 = P;
        j.x1 = t ? ctx + (t - 1) * sE : nullptr; j.n1 = E;
        j.h_in = t ? h1 + (t % 2) * sH1 : nullptr; j.H = H1;
        j.c_prev = t ? c_a + (t - 1) * sH1 : nullptr;
        j.mask = m_a ? m_a + t * sH1 : nullptr;
        j.h_out = h1 + ((t + 1) % 2) * sH1; j.c_out = c_a + t * sH1;
        j.gates_out = g_a + t * sB * 4 * H1; j.y_out = q + (t % 2) * sH1;
        j.blocks = blocks(H1);
        return j;
    };
    auto dec_job = [&](int t) {
        LstmJob j = {};
        j.W = s.d_w; j.bias = (const float*)s.d_b; j.ld = s.ld_d;
        j.x0 = q + (t % 2) * sH1; j.n0 = H1;
        j.x1 = ctx + t * sE; j.n1 = E;
        j.h_in = t ? h2 + (t % 2) * sH2 : nullptr; j.H = H2;
        j.c_prev = t ? c_d + (t - 1) * sH2 : nullptr;
        j.mask = m_d ? m_d + t * sH2 : nullptr;
        j.h_out = h2 + ((t + 1) % 2) * sH2; j.c_out = c_d + t * sH2;
        j.gates_out = g_d + t * sB * 4 * H2; j.y_out = dech + t * sH2;
        j.blocks = blocks(H2);
        return j;
    };
    const LstmJob none = {};
    // the first launch is an ordinary one: its reads before the wait (the
    // prenet frame, the weights) were written by the stream's earlier work
    auto lstm = [&](const LstmJob& j0, const LstmJob& j1, bool first = false) {
        LstmFwd p;
        p.job[0] = j0; p.job[1] = j1; p.B = B; p.ntl = ntl; p.probe = s.lstm_probe;
        const int nb = j0.blocks + j1.blocks;
        const bool pdl = !s.serial && !first;
        if constexpr (kBf16)
            return launch_ex(ntl <= 4 ? lstm_mma_kernel<4> : lstm_mma_kernel<8>,
                             dim3(nb, 1, slices), dim3(kMmaWarps * 32), lstm_smem, cs, pdl, stream,
                             p);
        else
            return launch_ex(lstm_fwd_kernel, dim3(nb, (B + kBT - 1) / kBT), dim3(32 * kWarps),
                             lstm_smem, 1, pdl, stream, p);
    };
    AttnFwd<T> at;
    at.q_w = (const T*)s.q_w; at.u = (const T*)s.u; at.pinp = (const T*)s.pinp;
    at.enc = (const T*)s.enc; at.v_w = (const float*)s.v_w; at.v_b = (const float*)s.v_b;
    at.maskadd = (const float*)s.maskadd; at.cum = (float*)s.cum;
    at.ldq = s.ldq; at.H1 = H1; at.K = s.K; at.loc = s.loc; at.Tn = Tn; at.A = s.A; at.E = E;
    at.softmax = s.softmax; at.probe = s.attn_probe;
    auto attn = [&](int t) {
        at.q = q + (t % 2) * sH1;
        at.att_prev = t ? align + (t - 1) * sT : nullptr;
        at.align_out = align + t * sT;
        at.ctx_out = ctx + t * sE;
        return launch_ex(attn_fwd_kernel<T>, dim3(B * s.cluster_attn), dim3(kAttnThreads), L.bytes,
                         s.cluster_attn, !s.serial, stream, at);
    };
    if (int err = lstm(att_job(0), none, true)) return err;
    for (int t = 0; t < s.Ts; ++t) {
        if (int err = attn(t)) return err;
        if (int err = lstm(dec_job(t), t + 1 < s.Ts ? att_job(t + 1) : none)) return err;
    }
    return 0;
}

}  // namespace

// The C interface: `bf16` selects __nv_bfloat16 over float for every
// T-typed pointer; every launch goes on `stream` and returns its
// cudaError_t.
extern "C" {

size_t taco2_train_attn_bwd_smem(int Tn, int A, int K, int E, int ldq, int H1, int cs,
                                 int bf16) {
    return attn_layout(Tn, A, K, E, ldq, H1, cs, bf16 ? 2 : 4).bytes;
}

size_t taco2_train_attn_fwd_smem(int Tn, int A, int K, int H1, int E, int cs, int bf16) {
    return attn_fwd_layout(Tn, A, K, H1, E, cs, bf16 ? 2 : 4).bytes;
}

// The forward scan in one call: 2 Ts + 1 launches. `args`
// is a FwdScan (passed untyped: the struct is local to this source).
int taco2_train_fwd_scan(const void* args) {
    const FwdScan& s = *static_cast<const FwdScan*>(args);
    return s.use_bf16 ? fwd_scan<__nv_bfloat16>(s) : fwd_scan<float>(s);
}

// The reverse scan in one call: Ts x 4 launches. `args` is a BwdScan
// (passed untyped: the struct is local to this source).
int taco2_train_bwd_scan(const void* args) {
    const BwdScan& s = *static_cast<const BwdScan*>(args);
    return s.use_bf16 ? bwd_scan<__nv_bfloat16>(s) : bwd_scan<float>(s);
}

}  // extern "C"
