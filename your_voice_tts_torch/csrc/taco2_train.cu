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
// Forward (simple first version): weights laid out once per optimizer step
// (ops/taco2_train.py) in [out, in] rows so a warp streams one contiguous
// row with 16-byte loads, once per 8-row batch tile; the LSTM's four gate
// rows of a unit interleaved so the cell update fuses into the product's
// epilogue; the attention in one block per batch row. 3 launches a step,
// driven by the host loop in ops/taco2_train.py.
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

// Programmatic dependent launch (sm_90): the backward's kernels let the
// next kernel of the stream start at once (pdl_release) and wait for the
// previous one's results (pdl_wait) only where they first read or write
// what the scan's other launches touch; before that they read only the
// weights and the forward's residuals. Both are no-ops in a launch
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

// ---------------------------------------------------------------- forward

// One LSTM step over inputs [x0 | x1 | h_in] with interleaved gate rows
// (row 4 * j + g): one warp per unit j, the cell update in the epilogue.
// Writes the pre-activations (block layout [B, 4H]), the new cell and h in
// T, and y = h * mask (or h) in T. Null x0 / x1 / h_in / c_prev read as 0.
template <typename T>
__global__ void lstm_fwd_kernel(const T* W, const float* bias, int ld, const T* x0, int n0,
                                const T* x1, int n1, const T* h_in, int H, const T* c_prev,
                                T* h_out, T* c_out, T* gates_out, const T* mask, T* y_out,
                                int B) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* xs = reinterpret_cast<T*>(smem);
    const int b0 = blockIdx.y * kBT;
    stage<T>(xs, ld, b0, B, x0, n0, x1, n1, h_in, H);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = blockIdx.x * kWarps + warp;
    if (j >= H) return;
    float acc[4][kBT] = {};
#pragma unroll
    for (int g = 0; g < 4; ++g) warp_gemv<T, kBT>(W + (size_t)(4 * j + g) * ld, xs, ld, acc[g]);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) acc[g][bb] = warp_sum(acc[g][bb]);
    const int b = b0 + lane;
    if (lane >= kBT || b >= B) return;
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] = pick(acc[g], lane) + bias[4 * j + g];
    const size_t k = (size_t)b * H + j;
    const float cp = c_prev ? to_f(c_prev[k]) : 0.f;
    const float cn = sigmoidf_(pre[1]) * cp + sigmoidf_(pre[0]) * tanhf(pre[2]);
    const float h = sigmoidf_(pre[3]) * tanhf(cn);
#pragma unroll
    for (int g = 0; g < 4; ++g) gates_out[(size_t)b * 4 * H + g * H + j] = from_f<T>(pre[g]);
    c_out[k] = from_f<T>(cn);
    h_out[k] = from_f<T>(h);
    y_out[k] = from_f<T>(mask ? h * to_f(mask[k]) : h);
}

// Location-sensitive attention for one batch row per block: query
// projection of q (already in T), location features of the T-rounded
// [att, cum] from the folded filter u [2, K, A], energies, sigmoid or
// softmax norm, context (rounded to T), cum += alignment.
template <typename T>
__global__ void attn_fwd_kernel(const T* q, const T* q_w, int ldq, int H1, const T* u, int K,
                                int loc, const float* v_w, const float* v_b, const T* pinp,
                                const float* maskadd, const T* enc, const float* att_prev,
                                float* cum, T* ctx_out, float* align_out, int Tn, int A,
                                int E, int softmax) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int TK = Tn + K - 1;
    float* us = reinterpret_cast<float*>(smem);      // [2 * K * A]
    float* pq = us + 2 * K * A;                      // [A]
    float* xa = pq + A;                              // [TK]
    float* xc = xa + TK;                             // [TK]
    float* e = xc + TK;                              // [Tn]
    float* red = e + Tn;                             // [32]
    const int off = (2 * K * A + A + 2 * TK + Tn + 32 + 7) & ~7;
    T* hq = reinterpret_cast<T*>(reinterpret_cast<float*>(smem) + off);   // [ldq]

    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
    const int pad = (K - 1) / 2;
    if (loc)
        for (int i = tid; i < 2 * K * A; i += nt) us[i] = to_f(u[i]);
    for (int i = tid; i < ldq; i += nt) hq[i] = i < H1 ? q[(size_t)b * H1 + i] : from_f<T>(0.f);
    for (int i = tid; i < TK; i += nt) {
        const int t = i - pad;
        float va = 0.f, vc = 0.f;
        if (t >= 0 && t < Tn) {
            va = att_prev ? rnd<T>(att_prev[(size_t)b * Tn + t]) : 0.f;
            vc = rnd<T>(cum[(size_t)b * Tn + t]);
        }
        xa[i] = va;
        xc[i] = vc;
    }
    __syncthreads();
    for (int a = warp; a < A; a += nw) {
        float acc[1] = {0.f};
        warp_gemv<T, 1>(q_w + (size_t)a * ldq, hq, ldq, acc);
        const float s = warp_sum(acc[0]);
        if (lane == 0) pq[a] = s;
    }
    __syncthreads();
    const float vb = v_b[0];
    for (int t = warp; t < Tn; t += nw) {
        float s = 0.f;
        for (int a = lane; a < A; a += 32) {
            float f = 0.f;
            if (loc)
                for (int k = 0; k < K; ++k)
                    f = fmaf(us[k * A + a], xa[t + k], fmaf(us[(K + k) * A + a], xc[t + k], f));
            s += tanhf(pq[a] + f + to_f(pinp[((size_t)b * Tn + t) * A + a])) * v_w[a];
        }
        s = warp_sum(s);
        if (lane == 0) e[t] = s + vb + maskadd[(size_t)b * Tn + t];
    }
    __syncthreads();
    float part = softmax ? -INFINITY : 0.f;
    if (softmax) {
        for (int t = tid; t < Tn; t += nt) part = fmaxf(part, e[t]);
        const float m = block_reduce<true>(part, red);
        part = 0.f;
        for (int t = tid; t < Tn; t += nt) {
            e[t] = expf(e[t] - m);
            part += e[t];
        }
    } else {
        for (int t = tid; t < Tn; t += nt) {
            e[t] = sigmoidf_(e[t]);
            part += e[t];
        }
    }
    const float total = block_reduce<false>(part, red);
    const float inv = 1.f / (softmax ? total : fmaxf(total, 1e-8f));
    for (int t = tid; t < Tn; t += nt) e[t] = e[t] * inv;
    __syncthreads();
    for (int i = tid; i < E; i += nt) {
        float s = 0.f;
        const T* col = enc + (size_t)b * Tn * E + i;
        for (int t = 0; t < Tn; ++t) s = fmaf(e[t], to_f(col[(size_t)t * E]), s);
        ctx_out[(size_t)b * E + i] = from_f<T>(s);
    }
    for (int t = tid; t < Tn; t += nt) {
        const size_t k = (size_t)b * Tn + t;
        align_out[k] = e[t];
        cum[k] += e[t];
    }
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

size_t attn_fwd_smem(int Tn, int A, int K, int ldq, size_t esize) {
    const int TK = Tn + K - 1;
    const int off = (2 * K * A + A + 2 * TK + Tn + 32 + 7) & ~7;
    return (size_t)off * sizeof(float) + (size_t)ldq * esize;
}

template <typename T>
int lstm_fwd(const void* W, const void* bias, int ld, const void* x0, int n0,
             const void* x1, int n1, const void* h_in, int H, const void* c_prev,
             void* h_out, void* c_out, void* gates_out, const void* mask, void* y_out,
             int B, cudaStream_t stream) {
    const size_t smem = (size_t)kBT * ld * sizeof(T);
    if (int err = set_smem((const void*)lstm_fwd_kernel<T>, smem)) return err;
    dim3 grid((H + kWarps - 1) / kWarps, (B + kBT - 1) / kBT);
    lstm_fwd_kernel<T><<<grid, 32 * kWarps, smem, stream>>>(
        (const T*)W, (const float*)bias, ld, (const T*)x0, n0, (const T*)x1, n1,
        (const T*)h_in, H, (const T*)c_prev, (T*)h_out, (T*)c_out, (T*)gates_out,
        (const T*)mask, (T*)y_out, B);
    return launch_status();
}

template <typename T>
int attn_fwd(const void* q, const void* q_w, int ldq, int H1, const void* u, int K, int loc,
             const void* v_w, const void* v_b, const void* pinp, const void* maskadd,
             const void* enc, const void* att_prev, void* cum, void* ctx_out,
             void* align_out, int B, int Tn, int A, int E, int softmax,
             cudaStream_t stream) {
    const size_t smem = attn_fwd_smem(Tn, A, K, ldq, sizeof(T));
    if (int err = set_smem((const void*)attn_fwd_kernel<T>, smem)) return err;
    attn_fwd_kernel<T><<<B, 512, smem, stream>>>(
        (const T*)q, (const T*)q_w, ldq, H1, (const T*)u, K, loc, (const float*)v_w,
        (const float*)v_b, (const T*)pinp, (const float*)maskadd, (const T*)enc,
        (const float*)att_prev, (float*)cum, (T*)ctx_out, (float*)align_out, Tn, A, E,
        softmax);
    return launch_status();
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

}  // namespace

// The C interface: `bf16` selects __nv_bfloat16 over float for every
// T-typed pointer; every launch goes on `stream` and returns its
// cudaError_t.
extern "C" {

size_t taco2_train_attn_bwd_smem(int Tn, int A, int K, int E, int ldq, int H1, int cs,
                                 int bf16) {
    return attn_layout(Tn, A, K, E, ldq, H1, cs, bf16 ? 2 : 4).bytes;
}

int taco2_train_lstm_fwd(int bf16, const void* W, const void* bias, int ld, const void* x0,
                         int n0, const void* x1, int n1, const void* h_in, int H,
                         const void* c_prev, void* h_out, void* c_out, void* gates_out,
                         const void* mask, void* y_out, int B, void* stream) {
    auto fn = bf16 ? &lstm_fwd<__nv_bfloat16> : &lstm_fwd<float>;
    return fn(W, bias, ld, x0, n0, x1, n1, h_in, H, c_prev, h_out, c_out, gates_out, mask,
              y_out, B, (cudaStream_t)stream);
}

int taco2_train_attn_fwd(int bf16, const void* q, const void* q_w, int ldq, int H1, const void* u,
                         int K, int loc, const void* v_w, const void* v_b, const void* pinp,
                         const void* maskadd, const void* enc, const void* att_prev,
                         void* cum, void* ctx_out, void* align_out, int B, int Tn, int A,
                         int E, int softmax, void* stream) {
    auto fn = bf16 ? &attn_fwd<__nv_bfloat16> : &attn_fwd<float>;
    return fn(q, q_w, ldq, H1, u, K, loc, v_w, v_b, pinp, maskadd, enc, att_prev, cum, ctx_out,
              align_out, B, Tn, A, E, softmax, (cudaStream_t)stream);
}

// The reverse scan in one call: Ts x 4 launches. `args` is a BwdScan
// (passed untyped: the struct is local to this source).
int taco2_train_bwd_scan(const void* args) {
    const BwdScan& s = *static_cast<const BwdScan*>(args);
    return s.use_bf16 ? bwd_scan<__nv_bfloat16>(s) : bwd_scan<float>(s);
}

}  // extern "C"
