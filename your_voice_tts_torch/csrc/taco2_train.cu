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
// per-row attention block of T_in x A work. At B = 32 the tensor cores
// would idle; the weights come from L2 (50 MB) on every step, and the
// serial chain of 3 (forward) or 4 (backward) stages per step cannot
// overlap. The arithmetic bound is far below what the chain costs.
//
// What this design does about it (simple first version): weights are laid
// out once per optimizer step (ops/taco2_train.py) in [out, in] rows so a
// warp streams one contiguous row with 16-byte loads; the forward LSTM's
// four gate rows of a unit are interleaved so the cell update fuses into
// the product's epilogue; the backward products read the transposed
// weights the same way, with the carried cotangents updated in their
// epilogue; the attention recompute, the normalization and energy
// backward, the location backward (a correlation with the [2, K, A] filter
// folded with the location dense, in shared memory: no banded T x T
// matrix) and the attention LSTM's gate backward run in one block per batch
// row. A step is 3 launches forward and 4 backward, driven by the host loop
// in ops/taco2_train.py. Persistent blocks, wgmma for the weight products
// and CUDA graphs come later.
//
// Numerics follow the Pallas kernels: h, c and the context are held in the
// working type T (bf16 or float32) between steps, gate math and sums run in
// float32, gates, cells and gate cotangents are stored in T, alignments,
// energy cotangents and the backward carries in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "taco2_common.cuh"

namespace {

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

// The attention block's backward and the attention LSTM's gate backward,
// one batch row per block. Recomputes the step's energies from the stored
// gates and cell (q = sigmoid(o) tanh(c) * mask) and the previous
// alignments, then: d_align = d_align_out + d_ctx_total . enc + d_att +
// d_cum; normalization backward -> d_e; energy backward -> d_pq -> d_q2 and
// the location backward (a correlation of the T-rounded d_tanh with the
// folded filter) -> d_att (replaced) and d_cum (accumulated); finally
// d_h1 = d_h1_carry + (d_q + d_q2) * mask through the attention LSTM cell.
template <typename T>
__global__ void attn_bwd_kernel(const T* g_a, const T* c_a, const T* c_a_prev, const T* m_a,
                                const T* q_w, int ldq, int H1, const T* u, int K, int loc,
                                const float* v_w, const float* v_b, const T* pinp,
                                const float* maskadd, const T* enc, const float* att_prev,
                                const float* cum_prev, const float* d_align_out,
                                const float* d_ctx, const float* d_q, const float* d_h1,
                                float* d_att, float* d_cum, float* d_c1, float* d_e_out,
                                T* d_g_a, int Tn, int A, int E, int softmax) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int TK = Tn + K - 1;
    const int K2 = 2 * K, S = K2 + 1;                // odd row stride: no bank conflicts
    float* us = reinterpret_cast<float*>(smem);      // [A][S]: u[c, k, a] at a * S + c * K + k
    float* pq = us + S * A;                          // [A]
    float* dpq = pq + A;                             // [A]
    float* xa = dpq + A;                             // [TK]
    float* xc = xa + TK;                             // [TK]
    float* sv = xc + TK;                             // [Tn] s (sigmoid) or alignment
    float* dal = sv + Tn;                            // [Tn] d_align, then d_e
    float* red = dal + Tn;                           // [32]
    float* th = red + 32;                            // [Tn * A] tanh, then d_tanh
    float* G = th + (size_t)Tn * A;                  // [Tn * 2K]
    const int off = (S * A + 2 * A + 2 * TK + 2 * Tn + 32 + Tn * A + Tn * K2 + 7) & ~7;
    T* hq = reinterpret_cast<T*>(reinterpret_cast<float*>(smem) + off);   // [ldq]

    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
    const int pad = (K - 1) / 2;
    const size_t gb = (size_t)b * 4 * H1;
    if (loc)
        for (int i = tid; i < K2 * A; i += nt) {
            const int ck = i / A, a = i - ck * A;
            us[a * S + ck] = to_f(u[i]);
        }
    for (int j = tid; j < ldq; j += nt) {
        float qv = 0.f;
        if (j < H1) {
            qv = sigmoidf_(to_f(g_a[gb + 3 * H1 + j])) * tanhf(to_f(c_a[(size_t)b * H1 + j]));
            if (m_a) qv *= to_f(m_a[(size_t)b * H1 + j]);
        }
        hq[j] = from_f<T>(qv);
    }
    for (int i = tid; i < TK; i += nt) {
        const int t = i - pad;
        float va = 0.f, vc = 0.f;
        if (t >= 0 && t < Tn) {
            va = att_prev ? rnd<T>(att_prev[(size_t)b * Tn + t]) : 0.f;
            vc = cum_prev ? rnd<T>(cum_prev[(size_t)b * Tn + t]) : 0.f;
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
    // energies (tanh kept), and d_align's context term, one warp per step
    const float vb = v_b[0];
    for (int t = warp; t < Tn; t += nw) {
        float s = 0.f;
        for (int a = lane; a < A; a += 32) {
            float f = 0.f;
            if (loc)
                for (int k = 0; k < K; ++k)
                    f = fmaf(us[a * S + k], xa[t + k], fmaf(us[a * S + K + k], xc[t + k], f));
            const float h = tanhf(pq[a] + f + to_f(pinp[((size_t)b * Tn + t) * A + a]));
            th[(size_t)t * A + a] = h;
            s += h * v_w[a];
        }
        s = warp_sum(s);
        float dc = 0.f;
        const T* row = enc + ((size_t)b * Tn + t) * E;
        for (int i = lane; i < E; i += 32) dc = fmaf(d_ctx[(size_t)b * E + i], to_f(row[i]), dc);
        dc = warp_sum(dc);
        if (lane == 0) {
            const size_t k = (size_t)b * Tn + t;
            sv[t] = s + vb + maskadd[k];
            dal[t] = d_align_out[k] + dc + d_att[k] + d_cum[k];
        }
    }
    __syncthreads();
    // normalization forward (recomputed) and backward -> d_e
    float part = softmax ? -INFINITY : 0.f;
    if (softmax) {
        for (int t = tid; t < Tn; t += nt) part = fmaxf(part, sv[t]);
        const float m = block_reduce<true>(part, red);
        part = 0.f;
        for (int t = tid; t < Tn; t += nt) {
            sv[t] = expf(sv[t] - m);
            part += sv[t];
        }
        const float total = block_reduce<false>(part, red);
        for (int t = tid; t < Tn; t += nt) sv[t] = sv[t] / total;
        __syncthreads();
        part = 0.f;
        for (int t = tid; t < Tn; t += nt) part += dal[t] * sv[t];
        const float inner = block_reduce<false>(part, red);
        for (int t = tid; t < Tn; t += nt) dal[t] = sv[t] * (dal[t] - inner);
    } else {
        for (int t = tid; t < Tn; t += nt) {
            sv[t] = sigmoidf_(sv[t]);
            part += sv[t];
        }
        const float S = fmaxf(block_reduce<false>(part, red), 1e-8f);
        part = 0.f;
        for (int t = tid; t < Tn; t += nt) part += dal[t] * sv[t];
        const float inner = block_reduce<false>(part, red) / S;
        for (int t = tid; t < Tn; t += nt) {
            const float ds = (dal[t] - inner) / S;
            dal[t] = ds * sv[t] * (1.f - sv[t]);
        }
    }
    __syncthreads();
    for (int t = tid; t < Tn; t += nt) d_e_out[(size_t)b * Tn + t] = dal[t];
    // energy backward: d_tanh in place of tanh
    for (int i = tid; i < Tn * A; i += nt) {
        const int t = i / A, a = i - t * A;
        const float h = th[i];
        th[i] = dal[t] * v_w[a] * (1.f - h * h);
    }
    __syncthreads();
    for (int a = tid; a < A; a += nt) {
        float s = 0.f;
        for (int t = 0; t < Tn; ++t) s += th[(size_t)t * A + a];
        dpq[a] = rnd<T>(s);
    }
    if (loc) {
        // G[t, c, k] = sum_a rnd(d_tanh[t, a]) u[c, k, a]
        for (int i = tid; i < Tn * K2; i += nt) {
            const int t = i / K2, ck = i - t * K2;
            const float* tr = th + (size_t)t * A;
            float s = 0.f;
            for (int a = 0; a < A; ++a) s = fmaf(rnd<T>(tr[a]), us[a * S + ck], s);
            G[i] = s;
        }
    }
    __syncthreads();
    // location backward: d_prev[c, t'] = sum_k G[t' - k + pad, c, k]
    for (int i = tid; i < 2 * Tn; i += nt) {
        const int c = i / Tn, tp = i - c * Tn;
        float s = 0.f;
        if (loc)
            for (int k = 0; k < K; ++k) {
                const int t = tp - k + pad;
                if (t >= 0 && t < Tn) s += G[(size_t)t * K2 + c * K + k];
            }
        const size_t kk = (size_t)b * Tn + tp;
        if (c == 0) d_att[kk] = s;
        else d_cum[kk] += s;
    }
    // d_q2 = rnd(d_pq) q_w, then the attention LSTM cell backward
    for (int j = tid; j < H1; j += nt) {
        float s = 0.f;
#pragma unroll 8
        for (int a = 0; a < A; ++a) s = fmaf(dpq[a], to_f(q_w[(size_t)a * ldq + j]), s);
        const size_t k = (size_t)b * H1 + j;
        float dq = d_q[k] + s;
        if (m_a) dq *= to_f(m_a[k]);
        float pre[4], dg[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] = to_f(g_a[gb + g * H1 + j]);
        d_c1[k] = lstm_cell_bwd(pre, c_a_prev ? to_f(c_a_prev[k]) : 0.f, to_f(c_a[k]),
                                d_h1[k] + dq, d_c1[k], dg);
#pragma unroll
        for (int g = 0; g < 4; ++g) d_g_a[gb + g * H1 + j] = from_f<T>(dg[g]);
    }
}

size_t attn_fwd_smem(int Tn, int A, int K, int ldq, size_t esize) {
    const int TK = Tn + K - 1;
    const int off = (2 * K * A + A + 2 * TK + Tn + 32 + 7) & ~7;
    return (size_t)off * sizeof(float) + (size_t)ldq * esize;
}

size_t attn_bwd_smem(int Tn, int A, int K, int ldq, size_t esize) {
    const int TK = Tn + K - 1;
    const int off = ((2 * K + 1) * A + 2 * A + 2 * TK + 2 * Tn + 32 + Tn * A + Tn * 2 * K + 7) & ~7;
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

template <typename T>
int cell_bwd(const void* gates, const void* c_prev, const void* c, const void* d_h,
             const void* d_y, const void* mask, void* d_c, void* d_gates, int B, int H,
             cudaStream_t stream) {
    const int n = B * H;
    cell_bwd_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
        (const T*)gates, (const T*)c_prev, (const T*)c, (const float*)d_h, (const T*)d_y,
        (const T*)mask, (float*)d_c, (T*)d_gates, B, H);
    return launch_status();
}

template <typename T>
int matT(const void* WT, int ld, const void* dg, int n_in, int n0, int n1, int n2, int B,
         int mode, void* f0, void* t0, const void* add1, void* carry1, void* f1, void* t1,
         void* f2, cudaStream_t stream) {
    const size_t smem = (size_t)kBT * ld * sizeof(T);
    if (int err = set_smem((const void*)matT_kernel<T>, smem)) return err;
    const int per_block = kWarps * kMatRows;
    dim3 grid((n0 + n1 + n2 + per_block - 1) / per_block, (B + kBT - 1) / kBT);
    matT_kernel<T><<<grid, 32 * kWarps, smem, stream>>>(
        (const T*)WT, ld, (const T*)dg, n_in, n0, n1, n2, B, mode, (float*)f0, (T*)t0,
        (const T*)add1, (float*)carry1, (float*)f1, (T*)t1, (float*)f2);
    return launch_status();
}

template <typename T>
int attn_bwd(const void* g_a, const void* c_a, const void* c_a_prev, const void* m_a,
             const void* q_w, int ldq, int H1, const void* u, int K, int loc,
             const void* v_w, const void* v_b, const void* pinp, const void* maskadd,
             const void* enc, const void* att_prev, const void* cum_prev,
             const void* d_align_out, const void* d_ctx, const void* d_q, const void* d_h1,
             void* d_att, void* d_cum, void* d_c1, void* d_e_out, void* d_g_a, int B,
             int Tn, int A, int E, int softmax, cudaStream_t stream) {
    const size_t smem = attn_bwd_smem(Tn, A, K, ldq, sizeof(T));
    if (int err = set_smem((const void*)attn_bwd_kernel<T>, smem)) return err;
    attn_bwd_kernel<T><<<B, 512, smem, stream>>>(
        (const T*)g_a, (const T*)c_a, (const T*)c_a_prev, (const T*)m_a, (const T*)q_w, ldq,
        H1, (const T*)u, K, loc, (const float*)v_w, (const float*)v_b, (const T*)pinp,
        (const float*)maskadd, (const T*)enc, (const float*)att_prev,
        (const float*)cum_prev, (const float*)d_align_out, (const float*)d_ctx,
        (const float*)d_q, (const float*)d_h1, (float*)d_att, (float*)d_cum, (float*)d_c1,
        (float*)d_e_out, (T*)d_g_a, Tn, A, E, softmax);
    return launch_status();
}

}  // namespace

// The C interface: `bf16` selects __nv_bfloat16 over float for every
// T-typed pointer; every launch goes on `stream` and returns its
// cudaError_t.
extern "C" {

size_t taco2_train_attn_bwd_smem(int Tn, int A, int K, int ldq, int bf16) {
    return attn_bwd_smem(Tn, A, K, ldq, bf16 ? 2 : 4);
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

int taco2_train_cell_bwd(int bf16, const void* gates, const void* c_prev, const void* c,
                         const void* d_h, const void* d_y, const void* mask, void* d_c,
                         void* d_gates, int B, int H, void* stream) {
    auto fn = bf16 ? &cell_bwd<__nv_bfloat16> : &cell_bwd<float>;
    return fn(gates, c_prev, c, d_h, d_y, mask, d_c, d_gates, B, H, (cudaStream_t)stream);
}

int taco2_train_matT(int bf16, const void* WT, int ld, const void* dg, int n_in, int n0,
                     int n1, int n2, int B, int mode, void* f0, void* t0, const void* add1,
                     void* carry1, void* f1, void* t1, void* f2, void* stream) {
    auto fn = bf16 ? &matT<__nv_bfloat16> : &matT<float>;
    return fn(WT, ld, dg, n_in, n0, n1, n2, B, mode, f0, t0, add1, carry1, f1, t1, f2,
              (cudaStream_t)stream);
}

int taco2_train_attn_bwd(int bf16, const void* g_a, const void* c_a, const void* c_a_prev,
                         const void* m_a, const void* q_w, int ldq, int H1, const void* u,
                         int K, int loc, const void* v_w, const void* v_b, const void* pinp,
                         const void* maskadd, const void* enc, const void* att_prev,
                         const void* cum_prev, const void* d_align_out, const void* d_ctx,
                         const void* d_q, const void* d_h1, void* d_att, void* d_cum,
                         void* d_c1, void* d_e_out, void* d_g_a, int B, int Tn, int A,
                         int E, int softmax, void* stream) {
    auto fn = bf16 ? &attn_bwd<__nv_bfloat16> : &attn_bwd<float>;
    return fn(g_a, c_a, c_a_prev, m_a, q_w, ldq, H1, u, K, loc, v_w, v_b, pinp, maskadd,
              enc, att_prev, cum_prev, d_align_out, d_ctx, d_q, d_h1, d_att, d_cum, d_c1,
              d_e_out, d_g_a, B, Tn, A, E, softmax, (cudaStream_t)stream);
}

}  // extern "C"
