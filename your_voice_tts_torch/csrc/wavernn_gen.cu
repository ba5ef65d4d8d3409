// WaveRNN generation over a batch of folds, one persistent launch, for
// Hopper (sm_90a).
//
// Replaces: your_voice_tts_tpu/ops/pallas/wavernn_gen.py
//           `wavernn_generate_pallas` (its `_kernel`): the whole sample loop
//           as one Pallas launch with every weight resident in VMEM and
//           in-kernel mu-law / mixture-of-logistics / Gaussian sampling.
//
// What bounds it on the H100: per sample step and fold row, ~4.3M float32
// multiply-adds at full width (input layer, two GRUs on 512 units, three
// FCs, 1024 classes) behind a chain of six dependent stages; the next step
// needs this step's sample. At 22-60 rows the operations bound is ~3-8 us a
// step (float32 at 67 TFLOP/s) and the weights (17.3 MB) fit the 50 MB L2.
// Measured on an H100 SXM at 700 W (PERF.md), a step at 22 rows takes ~36
// us: ~8 us of grid barriers, ~7 of reductions and sampling, ~11 copying
// weights and inputs into shared memory, ~10 of dot products.
//
// What this design does about it (simple first version): ONE cooperative
// launch runs every step (no per-step host launches): the grid is one block
// per SM, all co-resident, and a grid-wide barrier (cooperative_groups
// grid.sync()) separates the six stages of a step: input layer, GRU1, GRU2,
// fc1, fc2, fc3. Each stage spreads its output rows over every warp of the
// grid (row n -> block n % G); a warp owns whole GRU units (the three gate
// rows of the input and the hidden product, laid out next to each other),
// so the cell update needs no exchange. Each stage, a block copies its
// rows' weights (from L2, where all 17.3 MB stay) and the stage inputs (the
// last stage's output and the aux slice of the conditioning stream, per tile
// of batch rows) into shared memory with cp.async, all copies in flight at
// once; then a warp reads a weight row with 16-byte loads across its lanes,
// dots it with 8 staged batch rows and sums across lanes by a
// reduce-scatter (each lane ends with the sums of one batch row).
// Sampling: the mu-law argmax (greedy or Gumbel) is one 64-bit atomicMax per
// logit on (order-preserving float bits, inverted class index), first in
// shared memory, then one per block and row in global memory, so ties go to
// the lowest class as jnp.argmax; after the last barrier every block decodes
// the sample of every row itself (MoL and Gaussian read the few logits), so
// the step needs no seventh barrier. Data that other blocks wrote is read
// with __ldcg or cp.async.cg (L2, never a stale L1 line).
//
// Numerics: float32 throughout, the hash PRNG of hash_prng.cuh with the
// JAX kernel's element indexing (mu-law: row * padded width + class, salt
// 0; MoL: row * M + mixture, salts 1 and 2; Gaussian: row, salts 3 and 4).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "hash_prng.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;                      // batch rows a warp dots at once
constexpr size_t kSmemBudget = 200 * 1024;   // tiles + weight slices, bytes

enum { kMulaw = 0, kMol = 1, kGauss = 2 };

struct Params {
    const float* stream;                              // [L, B, C]
    const float *i_wc, *g1_wx, *g1_wh, *g2_wx, *g2_wh, *fc1_w, *fc2_w, *fc3_w;
    const float *i_w0, *i_b, *g1_bx, *g1_bh, *g2_bx, *g2_bh, *fc1_b, *fc2_b, *fc3_b;
    float *x, *x1, *x2, *h1, *h2, *f1, *f2, *logits;  // scratch; h1, h2 [2, B, R]
    unsigned long long* best;                         // [2, B] packed mu-law argmax
    float* out;                                       // [L, B]
    int B, L, M, A, C, R, F, NC, W, mode, greedy, nmix;
    int KI, KR, K2, KF, KF3;                          // weight row lengths (x4)
    int TB, LDX, WS;                                  // tile rows, x-tile width,
                                                      // weight-slice floats
    float mu, log1p_mu, log_scale_min;
    uint32_t seed;
};

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// 16-byte asynchronous copy global -> shared, cached in L2 only (cp.async:
// no register round trip, so every copy of a stage is in flight at once).
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One butterfly level that halves the values a lane holds: lanes with
// (lane & O) keep the upper half of in[NR][2H], the others the lower half,
// each adding its partner's copy of the half it keeps.
template <int NR, int H, int O>
__device__ __forceinline__ void halve(const float (&in)[NR][2 * H], float (&out)[NR][H],
                                      bool upper) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float keep = upper ? in[r][i + H] : in[r][i];
            const float send = upper ? in[r][i] : in[r][i + H];
            out[r][i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
}

// out[r] = sum_k w[r * K + k] * xs[bb * K + k] for batch row bb = lane / 4
// of the 8 staged rows (the same in the 4 lanes of a row), summed over the
// warp by a reduce-scatter: three halving levels, then two full ones.
// w and xs in shared memory, K a multiple of 4, rows 16-byte aligned.
template <int NR>
__device__ __forceinline__ void warp_dot(const float* w, int K, const float* xs,
                                         float (&out)[NR]) {
    static_assert(kSub == 8, "the reduce-scatter halves 8 rows in three levels");
    const int lane = threadIdx.x & 31;
    float acc[NR][kSub];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int bb = 0; bb < kSub; ++bb) acc[r][bb] = 0.f;
    for (int i = lane * 4; i < K; i += 128) {
        float4 wv[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r)
            wv[r] = *reinterpret_cast<const float4*>(w + r * K + i);
#pragma unroll
        for (int bb = 0; bb < kSub; ++bb) {
            const float4 xv = *reinterpret_cast<const float4*>(xs + bb * K + i);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
                float s = acc[r][bb];
                s = fmaf(wv[r].x, xv.x, s);
                s = fmaf(wv[r].y, xv.y, s);
                s = fmaf(wv[r].z, xv.z, s);
                acc[r][bb] = fmaf(wv[r].w, xv.w, s);
            }
        }
    }
    float a4[NR][4], a2[NR][2], a1[NR][1];
    halve<NR, 4, 16>(acc, a4, lane & 16);
    halve<NR, 2, 8>(a4, a2, lane & 8);
    halve<NR, 1, 4>(a2, a1, lane & 4);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
        float v = a1[r][0];
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        out[r] = v + __shfl_xor_sync(0xffffffffu, v, 1);
    }
}

// Stage rows b0 .. b0 + rows - 1 of [src (n cols, row stride s) | aux (na
// cols of the stream row, stride C)] into dst [rows][K], zero elsewhere;
// 16-byte asynchronous copies when every width and offset is a multiple of
// 4 (the caller waits with cp_async_wait_all).
__device__ void stage(float* dst, int K, int rows, int b0, int B, const float* src, int s,
                      int n, const float* aux, int C, int na, bool vec) {
    if (vec) {
        const int K4 = K / 4, n4 = n / 4, na4 = na / 4;
        for (int q = threadIdx.x; q < rows * K4; q += blockDim.x) {
            const int bb = q / K4, k4 = q - bb * K4, b = b0 + bb;
            if (b < B && k4 < n4)
                cp_async16(dst + 4 * q, src + (size_t)b * s + 4 * k4);
            else if (b < B && k4 < n4 + na4)
                cp_async16(dst + 4 * q, aux + (size_t)b * C + 4 * (k4 - n4));
            else
                reinterpret_cast<float4*>(dst)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        return;
    }
    for (int idx = threadIdx.x; idx < rows * K; idx += blockDim.x) {
        const int bb = idx / K, k = idx - bb * K, b = b0 + bb;
        float v = 0.f;
        if (b < B) {
            if (k < n) v = __ldcg(src + (size_t)b * s + k);
            else if (k < n + na) v = __ldg(aux + (size_t)b * C + k - n);
        }
        dst[idx] = v;
    }
}

// Copy this block's weight rows of a stage into ws: local row j (output row
// n = blockIdx.x + j G) at ws + j (n1 + n2) as [w1 + n n1 (n1 floats) |
// w2 + n n2 (n2 floats)]; n1, n2 multiples of 4.
__device__ void stage_weights(float* ws, int nr, int G, const float* w1, int n1,
                              const float* w2, int n2) {
    const int per4 = (n1 + n2) / 4, n14 = n1 / 4;
    for (int q = threadIdx.x; q < nr * per4; q += blockDim.x) {
        const int j = q / per4, o4 = q - j * per4;
        const size_t n = blockIdx.x + (size_t)j * G;
        cp_async16(ws + 4 * q, o4 < n14 ? w1 + n * n1 + 4 * o4 : w2 + n * n2 + 4 * (o4 - n14));
    }
}

__device__ __forceinline__ unsigned long long pack_argmax(float v, int idx) {
    uint32_t u = __float_as_uint(v + 0.f);   // -0 -> +0: equal values tie
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)idx);
}

enum Stage { kInput, kGru1, kGru2, kFc1, kFc2, kFc3 };

// One stage of step t over every batch tile. Output rows spread over the
// grid (row n -> block n % G); a block copies its rows' weights into shared
// memory once, then its (row, 8-row sub-tile) items spread over its warps.
template <Stage S>
__device__ void run_stage(const Params& p, float* xs, float* hs, float* ws,
                          unsigned long long* sbest, const float* xprev, int t,
                          uint32_t key) {
    const int G = gridDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cur = t & 1, nxt = cur ^ 1;
    const float* c_t = p.stream + (size_t)t * p.B * p.C;
    const int BR = p.B * p.R;
    int N = 0, K = 4;
    const float* src = nullptr;
    int n_src = 0, a_off = 0, n_aux = 0;
    if (S == kInput) { N = p.R; K = p.KI; n_aux = p.M + p.A; }
    if (S == kGru1) { N = p.R; K = p.KR; src = p.x; n_src = p.R; }
    if (S == kGru2) { N = p.R; K = p.K2; src = p.x1; n_src = p.R; a_off = p.M + p.A; n_aux = p.A; }
    if (S == kFc1) { N = p.F; K = p.K2; src = p.x2; n_src = p.R; a_off = p.M + 2 * p.A; n_aux = p.A; }
    if (S == kFc2) { N = p.F; K = p.KF; src = p.f1; n_src = p.F; a_off = p.M + 3 * p.A; n_aux = p.A; }
    if (S == kFc3) { N = p.NC; K = p.KF3; src = p.f2; n_src = p.F; }
    if ((int)blockIdx.x >= N) return;                 // no rows here (block-uniform)
    const bool argmax = S == kFc3 && p.mode == kMulaw;
    const bool vec = (n_src | n_aux | a_off | p.C | p.R) % 4 == 0;
    const int nr = (N - (int)blockIdx.x + G - 1) / G;          // rows of this block
    const bool gru = S == kGru1 || S == kGru2;
    const int per = gru ? 3 * (K + p.KR) : K;                  // weight floats a row
    if (gru)
        stage_weights(ws, nr, G, S == kGru1 ? p.g1_wx : p.g2_wx, 3 * K,
                      S == kGru1 ? p.g1_wh : p.g2_wh, 3 * p.KR);
    else
        stage_weights(ws, nr, G, S == kInput ? p.i_wc : S == kFc1 ? p.fc1_w
                      : S == kFc2 ? p.fc2_w : p.fc3_w, K, nullptr, 0);
    for (int b0 = 0; b0 < p.B; b0 += p.TB) {
        const int nb = min(p.TB, p.B - b0), rows = (nb + kSub - 1) / kSub * kSub;
        const int nsub = rows / kSub;
        stage(xs, K, rows, b0, p.B, src, n_src, n_src, c_t + a_off, p.C, n_aux, vec);
        if (S == kGru1 || S == kGru2)
            stage(hs, p.KR, rows, b0, p.B, (S == kGru1 ? p.h1 : p.h2) + (size_t)cur * BR, p.R,
                  p.R, nullptr, 0, 0, vec);
        if (argmax)
            for (int i = threadIdx.x; i < rows; i += blockDim.x) sbest[i] = 0ull;
        cp_async_wait_all();
        __syncthreads();
        for (int it = warp; it < nr * nsub; it += kWarps) {
            const int j = it / nsub, n = (int)blockIdx.x + j * G, s0 = (it % nsub) * kSub;
            const float* wj = ws + j * per;
            {
                const int tr = s0 + (lane >> 2), b = b0 + tr;   // lane 4 bb owns row bb
                const bool own = (lane & 3) == 0 && tr < nb;
                if (gru) {
                    float ax[3], ah[3];
                    warp_dot<3>(wj, K, xs + s0 * K, ax);
                    warp_dot<3>(wj + 3 * K, p.KR, hs + s0 * p.KR, ah);
                    if (own) {
                        const float* bx = (S == kGru1 ? p.g1_bx : p.g2_bx) + 3 * n;
                        const float* bh = (S == kGru1 ? p.g1_bh : p.g2_bh) + 3 * n;
                        const float gxr = ax[0] + bx[0], gxz = ax[1] + bx[1], gxn = ax[2] + bx[2];
                        const float ghr = ah[0] + bh[0], ghz = ah[1] + bh[1], ghn = ah[2] + bh[2];
                        const float r = sigmoidf_(gxr + ghr), z = sigmoidf_(gxz + ghz);
                        const float nn = tanhf(gxn + r * ghn);
                        const float hn = (1.f - z) * nn + z * hs[tr * p.KR + n];
                        float* h = (S == kGru1 ? p.h1 : p.h2) + (size_t)nxt * BR;
                        h[(size_t)b * p.R + n] = hn;
                        (S == kGru1 ? p.x1 : p.x2)[(size_t)b * p.R + n] = xs[tr * K + n] + hn;
                    }
                } else {
                    float a[1];
                    warp_dot<1>(wj, K, xs + s0 * K, a);
                    const float v = a[0];
                    if (own) {
                        if (S == kInput) {
                            p.x[(size_t)b * p.R + n] = xprev[b] * p.i_w0[n] + v + p.i_b[n];
                        } else if (S == kFc1) {
                            p.f1[(size_t)b * p.F + n] = fmaxf(v + p.fc1_b[n], 0.f);
                        } else if (S == kFc2) {
                            p.f2[(size_t)b * p.F + n] = fmaxf(v + p.fc2_b[n], 0.f);
                        } else if (argmax) {
                            float logit = v + p.fc3_b[n];
                            if (!p.greedy) {
                                const float u = hash_uniform((uint32_t)b * p.W + n, key, 0u);
                                logit += -logf(-logf(u));
                            }
                            atomicMax(&sbest[tr], pack_argmax(logit, n));
                        } else {
                            p.logits[(size_t)b * p.NC + n] = v + p.fc3_b[n];
                        }
                    }
                }
            }
        }
        __syncthreads();
        if (argmax)
            for (int i = threadIdx.x; i < nb; i += blockDim.x)
                if (sbest[i]) atomicMax(&p.best[(size_t)cur * p.B + b0 + i], sbest[i]);
    }
}

// After the last barrier of step t: every block draws the sample of every
// row (next input into xprev); block 0 writes the output and clears the
// other argmax slot for step t + 1.
__device__ void finish_step(const Params& p, float* xprev, int t, uint32_t key) {
    const int cur = t & 1;
    for (int b = threadIdx.x; b < p.B; b += blockDim.x) {
        float xn, smp;
        if (p.mode == kMulaw) {
            const unsigned long long k = __ldcg(&p.best[(size_t)cur * p.B + b]);
            const int cls = (int)(0xFFFFFFFFu - (uint32_t)(k & 0xFFFFFFFFull));
            const float f = 2.f * (float)cls / p.mu - 1.f;
            const float sg = f > 0.f ? 1.f : (f < 0.f ? -1.f : 0.f);
            xn = f;
            smp = fminf(fmaxf(sg * (expf(fabsf(f) * p.log1p_mu) - 1.f) / p.mu, -1.f), 1.f);
        } else if (p.mode == kMol) {
            const float* lg = p.logits + (size_t)b * p.NC;
            const int M = p.nmix;
            int idx = 0;
            float bv = -INFINITY;
            for (int m = 0; m < M; ++m) {
                float v = __ldcg(lg + m);
                if (!p.greedy) v += -logf(-logf(hash_uniform((uint32_t)b * M + m, key, 1u)));
                if (m == 0 || v > bv) { bv = v; idx = m; }
            }
            const float mean = __ldcg(lg + M + idx);
            if (p.greedy) {
                smp = fminf(fmaxf(mean, -1.f), 1.f);
            } else {
                const float ls = fmaxf(__ldcg(lg + 2 * M + idx), p.log_scale_min);
                float u = hash_uniform((uint32_t)b * M + idx, key, 2u);
                u = fminf(fmaxf(u, 1e-5f), 1.f - 1e-5f);
                smp = fminf(fmaxf(mean + expf(ls) * (logf(u) - log1pf(-u)), -1.f), 1.f);
            }
            xn = smp;
        } else {
            const float mean = __ldcg(p.logits + (size_t)b * p.NC);
            if (p.greedy) {
                smp = fminf(fmaxf(mean, -1.f), 1.f);
            } else {
                const float ls = fmaxf(__ldcg(p.logits + (size_t)b * p.NC + 1), p.log_scale_min);
                const float u1 = hash_uniform((uint32_t)b, key, 3u);
                const float u2 = hash_uniform((uint32_t)b, key, 4u);
                const float z = sqrtf(-2.f * logf(u1)) * cosf(6.28318530717958647692f * u2);
                smp = fminf(fmaxf(mean + expf(ls) * z, -1.f), 1.f);
            }
            xn = smp;
        }
        xprev[b] = xn;
        if (blockIdx.x == 0) {
            p.out[(size_t)t * p.B + b] = smp;
            if (p.mode == kMulaw) p.best[(size_t)(cur ^ 1) * p.B + b] = 0ull;
        }
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) wavernn_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::grid_group grid = cg::this_grid();
    float* xs = reinterpret_cast<float*>(smem);
    float* hs = xs + (size_t)p.TB * p.LDX;
    float* ws = hs + (size_t)p.TB * p.KR;
    unsigned long long* sbest = reinterpret_cast<unsigned long long*>(ws + p.WS);
    float* xprev = reinterpret_cast<float*>(sbest + p.TB);
    for (int b = threadIdx.x; b < p.B; b += blockDim.x) xprev[b] = 0.f;
    __syncthreads();
    for (int t = 0; t < p.L; ++t) {
        const uint32_t key = hash_step_key(p.seed, (uint32_t)t);
        run_stage<kInput>(p, xs, hs, ws, sbest, xprev, t, key);
        grid.sync();
        run_stage<kGru1>(p, xs, hs, ws, sbest, xprev, t, key);
        grid.sync();
        run_stage<kGru2>(p, xs, hs, ws, sbest, xprev, t, key);
        grid.sync();
        run_stage<kFc1>(p, xs, hs, ws, sbest, xprev, t, key);
        grid.sync();
        run_stage<kFc2>(p, xs, hs, ws, sbest, xprev, t, key);
        grid.sync();
        run_stage<kFc3>(p, xs, hs, ws, sbest, xprev, t, key);
        grid.sync();
        finish_step(p, xprev, t, key);
    }
}

// Weight-slice size, tile rows and dynamic shared memory for these sizes on
// G blocks; 0 tile rows if even one tile of kSub rows does not fit.
void tile_shape(Params& p, int G, size_t* smem) {
    p.LDX = std::max({p.KI, p.KR, p.K2, p.KF, p.KF3});
    const int ur = (p.R + G - 1) / G, uf = (p.F + G - 1) / G, uc = (p.NC + G - 1) / G;
    p.WS = std::max({ur * p.KI, ur * 6 * p.KR, ur * 3 * (p.K2 + p.KR), uf * p.K2, uf * p.KF,
                     uc * p.KF3});
    const size_t per_row = (size_t)(p.LDX + p.KR) * 4 + 8;
    const size_t fixed = (size_t)p.WS * 4 + (size_t)(p.B + 3) / 4 * 16;
    const int fit = kSmemBudget > fixed ? (int)((kSmemBudget - fixed) / per_row) / kSub * kSub : 0;
    p.TB = std::min(fit, (p.B + kSub - 1) / kSub * kSub);
    *smem = (size_t)p.TB * per_row + fixed;
}

void fill_dims(Params& p, const int* d) {
    p.B = d[0]; p.L = d[1]; p.M = d[2]; p.A = d[3]; p.C = d[4]; p.R = d[5]; p.F = d[6];
    p.NC = d[7]; p.W = d[8]; p.mode = d[9]; p.greedy = d[10]; p.nmix = d[11];
    p.KI = d[12]; p.KR = d[13]; p.K2 = d[14]; p.KF = d[15]; p.KF3 = d[16];
}

// Blocks per SM that fit, after raising the dynamic shared memory limit.
int occupancy(size_t smem, int* blocks_per_sm) {
    cudaError_t e = cudaFuncSetAttribute(wavernn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wavernn_kernel,
                                                              kThreads, smem);
}

int sm_count(int* n) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
    return (int)e;
}

}  // namespace

extern "C" {

// out: blocks, threads, tile rows, shared memory bytes, blocks per SM.
int wavernn_launch_shape(const int* dims, int* out) {
    Params p{};
    fill_dims(p, dims);
    int sms = 0, per_sm = 0, e;
    if ((e = sm_count(&sms)) != 0) return e;
    size_t smem = 0;
    tile_shape(p, sms, &smem);
    if ((e = occupancy(smem, &per_sm)) != 0) return e;
    out[0] = sms;
    out[1] = kThreads;
    out[2] = p.TB;
    out[3] = (int)smem;
    out[4] = per_sm;
    return 0;
}

// ptrs: stream, i_wc, g1_wx, g1_wh, g2_wx, g2_wh, fc1_w, fc2_w, fc3_w, i_w0,
// i_b, g1_bx, g1_bh, g2_bx, g2_bh, fc1_b, fc2_b, fc3_b, x, x1, x2, h1, h2,
// f1, f2, logits, best, out. fl: mu, log1p(mu), LOG_SCALE_MIN. Returns a
// cudaError_t, or -1 when the grid cannot be co-resident.
int wavernn_generate(const void* const* ptrs, const int* dims, const float* fl,
                     unsigned int seed, void* stream) {
    Params p{};
    fill_dims(p, dims);
    const float** cw[] = {&p.stream, &p.i_wc, &p.g1_wx, &p.g1_wh, &p.g2_wx, &p.g2_wh,
                          &p.fc1_w, &p.fc2_w, &p.fc3_w, &p.i_w0, &p.i_b, &p.g1_bx,
                          &p.g1_bh, &p.g2_bx, &p.g2_bh, &p.fc1_b, &p.fc2_b, &p.fc3_b};
    for (int i = 0; i < 18; ++i) *cw[i] = static_cast<const float*>(ptrs[i]);
    float** sc[] = {&p.x, &p.x1, &p.x2, &p.h1, &p.h2, &p.f1, &p.f2, &p.logits};
    for (int i = 0; i < 8; ++i) *sc[i] = static_cast<float*>(const_cast<void*>(ptrs[18 + i]));
    p.best = static_cast<unsigned long long*>(const_cast<void*>(ptrs[26]));
    p.out = static_cast<float*>(const_cast<void*>(ptrs[27]));
    p.mu = fl[0];
    p.log1p_mu = fl[1];
    p.log_scale_min = fl[2];
    p.seed = seed;
    int sms = 0, per_sm = 0, e;
    if ((e = sm_count(&sms)) != 0) return e;
    size_t smem = 0;
    tile_shape(p, sms, &smem);
    if (p.TB < kSub) return -1;
    if ((e = occupancy(smem, &per_sm)) != 0) return e;
    if (per_sm < 1) return -1;
    void* args[] = {&p};
    e = (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(wavernn_kernel), dim3(sms),
                                         dim3(kThreads), args, smem,
                                         static_cast<cudaStream_t>(stream));
    if (e != 0) return e;
    return (int)cudaGetLastError();
}

}  // extern "C"
