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
// FCs, 1024 classes) behind a chain of dependent stages; the next step
// needs this step's sample. At 22-60 rows the operations bound is ~3-8 us a
// step (float32 at 67 TFLOP/s) and the weights (17.3 MB) fit the 50 MB L2.
// The step is latency-bound: grid barriers, the trip of each stage's
// inputs from L2 into every SM, and dot products on a few rows (PERF.md has
// the measured parts).
//
// What this design does about it: ONE cooperative launch runs every step
// (no per-step host launches): the grid is one block per SM, all
// co-resident, and a grid-wide barrier (cooperative_groups grid.sync())
// separates the five stages of a step: GRU1, GRU2, fc1, fc2, fc3. Each stage
// spreads its output rows over every warp of the grid (row n -> block
// n % G); a warp owns whole GRU units (the three gate rows of the input and
// the hidden product, laid out next to each other), so the cell update needs
// no exchange. Each stage, a block copies its rows' weights (from L2, where
// all 17.3 MB stay) and the stage inputs (the last stage's output and the
// aux slice of the conditioning stream, per tile of batch rows) into shared
// memory with cp.async, all copies in flight at once; then a warp reads a
// weight row with 16-byte loads across its lanes, dots it with 8 staged
// batch rows and sums across lanes by a reduce-scatter (each lane ends with
// the sums of one batch row). The epilogue's biases are loaded before the
// dot products: every grid barrier empties L1, so a load after the sums
// would wait a trip to L2 on the chain.
//
// The input layer x = x_prev * i_w0 + i_wc . [mel | a1] + i_b has no stage
// of its own: only x_prev * i_w0 depends on the last sample, so the
// conditioning product `pre` of step t + 1 is computed during step t's fc1
// stage (its rows are items of their own, on the warps fc1 leaves idle
// first), and the GRU1 stage forms x in shared memory from pre, x_prev and
// i_w0 / i_b, which every block keeps for the launch. A prologue computes
// step 0's pre.
//
// Sampling: the mu-law argmax (greedy or Gumbel) is one 64-bit atomicMax per
// logit on (order-preserving float bits, inverted class index), first in
// shared memory, then one per block and row in global memory, so ties go to
// the lowest class as jnp.argmax; after the last barrier every block decodes
// the sample of every row itself (MoL and Gaussian read the few logits), so
// the step needs no sixth barrier. Data that other blocks wrote is read
// with __ldcg or cp.async.cg (L2, never a stale L1 line).
//
// Probe launches (`wavernn_probe`): the same kernel instantiated with parts
// of every step left out (dot products, staging copies, sampling; or every
// part but the barriers, the latency floor), for the per-part breakdown. The
// serving instantiation has none of these branches.
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

// Probe bits: the parts of every step a probe launch leaves out.
enum { kServe = 0, kNoDots = 1, kNoStaging = 2, kNoSampling = 4, kBarriersOnly = 8 };

struct Params {
    const float* stream;                              // [L, B, C]
    const float *i_wc, *g1_wx, *g1_wh, *g2_wx, *g2_wh, *fc1_w, *fc2_w, *fc3_w;
    const float *i_w0, *i_b, *g1_bx, *g1_bh, *g2_bx, *g2_bh, *fc1_b, *fc2_b, *fc3_b;
    float *pre, *x1, *x2, *h1, *h2, *f1, *f2, *logits;  // scratch; pre, h1, h2 [2, B, R]
    unsigned long long* best;                         // [2, B] packed mu-law argmax
    float* out;                                       // [L, B]
    int B, L, M, A, C, R, F, NC, W, mode, greedy, nmix;
    int KI, KR, K2, KF, KF3;                          // weight row lengths (x4)
    int TB, LDX, HSW, WS, UI;                         // tile rows, x- and h-tile
                                                      // widths, weight-slice floats,
                                                      // input rows a block
    float mu, log1p_mu, log_scale_min;
    uint32_t seed;
};

// Shared memory of a block: the [x | h] tile, the streamed weight slice, the
// input layer's rows and vectors kept for the launch, the argmax words and
// x_prev.
struct Smem {
    float *xs, *hs, *ws, *wi, *iw0, *ib;
    unsigned long long* sbest;
    float* xprev;
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
// A probe without dot products returns zeros.
template <int NR, int P>
__device__ __forceinline__ void warp_dot(const float* w, int K, const float* xs,
                                         float (&out)[NR]) {
    static_assert(kSub == 8, "the reduce-scatter halves 8 rows in three levels");
    if (P & kNoDots) {
#pragma unroll
        for (int r = 0; r < NR; ++r) out[r] = 0.f;
        return;
    }
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

// kPre: only the conditioning product of the input layer (the prologue's
// step 0); kFc1 also computes it, for step t + 1.
enum Stage { kPre, kGru1, kGru2, kFc1, kFc2, kFc3 };

// One stage of step t over every batch tile. Output rows spread over the
// grid (row n -> block n % G); a block copies its rows' weights into shared
// memory once, then its (row, 8-row sub-tile) items spread over its warps.
template <Stage S, int P>
__device__ void run_stage(const Params& p, const Smem& s, int t, uint32_t key) {
    constexpr bool copies = !(P & kNoStaging), sampling = !(P & kNoSampling);
    const int G = gridDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cur = t & 1, nxt = cur ^ 1;
    const int BR = p.B * p.R;
    // the conditioning product for step tp into pre[tp & 1], over the
    // input layer's rows of this block (kept in s.wi)
    const bool pre = S == kPre || (S == kFc1 && t + 1 < p.L);
    const int tp = S == kPre ? t : t + 1;
    const int npr = pre && (int)blockIdx.x < p.R ? (p.R - (int)blockIdx.x + G - 1) / G : 0;
    int N = 0, K = 4;
    const float* src = nullptr;
    int n_src = 0, a_off = 0, n_aux = 0;
    if (S == kGru1) { N = p.R; K = p.KR; src = p.pre + (size_t)cur * BR; n_src = p.R; }
    if (S == kGru2) { N = p.R; K = p.K2; src = p.x1; n_src = p.R; a_off = p.M + p.A; n_aux = p.A; }
    if (S == kFc1) { N = p.F; K = p.K2; src = p.x2; n_src = p.R; a_off = p.M + 2 * p.A; n_aux = p.A; }
    if (S == kFc2) { N = p.F; K = p.KF; src = p.f1; n_src = p.F; a_off = p.M + 3 * p.A; n_aux = p.A; }
    if (S == kFc3) { N = p.NC; K = p.KF3; src = p.f2; n_src = p.F; }
    const int nr = (int)blockIdx.x < N ? (N - (int)blockIdx.x + G - 1) / G : 0;
    if (nr == 0 && npr == 0) return;                  // no rows here (block-uniform)
    const float* c_t = p.stream + (size_t)t * p.B * p.C;
    const float* c_p = p.stream + (size_t)tp * p.B * p.C;
    const bool argmax = S == kFc3 && p.mode == kMulaw;
    const bool vec = (n_src | n_aux | a_off | p.C | p.R | (pre ? p.M + p.A : 0)) % 4 == 0;
    const bool gru = S == kGru1 || S == kGru2;
    const int per = gru ? 3 * (K + p.KR) : K;                  // weight floats a row
    if (copies && nr > 0) {
        if (gru)
            stage_weights(s.ws, nr, G, S == kGru1 ? p.g1_wx : p.g2_wx, 3 * K,
                          S == kGru1 ? p.g1_wh : p.g2_wh, 3 * p.KR);
        else
            stage_weights(s.ws, nr, G, S == kFc1 ? p.fc1_w : S == kFc2 ? p.fc2_w : p.fc3_w, K,
                          nullptr, 0);
    }
    for (int b0 = 0; b0 < p.B; b0 += p.TB) {
        const int nb = min(p.TB, p.B - b0), rows = (nb + kSub - 1) / kSub * kSub;
        const int nsub = rows / kSub;
        if (copies) {
            if (nr > 0)
                stage(s.xs, K, rows, b0, p.B, src, n_src, n_src, c_t + a_off, p.C, n_aux, vec);
            if (gru)
                stage(s.hs, p.KR, rows, b0, p.B, (S == kGru1 ? p.h1 : p.h2) + (size_t)cur * BR,
                      p.R, p.R, nullptr, 0, 0, vec);
            if (pre)    // [mel | a1] of step tp, in the h tile (free outside the GRUs)
                stage(s.hs, p.KI, rows, b0, p.B, nullptr, 0, 0, c_p, p.C, p.M + p.A, vec);
        }
        if (argmax)
            for (int i = threadIdx.x; i < rows; i += blockDim.x) s.sbest[i] = 0ull;
        if (copies) cp_async_wait_all();
        __syncthreads();
        if (S == kGru1) {    // x = x_prev * i_w0 + pre + i_b in place, a column a thread
            for (int k = threadIdx.x; k < p.R; k += blockDim.x) {
                const float w0 = s.iw0[k], bk = s.ib[k];
                for (int bb = 0; bb < nb; ++bb) {
                    float* xv = s.xs + bb * K + k;
                    *xv = s.xprev[b0 + bb] * w0 + *xv + bk;
                }
            }
            __syncthreads();
        }
        for (int it = warp; it < nr * nsub; it += kWarps) {
            const int j = it / nsub, n = (int)blockIdx.x + j * G, s0 = (it % nsub) * kSub;
            const float* wj = s.ws + j * per;
            const int tr = s0 + (lane >> 2), b = b0 + tr;   // lane 4 bb owns row bb
            const bool own = (lane & 3) == 0 && tr < nb;
            if (gru) {
                // biases first: their trip to L2 overlaps the dot products
                const float* bxp = (S == kGru1 ? p.g1_bx : p.g2_bx) + 3 * n;
                const float* bhp = (S == kGru1 ? p.g1_bh : p.g2_bh) + 3 * n;
                float bx[3], bh[3];
#pragma unroll
                for (int g = 0; g < 3; ++g) { bx[g] = bxp[g]; bh[g] = bhp[g]; }
                float ax[3], ah[3];
                warp_dot<3, P>(wj, K, s.xs + s0 * K, ax);
                warp_dot<3, P>(wj + 3 * K, p.KR, s.hs + s0 * p.KR, ah);
                if (own) {
                    const float gxr = ax[0] + bx[0], gxz = ax[1] + bx[1], gxn = ax[2] + bx[2];
                    const float ghr = ah[0] + bh[0], ghz = ah[1] + bh[1], ghn = ah[2] + bh[2];
                    const float r = sigmoidf_(gxr + ghr), z = sigmoidf_(gxz + ghz);
                    const float nn = tanhf(gxn + r * ghn);
                    const float hn = (1.f - z) * nn + z * s.hs[tr * p.KR + n];
                    float* h = (S == kGru1 ? p.h1 : p.h2) + (size_t)nxt * BR;
                    h[(size_t)b * p.R + n] = hn;
                    (S == kGru1 ? p.x1 : p.x2)[(size_t)b * p.R + n] = s.xs[tr * K + n] + hn;
                }
            } else {
                const float bias = S == kFc1 ? p.fc1_b[n] : S == kFc2 ? p.fc2_b[n] : p.fc3_b[n];
                float a[1];
                warp_dot<1, P>(wj, K, s.xs + s0 * K, a);
                const float v = a[0];
                if (own) {
                    if (S == kFc1) {
                        p.f1[(size_t)b * p.F + n] = fmaxf(v + bias, 0.f);
                    } else if (S == kFc2) {
                        p.f2[(size_t)b * p.F + n] = fmaxf(v + bias, 0.f);
                    } else if (argmax) {
                        if (sampling) {
                            float logit = v + bias;
                            if (!p.greedy) {
                                const float u = hash_uniform((uint32_t)b * p.W + n, key, 0u);
                                logit += -logf(-logf(u));
                            }
                            atomicMax(&s.sbest[tr], pack_argmax(logit, n));
                        }
                    } else {
                        p.logits[(size_t)b * p.NC + n] = v + bias;
                    }
                }
            }
        }
        // the conditioning items, from the last warp down: the warps the
        // stage's own items leave idle take them first
        for (int it = kWarps - 1 - warp; it < npr * nsub; it += kWarps) {
            const int j = it / nsub, n = (int)blockIdx.x + j * G, s0 = (it % nsub) * kSub;
            const int tr = s0 + (lane >> 2), b = b0 + tr;
            float a[1];
            warp_dot<1, P>(s.wi + j * p.KI, p.KI, s.hs + s0 * p.KI, a);
            if ((lane & 3) == 0 && tr < nb)
                p.pre[(size_t)(tp & 1) * BR + (size_t)b * p.R + n] = a[0];
        }
        __syncthreads();
        if (argmax && sampling)
            for (int i = threadIdx.x; i < nb; i += blockDim.x)
                if (s.sbest[i]) atomicMax(&p.best[(size_t)cur * p.B + b0 + i], s.sbest[i]);
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

template <int P>
__global__ void __launch_bounds__(kThreads, 1) wavernn_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::grid_group grid = cg::this_grid();
    Smem s;
    s.xs = reinterpret_cast<float*>(smem);
    s.hs = s.xs + (size_t)p.TB * p.LDX;
    s.ws = s.hs + (size_t)p.TB * p.HSW;
    s.wi = s.ws + p.WS;
    s.iw0 = s.wi + (size_t)p.UI * p.KI;
    s.ib = s.iw0 + (p.R + 3) / 4 * 4;
    s.sbest = reinterpret_cast<unsigned long long*>(s.ib + (p.R + 3) / 4 * 4);
    s.xprev = reinterpret_cast<float*>(s.sbest + p.TB);
    // kept for the launch: this block's input-layer rows, i_w0 and i_b
    for (int q = threadIdx.x; q < p.UI * p.KI; q += blockDim.x) {
        const int j = q / p.KI, n = (int)blockIdx.x + j * (int)gridDim.x;
        s.wi[q] = n < p.R ? p.i_wc[(size_t)n * p.KI + q - j * p.KI] : 0.f;
    }
    for (int k = threadIdx.x; k < p.R; k += blockDim.x) {
        s.iw0[k] = p.i_w0[k];
        s.ib[k] = p.i_b[k];
    }
    for (int b = threadIdx.x; b < p.B; b += blockDim.x) s.xprev[b] = 0.f;
    __syncthreads();
    if (!(P & kBarriersOnly)) run_stage<kPre, P>(p, s, 0, 0u);
    grid.sync();
    for (int t = 0; t < p.L; ++t) {
        if (P & kBarriersOnly) {
            for (int i = 0; i < 5; ++i) grid.sync();
            continue;
        }
        const uint32_t key = hash_step_key(p.seed, (uint32_t)t);
        run_stage<kGru1, P>(p, s, t, key);
        grid.sync();
        run_stage<kGru2, P>(p, s, t, key);
        grid.sync();
        run_stage<kFc1, P>(p, s, t, key);
        grid.sync();
        run_stage<kFc2, P>(p, s, t, key);
        grid.sync();
        run_stage<kFc3, P>(p, s, t, key);
        grid.sync();
        if (!(P & kNoSampling)) finish_step(p, s.xprev, t, key);
    }
}

// Weight-slice size, tile rows and dynamic shared memory for these sizes on
// G blocks; 0 tile rows if even one tile of kSub rows does not fit.
void tile_shape(Params& p, int G, size_t* smem) {
    p.LDX = std::max({p.KR, p.K2, p.KF, p.KF3});
    const int ur = (p.R + G - 1) / G, uf = (p.F + G - 1) / G, uc = (p.NC + G - 1) / G;
    p.HSW = std::max(p.KR, p.KI);
    p.UI = ur;
    p.WS = std::max({ur * 6 * p.KR, ur * 3 * (p.K2 + p.KR), uf * p.K2, uf * p.KF, uc * p.KF3});
    const size_t per_row = (size_t)(p.LDX + p.HSW) * 4 + 8;
    const size_t fixed = ((size_t)p.WS + (size_t)p.UI * p.KI + 2 * ((p.R + 3) / 4 * 4)) * 4
                         + (size_t)(p.B + 3) / 4 * 16;
    const int fit = kSmemBudget > fixed ? (int)((kSmemBudget - fixed) / per_row) / kSub * kSub : 0;
    p.TB = std::min(fit, (p.B + kSub - 1) / kSub * kSub);
    *smem = (size_t)p.TB * per_row + fixed;
}

void fill_dims(Params& p, const int* d) {
    p.B = d[0]; p.L = d[1]; p.M = d[2]; p.A = d[3]; p.C = d[4]; p.R = d[5]; p.F = d[6];
    p.NC = d[7]; p.W = d[8]; p.mode = d[9]; p.greedy = d[10]; p.nmix = d[11];
    p.KI = d[12]; p.KR = d[13]; p.K2 = d[14]; p.KF = d[15]; p.KF3 = d[16];
}

template <int P>
const void* kernel_of() { return reinterpret_cast<const void*>(wavernn_kernel<P>); }

const void* kernel_for(int probe) {
    switch (probe) {
        case kNoDots: return kernel_of<kNoDots>();
        case kNoStaging: return kernel_of<kNoStaging>();
        case kNoSampling: return kernel_of<kNoSampling>();
        case kBarriersOnly: return kernel_of<kBarriersOnly>();
        default: return kernel_of<kServe>();
    }
}

// Blocks per SM that fit, after raising the dynamic shared memory limit.
int occupancy(const void* kernel, size_t smem, int* blocks_per_sm) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                              smem);
}

int sm_count(int* n) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
    return (int)e;
}

int launch(const void* const* ptrs, const int* dims, const float* fl, unsigned int seed,
           void* stream, int probe) {
    if (probe != kServe && probe != kNoDots && probe != kNoStaging && probe != kNoSampling
        && probe != kBarriersOnly)
        return (int)cudaErrorInvalidValue;
    Params p{};
    fill_dims(p, dims);
    const float** cw[] = {&p.stream, &p.i_wc, &p.g1_wx, &p.g1_wh, &p.g2_wx, &p.g2_wh,
                          &p.fc1_w, &p.fc2_w, &p.fc3_w, &p.i_w0, &p.i_b, &p.g1_bx,
                          &p.g1_bh, &p.g2_bx, &p.g2_bh, &p.fc1_b, &p.fc2_b, &p.fc3_b};
    for (int i = 0; i < 18; ++i) *cw[i] = static_cast<const float*>(ptrs[i]);
    float** sc[] = {&p.pre, &p.x1, &p.x2, &p.h1, &p.h2, &p.f1, &p.f2, &p.logits};
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
    const void* kernel = kernel_for(probe);
    if ((e = occupancy(kernel, smem, &per_sm)) != 0) return e;
    if (per_sm < 1) return -1;
    void* args[] = {&p};
    e = (int)cudaLaunchCooperativeKernel(kernel, dim3(sms), dim3(kThreads), args, smem,
                                         static_cast<cudaStream_t>(stream));
    if (e != 0) return e;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out: blocks, threads, tile rows, shared memory bytes, blocks per SM,
// weight-slice bytes (the largest stage's rows of a block, copied from L2
// every stage), barriers a step.
int wavernn_launch_shape(const int* dims, int* out) {
    Params p{};
    fill_dims(p, dims);
    int sms = 0, per_sm = 0, e;
    if ((e = sm_count(&sms)) != 0) return e;
    size_t smem = 0;
    tile_shape(p, sms, &smem);
    if ((e = occupancy(kernel_for(kServe), smem, &per_sm)) != 0) return e;
    out[0] = sms;
    out[1] = kThreads;
    out[2] = p.TB;
    out[3] = (int)smem;
    out[4] = per_sm;
    out[5] = p.WS * 4;
    out[6] = 5;
    return 0;
}

// ptrs: stream, i_wc, g1_wx, g1_wh, g2_wx, g2_wh, fc1_w, fc2_w, fc3_w, i_w0,
// i_b, g1_bx, g1_bh, g2_bx, g2_bh, fc1_b, fc2_b, fc3_b, pre, x1, x2, h1, h2,
// f1, f2, logits, best, out. fl: mu, log1p(mu), LOG_SCALE_MIN. Returns a
// cudaError_t, or -1 when the grid cannot be co-resident.
int wavernn_generate(const void* const* ptrs, const int* dims, const float* fl,
                     unsigned int seed, void* stream) {
    return launch(ptrs, dims, fl, seed, stream, kServe);
}

// The same launch with parts of every step left out (probe: 1 dot products,
// 2 staging copies, 4 sampling, 8 everything but the five barriers); its
// samples mean nothing, its time is the measurement.
int wavernn_probe(const void* const* ptrs, const int* dims, const float* fl,
                  unsigned int seed, void* stream, int probe) {
    return launch(ptrs, dims, fl, seed, stream, probe);
}

}  // extern "C"
