// Pieces shared by the two persistent decode kernels (taco2_decode.cu,
// taco1_decode.cu): the block shape and the tensor-core tile, the 16-byte
// cp.async copies of stage inputs into a batch tile, the m16n8k16 product,
// and the location-sensitive attention's three parts on the device (the
// location features of a block's (row, t) pairs, their energies, and the
// norm over T with the context in 8-column chunks, whose norm of a row a
// caller can replace, as taco2_decode.cu's attention variants do). The
// attention parts read the fields they name from the kernel's own Params
// and Smem. Each source includes it into its own anonymous namespace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "taco2_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kNW = kThreads / 32;    // warps a block
constexpr int kTile = 8;              // batch rows a tile (the n of m16n8k16)
constexpr int kRows = 16;             // weight rows a tile (the m)
constexpr int kAcc = kRows * kTile;   // accumulator floats of a (row tile, batch tile)

// One source of a staged tile: rows [B, w] bf16, w a multiple of 16.
struct Src {
    const bf16* p;
    int w;
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d += A (16 x 16 bf16, a) . B (16 x 8 bf16, b0 b1), f32 accumulation
__device__ __forceinline__ void mma16816(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Start copying rows tile * 8 .. + 7 of the concatenation [s0 | s1 | s2]
// (an absent source has w = 0) into xs [kTile][xld] (zero rows past B),
// 16 bytes at a time; the caller waits.
__device__ void stage_tile(bf16* xs, int xld, int tile, int B, Src s0, Src s1, Src s2) {
    const int nv = (s0.w + s1.w + s2.w) / 8;
    for (int q = threadIdx.x; q < kTile * nv; q += blockDim.x) {
        const int bb = q / nv, v = q - bb * nv, b = tile * kTile + bb;
        bf16* dst = xs + bb * xld + 8 * v;
        if (b >= B) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
            continue;
        }
        const int off = 8 * v;
        const bf16* src = off < s0.w ? s0.p + (size_t)b * s0.w + off
                        : off < s0.w + s1.w ? s1.p + (size_t)b * s1.w + off - s0.w
                        : s2.p + (size_t)b * s2.w + off - s0.w - s1.w;
        cp_async16(dst, src);
    }
}

// Location features of the block's (row, t) pairs from att / cum, plus
// W_k m: pre [B, T, A] for the next step's energies. A warp a pair; the
// filter window of K taps is staged 32 taps a pass. W_k m comes from the
// kernel's pinp [B, T, A], or, with kPinShared, from the copy of the
// block's pairs' rows in its shared memory, s.pin [PPB][A].
template <bool kPinShared = false, class Params, class Smem>
__device__ void location(const Params& p, const Smem& s) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int NP = p.B * p.T, p0 = (int)blockIdx.x * p.PPB, p1 = min(NP, p0 + p.PPB);
    const int pad = (p.K - 1) / 2, KW = (p.K + 31) / 32 * 32;
    float* xa = s.xw + warp * 2 * KW;
    float* xc = xa + KW;
    for (int pi = p0 + warp; pi < p1; pi += kNW) {
        const int b = pi / p.T, t = pi - b * p.T;
        for (int k = lane; k < KW; k += 32) {
            const int tt = t - pad + k;
            float va = 0.f, vc = 0.f;
            if (k < p.K && tt >= 0 && tt < p.T) {
                va = __bfloat162float(__float2bfloat16_rn(__ldcg(p.att + (size_t)b * p.T + tt)));
                vc = __bfloat162float(__float2bfloat16_rn(__ldcg(p.cum + (size_t)b * p.T + tt)));
            }
            xa[k] = va;
            xc[k] = vc;
        }
        const float* pin;
        if constexpr (kPinShared) pin = s.pin + (size_t)(pi - p0) * p.A;
        else pin = p.pinp + (size_t)pi * p.A;
        float* pr = s.pre + (size_t)(pi - p0) * p.A;
        __syncwarp();
        // 128 features at a time, four independent chains a lane, each
        // started from W_k m
        for (int a0 = 0; a0 < p.A; a0 += 128) {
            float f[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int a = a0 + lane + 32 * i;
                if constexpr (kPinShared) f[i] = a < p.A ? pin[a] : 0.f;
                else f[i] = a < p.A ? __ldg(pin + a) : 0.f;
            }
            const float* u0 = s.us + a0 + lane;
            const float* u1 = u0 + p.K * p.A;
#pragma unroll 2
            for (int k = 0; k < p.K; ++k) {
                const float x0 = xa[k], x1 = xc[k];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    if (a0 + lane + 32 * i < p.A)
                        f[i] = fmaf(u0[k * p.A + 32 * i], x0, fmaf(u1[k * p.A + 32 * i], x1, f[i]));
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (a0 + lane + 32 * i < p.A) pr[a0 + lane + 32 * i] = f[i];
        }
        __syncwarp();
    }
}

// R4: energies of the block's (row, t) pairs, a warp a pair.
template <class Params, class Smem>
__device__ void energies(const Params& p, const Smem& s) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int NP = p.B * p.T, p0 = (int)blockIdx.x * p.PPB, p1 = min(NP, p0 + p.PPB);
    for (int pi = p0 + warp; pi < p1; pi += kNW) {
        const int b = pi / p.T;
        const float* pr = s.pre + (size_t)(pi - p0) * p.A;
        const float* pq = p.pq + (size_t)b * p.A;
        float sum = 0.f;
#pragma unroll 4
        for (int a = lane; a < p.A; a += 32)
            sum += tanhf(__ldcg(pq + a) + pr[a]) * s.vw[a];
        sum = warp_sum(sum);
        if (lane == 0) p.e[pi] = sum + p.v_b + __ldg(p.maskadd + pi);
    }
}

// This block's context items [i0, i1) (8 columns of E each, item b * CE +
// c) and the rows they touch, rb0 .. rb1.
struct CtxRange {
    int i0, i1, rb0, rb1;
};

template <class Params>
__device__ __forceinline__ CtxRange ctx_range(const Params& p) {
    const int CE = p.E16 / 8, NI = p.B * CE;
    const int i0 = (int)blockIdx.x * p.CPB, i1 = min(NI, i0 + p.CPB);
    return {i0, i1, i0 / CE, i1 > i0 ? (i1 - 1) / CE : i0 / CE - 1};
}

// The cum rows this block writes (those whose first context chunk is
// here) from global memory into s.cum, at the launch's start; R5 keeps
// both up to date.
template <class Params, class Smem>
__device__ void load_cum(const Params& p, const Smem& s) {
    const int CE = p.E16 / 8;
    const CtxRange c = ctx_range(p);
    for (int b = c.rb0; b <= c.rb1; ++b) {
        if (b * CE < c.i0) continue;
        for (int t = threadIdx.x; t < p.T; t += blockDim.x)
            s.cum[(b - c.rb0) * p.T + t] = p.cum[(size_t)b * p.T + t];
    }
}

// The norm over T of row rb's energies into al [T], by one warp: sigmoid
// or softmax (p.softmax). With kWin, energies at t outside [lo, hi] count
// as -1e9 (windowed attention's window).
template <bool kWin = false, class Params>
__device__ void norm_energies(const Params& p, int rb, float* al, int lo = 0, int hi = 0) {
    const int lane = threadIdx.x & 31;
    const float* er = p.e + (size_t)rb * p.T;
    float m = -INFINITY;
    for (int t = lane; t < p.T; t += 32) {
        const float v = !kWin || (t >= lo && t <= hi) ? __ldcg(er + t) : -1e9f;
        al[t] = v;
        m = fmaxf(m, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float part = 0.f;
    for (int t = lane; t < p.T; t += 32) {
        const float v = p.softmax ? expf(al[t] - m) : sigmoidf_(al[t]);
        al[t] = v;
        part += v;
    }
    const float total = warp_sum(part);
    const float inv = 1.f / (p.softmax ? total : fmaxf(total, 1e-8f));
    for (int t = lane; t < p.T; t += 32) al[t] *= inv;
}

// R5: the norm over T of the rows this block's context items touch (warps
// from the last down), the context chunks (warps from the first up; each
// loads its first chunk's encoder columns before the norm, which does not
// need them), and, for each row whose first chunk is here, the alignment
// output, att and cum (kept in s.cum). norm(rb, i, al) writes row rb's
// alignment into al [T] with one warp; i = rb - the block's first row
// indexes the block's own state of the row.
template <class Params, class Smem, class Norm>
__device__ void context(const Params& p, const Smem& s, int step, Norm norm) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int CE = p.E16 / 8;
    const CtxRange c = ctx_range(p);
    if (c.i0 >= c.i1) return;                          // block-uniform
    constexpr int kPre = 8;                            // chunks of 32 t kept in registers
    uint4 ev[kPre];
    const int it0 = c.i0 + warp;
    if (it0 < c.i1) {
        const int b = it0 / CE;
        const bf16* en = p.enc + (size_t)b * p.T * p.E16 + 8 * (it0 - b * CE);
#pragma unroll
        for (int u = 0; u < kPre; ++u) {
            const int t = lane + 32 * u;
            ev[u] = t < p.T ? __ldg(reinterpret_cast<const uint4*>(en + (size_t)t * p.E16))
                            : make_uint4(0u, 0u, 0u, 0u);
        }
    }
    for (int rb = c.rb0 + (kNW - 1 - warp); rb <= c.rb1; rb += kNW)
        norm(rb, rb - c.rb0, s.aln + (rb - c.rb0) * p.T);
    __syncthreads();
    for (int it = it0; it < c.i1; it += kNW) {
        const int b = it / CE, ch = it - b * CE;
        const float* al = s.aln + (b - c.rb0) * p.T;
        const bf16* en = p.enc + (size_t)b * p.T * p.E16 + 8 * ch;
        float acc[8] = {};
#pragma unroll
        for (int u = 0; u < kPre; ++u) {
            const int t = lane + 32 * u;
            if (t >= p.T) break;
            float ef[8];
            unpack8(it == it0 ? ev[u]
                              : __ldg(reinterpret_cast<const uint4*>(en + (size_t)t * p.E16)), ef);
            const float a = al[t];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] = fmaf(a, ef[k], acc[k]);
        }
        for (int t = lane + 32 * kPre; t < p.T; t += 32) {
            float ef[8];
            unpack8(__ldg(reinterpret_cast<const uint4*>(en + (size_t)t * p.E16)), ef);
            const float a = al[t];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] = fmaf(a, ef[k], acc[k]);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = warp_sum(acc[k]);
        if (lane < 8) {
            float v = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) v = (k == lane) ? acc[k] : v;
            p.ctx[(size_t)b * p.E16 + 8 * ch + lane] = __float2bfloat16_rn(v);
        }
    }
    for (int b = c.rb0; b <= c.rb1; ++b) {
        if (b * CE < c.i0) continue;                   // its first chunk is elsewhere
        const float* al = s.aln + (b - c.rb0) * p.T;
        float* sc = s.cum + (b - c.rb0) * p.T;
        for (int t = threadIdx.x; t < p.T; t += blockDim.x) {
            const size_t k = (size_t)b * p.T + t;
            const float a = al[t];
            p.aligns[((size_t)step * p.B + b) * p.T + t] = a;
            p.att[k] = a;
            sc[t] += a;
            p.cum[k] = sc[t];
        }
    }
}

// R5 with the location-sensitive attention's own norm.
template <class Params, class Smem>
__device__ void context(const Params& p, const Smem& s, int step) {
    context(p, s, step, [&](int rb, int, float* al) { norm_energies(p, rb, al); });
}

}  // namespace
