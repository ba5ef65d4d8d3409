// Pieces shared by the Tacotron2 and Tacotron(1) decode kernels
// (taco2_decode.cu, taco1_decode.cu): the warp-per-row matrix-vector
// product over a tile of batch rows, the bf16 staging of concatenated
// inputs, and the location-sensitive attention step. Each source includes
// it into its own anonymous namespace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "taco2_common.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[bb] += sum_i w[i] * xs[bb * ld + i] over one warp (partial per lane).
// ld is a multiple of 8, w and xs rows 16-byte aligned.
template <int NB>
__device__ __forceinline__ void warp_gemv(const __nv_bfloat16* __restrict__ w,
                                          const __nv_bfloat16* xs, int ld,
                                          float acc[NB]) {
    const int lane = threadIdx.x & 31;
    for (int i = lane * 8; i < ld; i += 256) {
        float wf[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(w + i)), wf);
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
            float xf[8];
            unpack8(*reinterpret_cast<const uint4*>(xs + bb * ld + i), xf);
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) s = fmaf(wf[k], xf[k], s);
            acc[bb] += s;
        }
    }
}

// Stage the bf16-rounded concatenation [x0 | x1 | x2] of batch rows
// b0 .. b0 + kBT - 1 into xs [kBT][ld] (zero past the inputs and past B).
__device__ void load_inputs(__nv_bfloat16* xs, int ld, int b0, int B,
                            const float* x0, int n0, const float* x1, int n1,
                            const float* x2, int n2) {
    for (int idx = threadIdx.x; idx < kBT * ld; idx += blockDim.x) {
        const int bb = idx / ld, i = idx - bb * ld, b = b0 + bb;
        float v = 0.f;
        if (b < B) {
            if (i < n0) v = x0[(size_t)b * n0 + i];
            else if (i < n0 + n1) v = x1[(size_t)b * n1 + i - n0];
            else if (i < n0 + n1 + n2) v = x2[(size_t)b * n2 + i - n0 - n1];
        }
        xs[idx] = __float2bfloat16_rn(v);
    }
}

// Location-sensitive attention for one batch row per block: query
// projection, location features from the folded filter u [2, K, A],
// energies, sigmoid or softmax norm, context, state update.
__global__ void attention_kernel(const float* h1, const __nv_bfloat16* q_w,
                                 int ldq, int H1, const __nv_bfloat16* u, int K,
                                 const float* v_w, float v_b, const float* pinp,
                                 const float* maskadd, const __nv_bfloat16* enc,
                                 float* att, float* cum, float* ctx,
                                 float* align_out, int T, int A, int E,
                                 int softmax) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int TK = T + K - 1;
    float* us = reinterpret_cast<float*>(smem);      // [2 * K * A]
    float* pq = us + 2 * K * A;                      // [A]
    float* xa = pq + A;                              // [T + K - 1]
    float* xc = xa + TK;                             // [T + K - 1]
    float* e = xc + TK;                              // [T]
    float* red = e + T;                              // [32]
    const int off = (2 * K * A + A + 2 * TK + T + 32 + 3) & ~3;
    __nv_bfloat16* hq = reinterpret_cast<__nv_bfloat16*>(
        reinterpret_cast<float*>(smem) + off);       // [ldq]

    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
    const int pad = (K - 1) / 2;
    for (int i = tid; i < 2 * K * A; i += nt) us[i] = __bfloat162float(u[i]);
    for (int i = tid; i < ldq; i += nt)
        hq[i] = __float2bfloat16_rn(i < H1 ? h1[(size_t)b * H1 + i] : 0.f);
    for (int i = tid; i < TK; i += nt) {
        const int t = i - pad;
        float va = 0.f, vc = 0.f;
        if (t >= 0 && t < T) {
            va = round_bf16(att[(size_t)b * T + t]);
            vc = round_bf16(cum[(size_t)b * T + t]);
        }
        xa[i] = va;
        xc[i] = vc;
    }
    __syncthreads();
    for (int a = warp; a < A; a += nw) {
        float acc[1] = {0.f};
        warp_gemv<1>(q_w + (size_t)a * ldq, hq, ldq, acc);
        const float s = warp_sum(acc[0]);
        if (lane == 0) pq[a] = s;
    }
    __syncthreads();
    for (int t = warp; t < T; t += nw) {
        float s = 0.f;
        for (int a = lane; a < A; a += 32) {
            float f = 0.f;
            for (int k = 0; k < K; ++k)
                f = fmaf(us[k * A + a], xa[t + k], fmaf(us[(K + k) * A + a], xc[t + k], f));
            s += tanhf(pq[a] + f + pinp[((size_t)b * T + t) * A + a]) * v_w[a];
        }
        s = warp_sum(s);
        if (lane == 0) e[t] = s + v_b + maskadd[(size_t)b * T + t];
    }
    __syncthreads();
    float part = softmax ? -INFINITY : 0.f;
    if (softmax) {
        for (int t = tid; t < T; t += nt) part = fmaxf(part, e[t]);
        const float m = block_reduce<true>(part, red);
        part = 0.f;
        for (int t = tid; t < T; t += nt) {
            e[t] = expf(e[t] - m);
            part += e[t];
        }
    } else {
        for (int t = tid; t < T; t += nt) {
            e[t] = sigmoidf_(e[t]);
            part += e[t];
        }
    }
    const float total = block_reduce<false>(part, red);
    const float inv = 1.f / (softmax ? total : fmaxf(total, 1e-8f));
    for (int t = tid; t < T; t += nt) e[t] = e[t] * inv;
    __syncthreads();
    for (int i = tid; i < E; i += nt) {
        float s = 0.f;
        const __nv_bfloat16* col = enc + (size_t)b * T * E + i;
        for (int t = 0; t < T; ++t) s = fmaf(e[t], __bfloat162float(col[(size_t)t * E]), s);
        ctx[(size_t)b * E + i] = s;
    }
    for (int t = tid; t < T; t += nt) {
        const size_t k = (size_t)b * T + t;
        align_out[k] = e[t];
        att[k] = e[t];
        cum[k] += e[t];
    }
}

}  // namespace
