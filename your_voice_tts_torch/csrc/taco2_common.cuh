// Helpers shared by the Tacotron2 decode and training kernels
// (taco2_decode.cu, taco2_train.cu): batch tiling of the warp-per-row
// matrix-vector products, warp and block reductions, bf16 unpacking and the
// launch checks. Each source includes it into its own anonymous namespace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBT = 8;      // batch rows per block tile
constexpr int kWarps = 8;   // warps per matrix-vector block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float2 t = __bfloat1622float2(p[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
    }
}

// value of acc[lane] without dynamic register indexing
__device__ __forceinline__ float pick(const float acc[kBT], int lane) {
    float v = 0.f;
#pragma unroll
    for (int bb = 0; bb < kBT; ++bb) v = (bb == lane) ? acc[bb] : v;
    return v;
}

// block-wide reduction through `red` (>= 32 floats); all threads get it
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float other = __shfl_xor_sync(0xffffffffu, v, o);
        v = kMax ? fmaxf(v, other) : v + other;
    }
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < nw ? red[lane] : (kMax ? -INFINITY : 0.f);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float other = __shfl_xor_sync(0xffffffffu, v, o);
            v = kMax ? fmaxf(v, other) : v + other;
        }
        if (lane == 0) red[0] = v;
    }
    __syncthreads();
    return red[0];
}

int launch_status() { return (int)cudaGetLastError(); }

int set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

}  // namespace
