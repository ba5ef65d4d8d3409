// Tacotron(1) free-running decode step kernels for Hopper (sm_90a).
//
// Replaces: your_voice_tts_tpu/ops/pallas/taco1_decode.py
//           `tacotron1_decode_pallas` (its `_kernel` / `_gru`), the whole
//           decode loop as one Pallas launch with every weight in VMEM.
//
// What bounds it on the H100: each decode step is a chain of seven
// dependent stages of batched matrix-vector products (B <= a few dozen
// rows) over ~3.4M bf16 weights at full width (~7 MB; they stay in the 50 MB
// L2): the memory-queue prenet, the attention GRU, the attention, the
// projection, two residual GRUs and the mel projection with the folded stop
// row. The tensor cores idle at this batch; the serial chain of launches and
// the bytes each stage streams are the bound.
//
// What this design does about it (simple first version, the Tacotron2
// decode's design): weights are converted once to bf16 in [out, in] rows so
// that a warp streams one contiguous row with 16-byte loads; the three gate
// rows of each GRU unit are interleaved (input part and hidden part in two
// matrices, since n = tanh(gx_n + r * gh_n) needs them apart) so one warp
// owns r, z, n of its unit and the update, and the residual add, fuse into
// the products' epilogue; the location features come from the folded
// [2, K, A] filter in shared memory (the attention step of
// decode_common.cuh, shared with the Tacotron2 decode). The memory queue,
// the hidden states and the done mask are double-buffered so no block reads
// what another rewrites in the same launch. A step is seven launches on one
// stream; the host loop in ops/taco1_decode.py drives them and reads the
// done mask once per chunk. Persistent blocks or a CUDA graph per chunk come
// later.
//
// Numerics follow the Pallas kernel: matrix inputs rounded to bf16, f32
// accumulation, f32 state, alignments and outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "decode_common.cuh"
#include "hash_prng.cuh"
#include "taco2_common.cuh"

namespace {

// Prenet over the flat memory queue [B, NQ]: two Linear+ReLU layers (P1 then
// P2 wide), each followed by the hash-PRNG dropout (salts 21 and 22, element
// index row * width + col, as the Pallas kernel).
__global__ void prenet_kernel(const float* queue, int NQ,
                              const __nv_bfloat16* w1, const float* b1, int ld1, int P1,
                              const __nv_bfloat16* w2, const float* b2, int ld2, int P2,
                              float* out, int B, uint32_t seed, uint32_t step,
                              int dropout) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs1 = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* xs2 = xs1 + kBT * ld1;
    const int b0 = blockIdx.x * kBT;
    load_inputs(xs1, ld1, b0, B, queue, NQ, nullptr, 0, nullptr, 0);
    for (int idx = threadIdx.x; idx < kBT * ld2; idx += blockDim.x)
        xs2[idx] = __float2bfloat16_rn(0.f);
    __syncthreads();
    const uint32_t key = hash_step_key(seed, step);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int row = warp; row < P1; row += kWarps) {
        float acc[kBT] = {};
        warp_gemv<kBT>(w1 + (size_t)row * ld1, xs1, ld1, acc);
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) acc[bb] = warp_sum(acc[bb]);
        if (lane < kBT) {
            const uint32_t b = b0 + lane;
            float v = fmaxf(pick(acc, lane) + b1[row], 0.f);
            if (dropout)
                v = hash_uniform(b * (uint32_t)P1 + row, key, 21u) < 0.5f ? 0.f : v * 2.f;
            xs2[lane * ld2 + row] = __float2bfloat16_rn(v);
        }
    }
    __syncthreads();
    for (int row = warp; row < P2; row += kWarps) {
        float acc[kBT] = {};
        warp_gemv<kBT>(w2 + (size_t)row * ld2, xs2, ld2, acc);
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) acc[bb] = warp_sum(acc[bb]);
        if (lane < kBT && b0 + lane < B) {
            const uint32_t b = b0 + lane;
            float v = fmaxf(pick(acc, lane) + b2[row], 0.f);
            if (dropout)
                v = hash_uniform(b * (uint32_t)P2 + row, key, 22u) < 0.5f ? 0.f : v * 2.f;
            out[(size_t)b * P2 + row] = v;
        }
    }
}

// GRU cell, torch gate order (r, z, n): input rows Wx [3H, ldx] over
// [x0 | x1] and hidden rows Wh [3H, ldh] over h_in, both interleaved (row
// 3 * j + g), one warp per hidden unit j. h_out = (1 - z) n + z h_in with
// n = tanh(gx_n + r * gh_n); with `res` set, res = x0 + h_out too (x0 is H
// wide then: the residual GRUs).
__global__ void gru_kernel(const __nv_bfloat16* Wx, const float* bx, int ldx,
                           const __nv_bfloat16* Wh, const float* bh, int ldh,
                           const float* x0, int n0, const float* x1, int n1,
                           const float* h_in, int H, float* h_out, float* res, int B) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* hs = xs + kBT * ldx;
    const int b0 = blockIdx.y * kBT;
    load_inputs(xs, ldx, b0, B, x0, n0, x1, n1, nullptr, 0);
    load_inputs(hs, ldh, b0, B, h_in, H, nullptr, 0, nullptr, 0);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = blockIdx.x * kWarps + warp;
    if (j >= H) return;
    float ax[3][kBT] = {}, ah[3][kBT] = {};
#pragma unroll
    for (int g = 0; g < 3; ++g) {
        warp_gemv<kBT>(Wx + (size_t)(3 * j + g) * ldx, xs, ldx, ax[g]);
        warp_gemv<kBT>(Wh + (size_t)(3 * j + g) * ldh, hs, ldh, ah[g]);
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) {
            ax[g][bb] = warp_sum(ax[g][bb]);
            ah[g][bb] = warp_sum(ah[g][bb]);
        }
    const int b = b0 + lane;
    if (lane < kBT && b < B) {
        const float r = sigmoidf_(pick(ax[0], lane) + bx[3 * j] + pick(ah[0], lane) + bh[3 * j]);
        const float z = sigmoidf_(pick(ax[1], lane) + bx[3 * j + 1] + pick(ah[1], lane)
                                  + bh[3 * j + 1]);
        const float n = tanhf(pick(ax[2], lane) + bx[3 * j + 2]
                              + r * (pick(ah[2], lane) + bh[3 * j + 2]));
        const size_t k = (size_t)b * H + j;
        const float h = (1.f - z) * n + z * h_in[k];
        h_out[k] = h;
        if (res) res[k] = x0[k] + h;
    }
}

// out = W [x0 | x1] + bias, rows [0, D): the project-to-decoder dense.
__global__ void linear_kernel(const __nv_bfloat16* W, const float* bias, int ld,
                              const float* x0, int n0, const float* x1, int n1, float* out,
                              int B, int D) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    const int b0 = blockIdx.y * kBT;
    load_inputs(xs, ld, b0, B, x0, n0, x1, n1, nullptr, 0);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= D) return;
    float acc[kBT] = {};
    warp_gemv<kBT>(W + (size_t)row * ld, xs, ld, acc);
#pragma unroll
    for (int bb = 0; bb < kBT; ++bb) acc[bb] = warp_sum(acc[bb]);
    const int b = b0 + lane;
    if (lane < kBT && b < B) out[(size_t)b * D + row] = pick(acc, lane) + bias[row];
}

// Mel projection rows [0, OW) and the folded stop row OW over x; frames of
// rows already done are zeroed; the queue keeps the last NQ values of
// [queue_in | frames [0, NM r)] (r > memory keeps the step's last frames
// only); the done mask latches at stop_prob > thresh.
__global__ void mel_kernel(const __nv_bfloat16* W, const float* bias, int ld,
                           const float* x, int D, const float* done_in, float* done_out,
                           float* out, float* stop_out, const float* queue_in,
                           float* queue_out, int NQ, int B, int OW, int NMr,
                           float thresh) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    const int b0 = blockIdx.y * kBT;
    if (blockIdx.x == 0) {
        const int keep = NQ > NMr ? NQ - NMr : 0;
        for (int idx = threadIdx.x; idx < kBT * keep; idx += blockDim.x) {
            const int b = b0 + idx / keep, i = idx % keep;
            if (b < B) queue_out[(size_t)b * NQ + i] = queue_in[(size_t)b * NQ + NMr + i];
        }
    }
    load_inputs(xs, ld, b0, B, x, D, nullptr, 0, nullptr, 0);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row > OW) return;
    float acc[kBT] = {};
    warp_gemv<kBT>(W + (size_t)row * ld, xs, ld, acc);
#pragma unroll
    for (int bb = 0; bb < kBT; ++bb) acc[bb] = warp_sum(acc[bb]);
    const int b = b0 + lane;
    if (lane >= kBT || b >= B) return;
    const float v = pick(acc, lane) + bias[row];
    if (row < OW) {
        const float o = v * (1.f - done_in[b]);
        out[(size_t)b * OW + row] = o;
        const int q = NQ - NMr + row;
        if (row < NMr && q >= 0) queue_out[(size_t)b * NQ + q] = o;
    } else {
        const float p = sigmoidf_(v);
        stop_out[b] = p;
        done_out[b] = fmaxf(done_in[b], p > thresh ? 1.f : 0.f);
    }
}

}  // namespace

extern "C" {

int taco1_prenet(const void* queue, int NQ, const void* w1, const void* b1, int ld1, int P1,
                 const void* w2, const void* b2, int ld2, int P2, void* out, int B,
                 unsigned int seed, unsigned int step, int dropout, void* stream) {
    const size_t smem = (size_t)kBT * (ld1 + ld2) * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)prenet_kernel, smem)) return err;
    prenet_kernel<<<(B + kBT - 1) / kBT, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const float*)queue, NQ, (const __nv_bfloat16*)w1, (const float*)b1, ld1, P1,
        (const __nv_bfloat16*)w2, (const float*)b2, ld2, P2, (float*)out, B, seed, step,
        dropout);
    return launch_status();
}

int taco1_gru(const void* Wx, const void* bx, int ldx, const void* Wh, const void* bh,
              int ldh, const void* x0, int n0, const void* x1, int n1, const void* h_in,
              int H, void* h_out, void* res, int B, void* stream) {
    const size_t smem = (size_t)kBT * (ldx + ldh) * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)gru_kernel, smem)) return err;
    dim3 grid((H + kWarps - 1) / kWarps, (B + kBT - 1) / kBT);
    gru_kernel<<<grid, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)Wx, (const float*)bx, ldx, (const __nv_bfloat16*)Wh,
        (const float*)bh, ldh, (const float*)x0, n0, (const float*)x1, n1,
        (const float*)h_in, H, (float*)h_out, (float*)res, B);
    return launch_status();
}

int taco1_linear(const void* W, const void* bias, int ld, const void* x0, int n0,
                 const void* x1, int n1, void* out, int B, int D, void* stream) {
    const size_t smem = (size_t)kBT * ld * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)linear_kernel, smem)) return err;
    dim3 grid((D + kWarps - 1) / kWarps, (B + kBT - 1) / kBT);
    linear_kernel<<<grid, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)W, (const float*)bias, ld, (const float*)x0, n0,
        (const float*)x1, n1, (float*)out, B, D);
    return launch_status();
}

int taco1_attention(const void* h, const void* q_w, int ldq, int H, const void* u, int K,
                    const void* v_w, float v_b, const void* pinp, const void* maskadd,
                    const void* enc, void* att, void* cum, void* ctx, void* align_out, int B,
                    int T, int A, int E, int softmax, void* stream) {
    const int TK = T + K - 1;
    const int off = (2 * K * A + A + 2 * TK + T + 32 + 3) & ~3;
    const size_t smem = (size_t)off * sizeof(float) + (size_t)ldq * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)attention_kernel, smem)) return err;
    attention_kernel<<<B, 512, smem, (cudaStream_t)stream>>>(
        (const float*)h, (const __nv_bfloat16*)q_w, ldq, H, (const __nv_bfloat16*)u, K,
        (const float*)v_w, v_b, (const float*)pinp, (const float*)maskadd,
        (const __nv_bfloat16*)enc, (float*)att, (float*)cum, (float*)ctx, (float*)align_out,
        T, A, E, softmax);
    return launch_status();
}

int taco1_mel(const void* W, const void* bias, int ld, const void* x, int D,
              const void* done_in, void* done_out, void* out, void* stop_out,
              const void* queue_in, void* queue_out, int NQ, int B, int OW, int NMr,
              float thresh, void* stream) {
    const size_t smem = (size_t)kBT * ld * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)mel_kernel, smem)) return err;
    dim3 grid((OW + 1 + kWarps - 1) / kWarps, (B + kBT - 1) / kBT);
    mel_kernel<<<grid, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)W, (const float*)bias, ld, (const float*)x, D,
        (const float*)done_in, (float*)done_out, (float*)out, (float*)stop_out,
        (const float*)queue_in, (float*)queue_out, NQ, B, OW, NMr, thresh);
    return launch_status();
}

}  // extern "C"
