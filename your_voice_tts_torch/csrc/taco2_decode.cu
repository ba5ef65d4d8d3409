// Tacotron2 free-running decode step kernels for Hopper (sm_90a).
//
// Replaces: your_voice_tts_tpu/ops/pallas/taco2_decode.py
//           `tacotron2_decode_pallas` (its `_kernel` / `_lstm`), the whole
//           decode loop as one Pallas launch with every weight in VMEM.
//
// What bounds it on the H100: each decode step is a chain of batched
// matrix-vector products (B <= a few dozen rows) over ~19M bf16 weights
// (~38 MB at full width): every step has to stream all of them, from L2
// where they stay resident (50 MB) or from HBM, and the ~5 dependent stages
// of a step cannot overlap. The tensor cores idle at this batch; bytes and
// the serial dependency chain are the bound.
//
// What this design does about it (simple first version): weights are
// converted once to bf16 in [out, in] rows so that a warp streams one
// contiguous row with 16-byte loads; the four gate rows of each LSTM unit
// are interleaved so one warp owns i, f, g, o of its unit and the cell
// update fuses into the product's epilogue; the location features are
// computed directly from the folded [2, K, A] filter in shared memory (no
// banded T x T matrix). A step is five launches on one stream (prenet,
// attention LSTM, attention, decoder LSTM, projection + stop); the host
// loop in ops/taco2_decode.py drives them. Persistent blocks or a CUDA graph
// per chunk come later.
//
// Numerics follow the Pallas kernel: matrix inputs rounded to bf16, f32
// accumulation, f32 state, alignments and outputs. The matrix-vector
// helpers and the attention step live in decode_common.cuh, shared with the
// Tacotron(1) decode (taco1_decode.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "decode_common.cuh"
#include "hash_prng.cuh"
#include "taco2_common.cuh"

namespace {

// Prenet: two Linear+ReLU layers, each followed by the hash-PRNG dropout
// (salts 11 and 12, element index row * P + col, as the Pallas kernel).
__global__ void prenet_kernel(const float* frame, int n_in,
                              const __nv_bfloat16* w1, const float* b1, int ld1,
                              const __nv_bfloat16* w2, const float* b2, int ld2,
                              int P, float* out, int B, uint32_t seed,
                              uint32_t step, int dropout) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs1 = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* xs2 = xs1 + kBT * ld1;
    const int b0 = blockIdx.x * kBT;
    load_inputs(xs1, ld1, b0, B, frame, n_in, nullptr, 0, nullptr, 0);
    for (int idx = threadIdx.x; idx < kBT * ld2; idx += blockDim.x)
        xs2[idx] = __float2bfloat16_rn(0.f);
    __syncthreads();
    const uint32_t key = hash_step_key(seed, step);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int row = warp; row < P; row += kWarps) {
        float acc[kBT] = {};
        warp_gemv<kBT>(w1 + (size_t)row * ld1, xs1, ld1, acc);
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) acc[bb] = warp_sum(acc[bb]);
        if (lane < kBT) {
            const uint32_t b = b0 + lane;
            float v = fmaxf(pick(acc, lane) + b1[row], 0.f);
            if (dropout)
                v = hash_uniform(b * (uint32_t)P + row, key, 11u) < 0.5f ? 0.f : v * 2.f;
            xs2[lane * ld2 + row] = __float2bfloat16_rn(v);
        }
    }
    __syncthreads();
    for (int row = warp; row < P; row += kWarps) {
        float acc[kBT] = {};
        warp_gemv<kBT>(w2 + (size_t)row * ld2, xs2, ld2, acc);
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) acc[bb] = warp_sum(acc[bb]);
        if (lane < kBT && b0 + lane < B) {
            const uint32_t b = b0 + lane;
            float v = fmaxf(pick(acc, lane) + b2[row], 0.f);
            if (dropout)
                v = hash_uniform(b * (uint32_t)P + row, key, 12u) < 0.5f ? 0.f : v * 2.f;
            out[(size_t)b * P + row] = v;
        }
    }
}

// LSTM cell over inputs [x0 | x1 | h_in]: gate rows are interleaved
// (row 4 * j + g, g in i, f, g, o), one warp per hidden unit j, the cell
// update fused into the epilogue. c is updated in place; h goes to h_out.
__global__ void lstm_kernel(const __nv_bfloat16* W, const float* bias, int ld,
                            const float* x0, int n0, const float* x1, int n1,
                            const float* h_in, int H, float* c, float* h_out,
                            int B) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    const int b0 = blockIdx.y * kBT;
    load_inputs(xs, ld, b0, B, x0, n0, x1, n1, h_in, H);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = blockIdx.x * kWarps + warp;
    if (j >= H) return;
    float acc[4][kBT] = {};
#pragma unroll
    for (int g = 0; g < 4; ++g)
        warp_gemv<kBT>(W + (size_t)(4 * j + g) * ld, xs, ld, acc[g]);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) acc[g][bb] = warp_sum(acc[g][bb]);
    const int b = b0 + lane;
    if (lane < kBT && b < B) {
        const float gi = sigmoidf_(pick(acc[0], lane) + bias[4 * j]);
        const float gf = sigmoidf_(pick(acc[1], lane) + bias[4 * j + 1]);
        const float gg = tanhf(pick(acc[2], lane) + bias[4 * j + 2]);
        const float go = sigmoidf_(pick(acc[3], lane) + bias[4 * j + 3]);
        const size_t k = (size_t)b * H + j;
        const float cn = gf * c[k] + gi * gg;
        c[k] = cn;
        h_out[k] = go * tanhf(cn);
    }
}

// Mel projection rows [0, OW) and the folded stop row OW over [h2 | ctx];
// frames of rows already done are zeroed, the last frame of the active
// r-group is fed back, the done mask latches at stop_prob > thresh.
__global__ void project_kernel(const __nv_bfloat16* W, const float* bias, int ld,
                               const float* h2, int H2, const float* ctx, int E,
                               const float* done_in, float* done_out, float* out,
                               float* stop_out, float* frame, int B, int OW,
                               int NM, int r, float thresh) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    const int b0 = blockIdx.y * kBT;
    load_inputs(xs, ld, b0, B, h2, H2, ctx, E, nullptr, 0);
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
        const int f = row - NM * (r - 1);
        if (f >= 0 && f < NM) frame[(size_t)b * NM + f] = o;
    } else {
        const float p = sigmoidf_(v);
        stop_out[b] = p;
        done_out[b] = fmaxf(done_in[b], p > thresh ? 1.f : 0.f);
    }
}

}  // namespace

extern "C" {

int taco2_prenet(const void* frame, int n_in, const void* w1, const void* b1, int ld1,
                 const void* w2, const void* b2, int ld2, int P, void* out, int B,
                 unsigned int seed, unsigned int step, int dropout, void* stream) {
    const size_t smem = (size_t)kBT * (ld1 + ld2) * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)prenet_kernel, smem)) return err;
    prenet_kernel<<<(B + kBT - 1) / kBT, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const float*)frame, n_in, (const __nv_bfloat16*)w1, (const float*)b1, ld1,
        (const __nv_bfloat16*)w2, (const float*)b2, ld2, P, (float*)out, B, seed, step,
        dropout);
    return launch_status();
}

int taco2_lstm(const void* W, const void* bias, int ld, const void* x0, int n0,
               const void* x1, int n1, const void* h_in, int H, void* c, void* h_out,
               int B, void* stream) {
    const size_t smem = (size_t)kBT * ld * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)lstm_kernel, smem)) return err;
    dim3 grid((H + kWarps - 1) / kWarps, (B + kBT - 1) / kBT);
    lstm_kernel<<<grid, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)W, (const float*)bias, ld, (const float*)x0, n0,
        (const float*)x1, n1, (const float*)h_in, H, (float*)c, (float*)h_out, B);
    return launch_status();
}

int taco2_attention(const void* h1, const void* q_w, int ldq, int H1, const void* u,
                    int K, const void* v_w, float v_b, const void* pinp,
                    const void* maskadd, const void* enc, void* att, void* cum,
                    void* ctx, void* align_out, int B, int T, int A, int E,
                    int softmax, void* stream) {
    const int TK = T + K - 1;
    const int off = (2 * K * A + A + 2 * TK + T + 32 + 3) & ~3;
    const size_t smem = (size_t)off * sizeof(float) + (size_t)ldq * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)attention_kernel, smem)) return err;
    attention_kernel<<<B, 512, smem, (cudaStream_t)stream>>>(
        (const float*)h1, (const __nv_bfloat16*)q_w, ldq, H1, (const __nv_bfloat16*)u, K,
        (const float*)v_w, v_b, (const float*)pinp, (const float*)maskadd,
        (const __nv_bfloat16*)enc, (float*)att, (float*)cum, (float*)ctx,
        (float*)align_out, T, A, E, softmax);
    return launch_status();
}

int taco2_project(const void* W, const void* bias, int ld, const void* h2, int H2,
                  const void* ctx, int E, const void* done_in, void* done_out,
                  void* out, void* stop_out, void* frame, int B, int OW, int NM, int r,
                  float thresh, void* stream) {
    const size_t smem = (size_t)kBT * ld * sizeof(__nv_bfloat16);
    if (int err = set_smem((const void*)project_kernel, smem)) return err;
    dim3 grid((OW + 1 + kWarps - 1) / kWarps, (B + kBT - 1) / kBT);
    project_kernel<<<grid, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)W, (const float*)bias, ld, (const float*)h2, H2,
        (const float*)ctx, E, (const float*)done_in, (float*)done_out, (float*)out,
        (float*)stop_out, (float*)frame, B, OW, NM, r, thresh);
    return launch_status();
}

}  // extern "C"
