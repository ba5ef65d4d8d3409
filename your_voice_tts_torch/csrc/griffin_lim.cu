// Batched Griffin-Lim for Hopper (sm_90a): the three routes of the
// reference's `dsp.griffin_lim_batch`.
//
// Replaces: your_voice_tts_tpu/ops/pallas/griffin_lim.py
//   - `griffin_lim_pallas_wave` with an injected initial phase
//     (`_kernel_wave_init`: `_gl_loop_packed`, `_banded_ola`, `_emit_wave`):
//     FGLA loop + final inverse STFT (gl_synth, gl_ola, gl_analysis, gl_emit);
//   - `griffin_lim_pallas_full` with an injected phase (`_kernel_full_init`):
//     the same FGLA loop, returning the complex spectrum for the caller's
//     istft (the loop's three kernels, then gl_unpack);
//   - `gl_iteration_pallas` (`_kernel`), driven by `griffin_lim_pallas_batch`:
//     one PLAIN Griffin-Lim iteration in the unpacked [T, n_fft/2 + 1]
//     layout (gli_synth, gli_ola, gli_analysis).
//
// What bounds it on the H100: two matrix products per iteration (the DFT
// pair as products), 2 * rows * n_fft^2 multiply-adds each on the packed
// re/im plane, 2 * rows * n_fft * 2 Kp on the unpacked one (Kp = n_fft/2 + 1
// padded to 64): at serving shapes (8 x 500 frames, n_fft 1024, 24
// iterations) ~0.4 TFLOP, so the tensor cores are the bound; the
// overlap-add between the products is a few MB of traffic per iteration.
//
// What this design does about it (simple first version): the products run
// on the tensor cores through WMMA bf16 fragments (f32 accumulation) in
// 128 x 128 tiles that stack every utterance's frames as rows; the FGLA
// momentum (packed loop) or the plain projection (unpacked loop), the rsqrt
// rephase and the re-magnitude are fused into the second product's
// epilogue, which holds matching real and imaginary columns in one tile; the
// banded overlap-add (K = ceil(n_fft/hop) - 1 shifted adds) stays inside
// each utterance's own rows. The packed loop's state (plane and previous
// projection) is bf16 like the TPU kernel's default; the unpacked loop keeps
// its spectrum in f32 beside a bf16 copy that feeds the products, as the
// TPU kernel casts its f32 input. Magnitudes, the Nyquist channel and all
// accumulation are f32. The unpacked layout's Kf = n_fft/2 + 1 bins are
// padded with zero rows and columns of the DFT matrices to Kp, so every
// tile is whole. A TMA/wgmma pipeline comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8;    // smem row strides (bf16 / bf16 / f32)
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;
constexpr int kThreads = 256;    // 8 warps: 4 along rows x 2 along columns
constexpr size_t kSmemAB = (size_t)kBM * kLdA * 2 + (size_t)kBK * kLdB * 2;
constexpr size_t kSmemC = (size_t)kBM * kLdC * 4;
constexpr size_t kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

// Cs[128][kLdC] = A[row0 : row0 + 128, :] @ B[:, cols], A [M, K] and
// B [K, ldb] row-major bf16, K a multiple of kBK, ldb of 8. Tile column
// c < 64 maps to B column colA + c, c >= 64 to colB + c - 64 (contiguous
// when colB = colA + 64).
__device__ void gemm_tile(const __nv_bfloat16* __restrict__ A,
                          const __nv_bfloat16* __restrict__ Bm, int M, int K,
                          int ldb, int row0, int colA, int colB,
                          unsigned char* smem) {
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Bs = As + kBM * kLdA;
    float* Cs = reinterpret_cast<float*>(smem);
    const int tid = threadIdx.x, warp = tid >> 5;
    const int wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            const int idx = tid + it * kThreads;
            const int r = idx >> 2, seg = (idx & 3) * 8, grow = row0 + r;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (grow < M)
                v = __ldg(reinterpret_cast<const uint4*>(A + (size_t)grow * K + k0 + seg));
            *reinterpret_cast<uint4*>(As + r * kLdA + seg) = v;
        }
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            const int idx = tid + it * kThreads;
            const int r = idx >> 4, c = (idx & 15) * 8;
            const int gcol = c < 64 ? colA + c : colB + c - 64;
            *reinterpret_cast<uint4*>(Bs + r * kLdB + c) =
                __ldg(reinterpret_cast<const uint4*>(Bm + (size_t)(k0 + r) * ldb + gcol));
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + wn * 64 + j * 16, kLdB);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 64 + j * 16,
                                    acc[i][j], kLdC, wmma::mem_row_major);
    __syncthreads();
}

// xw = P @ Mw + frN (x) altw   (synthesis: inverse DFT with window folded in,
// plus the Nyquist bin's column)
__global__ void __launch_bounds__(kThreads)
synth_kernel(const __nv_bfloat16* P, const __nv_bfloat16* Mw, const float* frN,
             const float* altw, float* xw, int M, int N) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
    gemm_tile(P, Mw, M, N, N, row0, col0, col0 + 64, smem);
    const float* Cs = reinterpret_cast<const float*>(smem);
    for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
        const int r = idx / kBN, c = idx % kBN, grow = row0 + r;
        if (grow < M)
            xw[(size_t)grow * N + col0 + c] = Cs[r * kLdC + c] + frN[grow] * altw[col0 + c];
    }
}

// G = g @ Mf^T, then FGLA extrapolation against the previous projection
// pP, unit phase by rsqrt, and the magnitudes re-imposed; P and pP update
// in place. Tile columns [0, 64) are real parts j, [64, 128) imaginary
// parts half + j of the same bins.
__global__ void __launch_bounds__(kThreads)
analysis_kernel(const __nv_bfloat16* g, const __nv_bfloat16* MfT, const float* mag,
                int Kf, __nv_bfloat16* P, __nv_bfloat16* pP, int M, int N,
                float mom) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int half = N / 2;
    const int row0 = blockIdx.y * kBM, j0 = blockIdx.x * 64;
    gemm_tile(g, MfT, M, N, N, row0, j0, half + j0, smem);
    const float* Cs = reinterpret_cast<const float*>(smem);
    for (int idx = threadIdx.x; idx < kBM * 64; idx += kThreads) {
        const int r = idx / 64, c = idx % 64, grow = row0 + r;
        if (grow >= M) continue;
        const size_t kr = (size_t)grow * N + j0 + c, ki = kr + half;
        const float gr = Cs[r * kLdC + c], gi = Cs[r * kLdC + 64 + c];
        const float tr = gr + mom * (gr - __bfloat162float(pP[kr]));
        const float ti = gi + mom * (gi - __bfloat162float(pP[ki]));
        const float inv = rsqrtf(fmaxf(tr * tr + ti * ti, 1e-30f));
        const float m = mag[(size_t)grow * Kf + j0 + c];
        P[kr] = __float2bfloat16_rn(m * tr * inv);
        P[ki] = __float2bfloat16_rn(m * ti * inv);
        pP[kr] = __float2bfloat16_rn(gr);
        pP[ki] = __float2bfloat16_rn(gi);
    }
}

// overlap-added signal at (row, n): frame t's own sample plus the K
// neighbours on each side inside the same utterance (t = row % T)
__device__ __forceinline__ float ola_at(const float* xw, int row, int t, int T, int N,
                                        int hop, int K, int n) {
    float acc = xw[(size_t)row * N + n];
    for (int k = 1; k <= K; ++k) {
        const int s = k * hop;
        if (n >= s && t + k < T) acc += xw[(size_t)(row + k) * N + n - s];
        if (n + s < N && t - k >= 0) acc += xw[(size_t)(row - k) * N + n + s];
    }
    return acc;
}

// banded OLA -> g (bf16) and the Nyquist channel's projection gn =
// sum_n acc * nyq, whose FGLA step and re-magnitude run here too
__global__ void ola_kernel(const float* xw, const float* nyq, const float* mag, int Kf,
                           __nv_bfloat16* g, float* frN, float* pN, int M, int T,
                           int N, int hop, int K, float mom) {
    __shared__ float red[32];
    const int row = blockIdx.x, t = row % T;
    float part = 0.f;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        const float acc = ola_at(xw, row, t, T, N, hop, K, n);
        g[(size_t)row * N + n] = __float2bfloat16_rn(acc);
        part = fmaf(acc, nyq[n], part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
        float gn = 0.f;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) gn += red[w];
        const float tn = gn + mom * (gn - pN[row]);
        const float inv = rsqrtf(fmaxf(tn * tn, 1e-30f));
        frN[row] = mag[(size_t)row * Kf + N / 2] * tn * inv;
        pN[row] = gn;
    }
}

// final synthesis: waveform samples = OLA columns [c0, c0 + hop) * wsic
__global__ void emit_kernel(const float* xw, const float* wsic, float* y, int M,
                            int T, int N, int hop, int K, int c0) {
    const int row = blockIdx.x, t = row % T;
    for (int j = threadIdx.x; j < hop; j += blockDim.x)
        y[(size_t)row * hop + j] = ola_at(xw, row, t, T, N, hop, K, c0 + j) * wsic[j];
}

// complex spectrum of the packed loop's state, as interleaved (re, im):
// bins j < N/2 from the plane's halves, the Nyquist bin from its own real
// channel with a zero imaginary part
__global__ void unpack_kernel(const __nv_bfloat16* P, const float* frN, float2* out,
                              int M, int N) {
    const int row = blockIdx.x, half = N / 2;
    for (int j = threadIdx.x; j <= half; j += blockDim.x) {
        float2 v = make_float2(frN[row], 0.f);
        if (j < half)
            v = make_float2(__bfloat162float(P[(size_t)row * N + j]),
                            __bfloat162float(P[(size_t)row * N + half + j]));
        out[(size_t)row * (half + 1) + j] = v;
    }
}

// --- plain Griffin-Lim, unpacked layout (kernel 4) ---------------------------
// Spectrum rows hold [re (Kp) | im (Kp)], zero past Kf; `syn` [2 Kp, N] is
// [iC ; -iS], `ana` [N, 2 Kp] is [C | -S] (zero rows / columns past Kf).

// xw = ([Fr | Fi] @ [iC ; -iS]) * window
__global__ void __launch_bounds__(kThreads)
gli_synth_kernel(const __nv_bfloat16* Fb, const __nv_bfloat16* syn, const float* win,
                 float* xw, int M, int N, int K2) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
    gemm_tile(Fb, syn, M, K2, N, row0, col0, col0 + 64, smem);
    const float* Cs = reinterpret_cast<const float*>(smem);
    for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
        const int r = idx / kBN, c = idx % kBN, grow = row0 + r;
        if (grow < M) xw[(size_t)grow * N + col0 + c] = Cs[r * kLdC + c] * win[col0 + c];
    }
}

// g = bf16(OLA(xw) * wsi * window), the OLA inside each utterance's T rows
__global__ void gli_ola_kernel(const float* xw, const float* wsi, const float* win,
                               __nv_bfloat16* g, int T, int N, int hop, int K) {
    const int row = blockIdx.x, t = row % T;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
        g[(size_t)row * N + n] =
            __float2bfloat16_rn(ola_at(xw, row, t, T, N, hop, K, n) * wsi[n] * win[n]);
}

// (gr, gi) = g @ [C | -S]; out = mag * (gr, gi) * rsqrt(max(gr^2 + gi^2,
// 1e-30)), written to the f32 spectrum and its bf16 copy. Tile columns
// [0, 64) are real parts of bins j0 + c, [64, 128) their imaginary parts.
__global__ void __launch_bounds__(kThreads)
gli_analysis_kernel(const __nv_bfloat16* g, const __nv_bfloat16* ana, const float* mag,
                    float* Ff, __nv_bfloat16* Fb, int M, int N, int Kp) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int row0 = blockIdx.y * kBM, j0 = blockIdx.x * 64;
    gemm_tile(g, ana, M, N, 2 * Kp, row0, j0, Kp + j0, smem);
    const float* Cs = reinterpret_cast<const float*>(smem);
    for (int idx = threadIdx.x; idx < kBM * 64; idx += kThreads) {
        const int r = idx / 64, c = idx % 64, grow = row0 + r;
        if (grow >= M) continue;
        const float gr = Cs[r * kLdC + c], gi = Cs[r * kLdC + 64 + c];
        const float inv = rsqrtf(fmaxf(gr * gr + gi * gi, 1e-30f));
        const float m = mag[(size_t)grow * Kp + j0 + c];
        const size_t kr = (size_t)grow * 2 * Kp + j0 + c, ki = kr + Kp;
        const float vr = m * gr * inv, vi = m * gi * inv;
        Ff[kr] = vr;
        Ff[ki] = vi;
        Fb[kr] = __float2bfloat16_rn(vr);
        Fb[ki] = __float2bfloat16_rn(vi);
    }
}

int status() { return (int)cudaGetLastError(); }

int set_gemm_smem(const void* fn) {
    return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)kSmem);
}

}  // namespace

extern "C" {

int gl_synth(const void* P, const void* Mw, const void* frN, const void* altw, void* xw,
             int M, int N, void* stream) {
    cudaError_t err = cudaFuncSetAttribute((const void*)synth_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(N / kBN, (M + kBM - 1) / kBM);
    synth_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)P, (const __nv_bfloat16*)Mw, (const float*)frN,
        (const float*)altw, (float*)xw, M, N);
    return status();
}

int gl_analysis(const void* g, const void* MfT, const void* mag, int Kf, void* P,
                void* pP, int M, int N, float mom, void* stream) {
    cudaError_t err = cudaFuncSetAttribute((const void*)analysis_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(N / 2 / 64, (M + kBM - 1) / kBM);
    analysis_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)MfT, (const float*)mag, Kf,
        (__nv_bfloat16*)P, (__nv_bfloat16*)pP, M, N, mom);
    return status();
}

int gl_ola(const void* xw, const void* nyq, const void* mag, int Kf, void* g, void* frN,
           void* pN, int M, int T, int N, int hop, int K, float mom, void* stream) {
    ola_kernel<<<M, 256, 0, (cudaStream_t)stream>>>(
        (const float*)xw, (const float*)nyq, (const float*)mag, Kf, (__nv_bfloat16*)g,
        (float*)frN, (float*)pN, M, T, N, hop, K, mom);
    return status();
}

int gl_emit(const void* xw, const void* wsic, void* y, int M, int T, int N, int hop,
            int K, int c0, void* stream) {
    emit_kernel<<<M, hop < 1024 ? hop : 1024, 0, (cudaStream_t)stream>>>(
        (const float*)xw, (const float*)wsic, (float*)y, M, T, N, hop, K, c0);
    return status();
}

int gl_unpack(const void* P, const void* frN, void* out, int M, int N, void* stream) {
    unpack_kernel<<<M, 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)P, (const float*)frN, (float2*)out, M, N);
    return status();
}

int gli_synth(const void* Fb, const void* syn, const void* win, void* xw, int M, int N,
              int K2, void* stream) {
    if (int err = set_gemm_smem((const void*)gli_synth_kernel)) return err;
    dim3 grid(N / kBN, (M + kBM - 1) / kBM);
    gli_synth_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)Fb, (const __nv_bfloat16*)syn, (const float*)win, (float*)xw,
        M, N, K2);
    return status();
}

int gli_ola(const void* xw, const void* wsi, const void* win, void* g, int M, int T, int N,
            int hop, int K, void* stream) {
    gli_ola_kernel<<<M, 256, 0, (cudaStream_t)stream>>>(
        (const float*)xw, (const float*)wsi, (const float*)win, (__nv_bfloat16*)g, T, N,
        hop, K);
    return status();
}

int gli_analysis(const void* g, const void* ana, const void* mag, void* Ff, void* Fb,
                 int M, int N, int Kp, void* stream) {
    if (int err = set_gemm_smem((const void*)gli_analysis_kernel)) return err;
    dim3 grid(Kp / 64, (M + kBM - 1) / kBM);
    gli_analysis_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)ana, (const float*)mag, (float*)Ff,
        (__nv_bfloat16*)Fb, M, N, Kp);
    return status();
}

}  // extern "C"
