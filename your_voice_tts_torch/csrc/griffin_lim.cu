// Batched Griffin-Lim for Hopper (sm_90a): the three routes of the
// reference's `dsp.griffin_lim_batch`.
//
// Replaces: your_voice_tts_tpu/ops/pallas/griffin_lim.py
//   - `griffin_lim_pallas_wave` with an injected initial phase
//     (`_kernel_wave_init`: `_gl_loop_packed`, `_banded_ola`, `_emit_wave`):
//     the FGLA loop + the final inverse STFT (`gl_fgla`, wave: synthesis,
//     OLA, analysis an iteration, then a synthesis and the emit);
//   - `griffin_lim_pallas_full` with an injected phase (`_kernel_full_init`):
//     the same FGLA loop, returning the complex spectrum for the caller's
//     istft (`gl_fgla`, full: the loop, then the unpack);
//   - `gl_iteration_pallas` (`_kernel`), driven by `griffin_lim_pallas_batch`:
//     PLAIN Griffin-Lim iterations of the unpacked [T, n_fft/2 + 1]
//     spectrum (`gl_plain`: synthesis, OLA, analysis an iteration on the
//     same engine, with kernel 4's rounding points).
//
// What bounds it on the H100. Each iteration is two [M, N] x [N, N] bf16
// products (M = B * T frames stacked, N = n_fft; 2 M N^2 multiply-adds
// each) around a banded overlap-add: at serving shapes (8 x 500 frames,
// n_fft 1024, 24 iterations) 0.4 TFLOP, 0.42 ms at the tensor cores' peak.
// The loop's working set (P, pP, g in bf16, xw and the magnitudes in f32,
// ~48 MB there) sits in the 50 MB L2, so what the loop pays beyond the
// products is latency: the pipeline's fill, the epilogues' stores and each
// launch's start, 3 launches an iteration.
//
// What the packed loop's design (kernels 2 and 3) does about it:
//   - one C call (`gl_fgla`) issues the whole loop, every launch after the
//     first a programmatic dependent launch: a kernel starts while its
//     predecessor runs and waits (griddepcontrol.wait) only before it reads
//     what the loop writes; the product kernels load their first stages of
//     the constant DFT matrices before that wait;
//   - the products run on wgmma (m64nBNk16, f32 sums in registers): a
//     128 x BN tile a block (BN = 256 where n_fft % 256 == 0, else 128),
//     two consumer warpgroups of 64 rows and one producer warp issuing TMA
//     loads of [128 x 64] and [BN x 64] bf16 tiles (128-byte swizzle) into a
//     ring of 4 stages guarded by mbarriers. The B operands are the
//     K-major copies MwT and Mf; rows past M are zero padding;
//   - the epilogues work from the accumulator registers: the analysis
//     tile holds the real parts of BN/2 bins in its first half and their
//     imaginary parts in the second, so a thread holds both parts of its
//     bins and runs the FGLA update (momentum against pP, rsqrt,
//     re-magnitude) in registers. Their results go through the ring, free
//     once the products are done (the f32 tile, or the four bf16 planes of
//     P and pP), and out as 16-byte rows, the synthesis adding the Nyquist
//     column on the way: stores straight from the accumulator layout touch
//     8 rows an instruction and cost 5-17 us a launch more;
//   - the banded OLA (K = ceil(n_fft/hop) - 1 shifted adds inside each
//     utterance) runs several rows a block, 8 samples a thread with 16-byte
//     loads of the shifted rows where hop % 4 == 0, g stored as bf16 x 8,
//     and the Nyquist channel's projection with its FGLA step reduced
//     without atomics (the same bits every run).
// Rounding points are the TPU kernel's: the loop state P and pP in bf16,
// g = bf16(OLA), magnitudes, the Nyquist channel and all accumulation in
// f32.
//
// Kernel 4 (`gl_plain`) runs on the same engine with its own rounding
// points (the template flag kPlain). No scale is folded into its B
// operands: they are the reference's bf16 DFT entries rearranged, K-major,
// over bins 0 .. N/2 - 1 (synT from [iC ; -iS], anaT from [C | -S]), so
// its products are [M, N] x [N, N] over the real bins alone (its 513 bins
// at n_fft 1024 padded to 576 cost 12.5% more). Its state is the packed
// plane P in bf16 beside the f32 Nyquist channel frN, the real part of
// bin N/2:
//   - synthesis: xw = (P @ syn + bf16(frN) (x) (-1)^n / N) * win: the
//     Nyquist row iC[N/2] joins the sum before the window, as in the
//     reference;
//   - OLA: g = bf16(acc * wsi * win), and the Nyquist projection
//     gn = sum_n g[n] C[n, N/2] over the ROUNDED g, as the reference's
//     dot(bf16 g, bf16 C) reads it; frN = mag_N gn rsqrt(max(gn^2, 1e-30)),
//     no momentum;
//   - analysis: the plain projection m (gr, gi) rsqrt(max(gr^2 + gi^2,
//     1e-30)) in registers, bf16 P out (two planes, staged, 16-byte rows);
//     on the last iteration the f32 spectrum [M, Kf] from the registers
//     instead, column tile 0 adding the Nyquist bin (frN, 0).
// The Nyquist bin's imaginary part is dropped: S[:, N/2] = sin(pi n) is
// ~1e-13 in bf16 and iS[N/2] ~1e-16, so what it adds to gi_N, to xw or to
// the projection lies far below the f32 rounding of the terms kept. Bin
// 0's imaginary part stays in the plane, where S[:, 0] = 0 keeps it 0.

#include <cuda.h>  // CUtensorMap and its enums (cuTensorMapEncodeTiled comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

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

// --- the packed loop's engine (kernels 2, 3 and 4) ------------------------------

constexpr int kGM = 128;           // rows a product tile: two consumer warpgroups of 64
constexpr int kGK = 64;            // k a stage: one 128-byte swizzle row of bf16
constexpr int kGThreads = 288;     // two consumer warpgroups, then one producer warp
constexpr int kStages = 4;         // k-slices in the ring
constexpr uint32_t kATile = kGM * kGK * 2;

// dynamic shared memory of a product launch: 1024-byte alignment slack, the
// A and B rings, a full and an empty mbarrier a stage
constexpr size_t fgla_smem(int bn) {
    return 1024 + (size_t)kStages * (kATile + (size_t)bn * kGK * 2) + 16 * (size_t)kStages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}
// TMA: the box of `map` at (column c0, row c1) into shared memory at `dst`,
// its bytes counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// Programmatic dependent launch: pdl_wait returns once the previous launch
// of the stream has finished and its writes are visible; pdl_release lets
// the next launch start. Both are no-ops in a launch without the attribute.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_release() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// wgmma operand descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle TMA writes (CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups
// 1024 bytes apart; a k16 step inside the row is +32 bytes of `addr`
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// the two consumer warpgroups' own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }
// the accumulators are read only after the wait: the compiler may not move
// their uses above it
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d[64 x BN] (+)= A[64 x 16] B[16 x BN], both K-major in shared memory,
// f32 sums in registers. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 g + 2 (t % 4) (+ 1):
// d[4 g + 2 i + j] is row (+ 8 i), column 8 g + 2 (t % 4) + j.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<128> {
    static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39,"
            "%40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55,"
            "%56, %57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Wgmma<256> {
    static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39,"
            "%40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55,"
            "%56, %57, %58, %59, %60, %61, %62, %63,"
            "%64, %65, %66, %67, %68, %69, %70, %71,"
            "%72, %73, %74, %75, %76, %77, %78, %79,"
            "%80, %81, %82, %83, %84, %85, %86, %87,"
            "%88, %89, %90, %91, %92, %93, %94, %95,"
            "%96, %97, %98, %99, %100, %101, %102, %103,"
            "%104, %105, %106, %107, %108, %109, %110, %111,"
            "%112, %113, %114, %115, %116, %117, %118, %119,"
            "%120, %121, %122, %123, %124, %125, %126, %127"
            "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
              "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
              "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
              "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
              "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
              "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
              "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
              "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
              "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
              "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
              "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
              "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// One product launch of the loop (grid: N / BN column tiles x M_pad / 128
// row tiles). Synthesis: xw = P @ Mw + frN (x) altw over columns
// [BN x, BN x + BN). Analysis: G = g @ MfT over the real parts of bins
// [j0, j0 + BN/2), j0 = BN/2 x, in the tile's first half and their
// imaginary parts (columns N/2 + j0 ..) in its second, then the FGLA update
// of those bins in place. kPlain (kernel 4): the synthesis rounds frN to
// bf16 and applies the window after the sum, xw = (P @ syn + bf16(frN) (x)
// altw) * win; the analysis runs the plain projection without momentum
// (no pP), or, where Fr is set (the last iteration), writes the f32
// spectrum [M, Kf] instead of P.
struct GemmArgs {
    float* xw;
    const float *frN, *altw;  // synthesis
    const float* win;         // kPlain synthesis
    const float* mag;
    bf16 *P, *pP;  // analysis
    float *Fr, *Fi;           // kPlain analysis, last iteration
    float mom;
    int Kf, M, N;
};

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <int BN, bool kAnalysis, bool kPlain>
__global__ void __launch_bounds__(kGThreads, 1)
    fgla_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                     const __grid_constant__ CUtensorMap tmB, const GemmArgs a) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    constexpr uint32_t kBTile = BN * kGK * 2, kStage = kATile + kBTile;
    constexpr int S = kStages;
    const int nk = a.N / kGK, tid = threadIdx.x, row0 = blockIdx.y * kGM;
    const uint32_t sA = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sB = sA + S * kATile, bars = sB + S * kBTile;
    auto full = [&](int s) { return bars + 8u * s; };
    auto empty = [&](int s) { return bars + 8u * (S + s); };
    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 2);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= 256) {  // the producer warp: one thread issues every load
        if (tid == 256) {
            auto load_b = [&](int kt, int s) {
                const uint32_t dst = sB + s * kBTile;
                if constexpr (kAnalysis) {
                    const int j0 = blockIdx.x * (BN / 2);
                    tma_load(dst, &tmB, full(s), kt * kGK, j0);
                    tma_load(dst + kBTile / 2, &tmB, full(s), kt * kGK, a.N / 2 + j0);
                } else {
                    tma_load(dst, &tmB, full(s), kt * kGK, blockIdx.x * BN);
                }
            };
            // the constant matrix's first stages before the wait
            const int pre = nk < S ? nk : S;
            for (int kt = 0; kt < pre; ++kt) {
                mbar_expect_tx(full(kt), kStage);
                load_b(kt, kt);
            }
            pdl_wait();
            for (int kt = 0; kt < pre; ++kt) tma_load(sA + kt * kATile, &tmA, full(kt), kt * kGK, row0);
            for (int kt = pre; kt < nk; ++kt) {
                const int s = kt % S;
                mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
                mbar_expect_tx(full(s), kStage);
                load_b(kt, s);
                tma_load(sA + s * kATile, &tmA, full(s), kt * kGK, row0);
            }
        }
        return;
    }

    // the two consumer warpgroups: rows 64 wg .. 64 wg + 63 of the tile
    pdl_wait();
    pdl_release();
    const int wg = tid >> 7;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        mbar_wait(full(s), (kt / S) & 1);
        const uint32_t at = sA + s * kATile + wg * (64 * 128), bt = sB + s * kBTile;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kGK / 16; ++k)
            Wgmma<BN>::mma(acc, sw128_desc(at + 32 * k), sw128_desc(bt + 32 * k), 1);
        wgmma_commit();
        if (kt > 0) {  // the previous stage's products are done: its slot is free
            wgmma_wait<1>();
            if ((tid & 127) == 0) mbar_arrive(empty((kt - 1) % S));
        }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);

    // Both epilogues stage their results in the ring, free once both
    // warpgroups' products are done, and store them as 16-byte rows: stores
    // straight from the accumulator layout touch 8 rows an instruction and
    // took 5-17 us a launch more on an H100 (PERF.md, probes P1-P2).
    consumer_sync();
    unsigned char* ring = smem_raw + (sA - smem_u32(smem_raw));
    const int lane = tid & 31, q = lane & 3;
    const int rl = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // tile row of acc[.. 2 i ..], + 8 i
    if constexpr (!kAnalysis) {
        // the product tile in f32, row stride BN + 8 (conflict-free float2
        // writes), then xw = tile + frN (x) altw a float4 a thread
        constexpr int kLd = BN + 8, kChunks = BN / 4, kRowStep = 256 / kChunks;
        float* Cs = reinterpret_cast<float*>(ring);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int g = 0; g < BN / 8; ++g)
                *reinterpret_cast<float2*>(Cs + (rl + 8 * i) * kLd + 8 * g + 2 * q) =
                    make_float2(acc[4 * g + 2 * i], acc[4 * g + 2 * i + 1]);
        consumer_sync();
        const int c = tid % kChunks, col = blockIdx.x * BN + 4 * c;
        const float4 w = __ldg(reinterpret_cast<const float4*>(a.altw + col));
        float4 wn = make_float4(1.f, 1.f, 1.f, 1.f);
        if constexpr (kPlain) wn = __ldg(reinterpret_cast<const float4*>(a.win + col));
        for (int r = tid / kChunks; r < kGM && row0 + r < a.M; r += kRowStep) {
            const int row = row0 + r;
            const float4 v = *reinterpret_cast<const float4*>(Cs + r * kLd + 4 * c);
            float fr = __ldg(a.frN + row);
            // kernel 4: the reference rounds every bin of its spectrum to
            // bf16 before the product, the Nyquist bin's too
            if constexpr (kPlain) fr = bf16_round(fr);
            float4 x = make_float4(v.x + fr * w.x, v.y + fr * w.y, v.z + fr * w.z, v.w + fr * w.w);
            if constexpr (kPlain) x = make_float4(x.x * wn.x, x.y * wn.y, x.z * wn.z, x.w * wn.w);
            *reinterpret_cast<float4*>(a.xw + (size_t)row * a.N + col) = x;
        }
    } else if constexpr (kPlain) {
        // kernel 4's projection in registers, in the reference's order:
        // m * gr * inv, inv = rsqrt(max(gr * gr + gi * gi, 1e-30)) with
        // the squares and their sum rounded apart (no fused multiply-add).
        // bf16 P for the next iteration staged as two planes (real and
        // imaginary parts of the tile's bins) and stored a 16-byte chunk a
        // thread; on the last iteration (Fr set) the f32 spectrum instead,
        // from the registers, once a call
        constexpr int kLd = BN / 2 + 8, kRowChunks = BN / 16;
        bf16* S = reinterpret_cast<bf16*>(ring);
        const int half = a.N / 2, j0 = blockIdx.x * (BN / 2), bin0 = j0 + 2 * q;
        const bool last = a.Fr != nullptr;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = row0 + rl + 8 * i;
            if (row >= a.M) continue;
            const float* m = a.mag + (size_t)row * a.Kf;
            // eight bin pairs at a time: their loads in flight together
#pragma unroll
            for (int g0 = 0; g0 < BN / 16; g0 += 8) {
                float m0[8], m1[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int bin = bin0 + 8 * (g0 + u);
                    m0[u] = m[bin];
                    m1[u] = m[bin + 1];
                }
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int g = g0 + u, bin = bin0 + 8 * g;
                    const float gr0 = acc[4 * g + 2 * i], gr1 = acc[4 * g + 2 * i + 1];
                    const float gi0 = acc[4 * (g + BN / 16) + 2 * i];
                    const float gi1 = acc[4 * (g + BN / 16) + 2 * i + 1];
                    const float inv0 = rsqrtf(
                        fmaxf(__fadd_rn(__fmul_rn(gr0, gr0), __fmul_rn(gi0, gi0)), 1e-30f));
                    const float inv1 = rsqrtf(
                        fmaxf(__fadd_rn(__fmul_rn(gr1, gr1), __fmul_rn(gi1, gi1)), 1e-30f));
                    const float r0 = m0[u] * gr0 * inv0, r1 = m1[u] * gr1 * inv1;
                    const float i0 = m0[u] * gi0 * inv0, i1 = m1[u] * gi1 * inv1;
                    if (last) {
                        float* fr = a.Fr + (size_t)row * a.Kf + bin;
                        float* fi = a.Fi + (size_t)row * a.Kf + bin;
                        fr[0] = r0;
                        fr[1] = r1;
                        fi[0] = i0;
                        fi[1] = i1;
                    } else {
                        bf16* at = S + (rl + 8 * i) * kLd + 8 * g + 2 * q;
                        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(r0, r1);
                        *reinterpret_cast<__nv_bfloat162*>(at + kGM * kLd) =
                            __floats2bfloat162_rn(i0, i1);
                    }
                }
            }
        }
        if (last) {
            // the Nyquist bin: its real part from the OLA's channel, its
            // imaginary part dropped (see the header)
            if (blockIdx.x == 0 && tid < kGM && row0 + tid < a.M) {
                const size_t at = (size_t)(row0 + tid) * a.Kf + half;
                a.Fr[at] = a.frN[row0 + tid];
                a.Fi[at] = 0.f;
            }
        } else {
            consumer_sync();
            for (int e = tid; e < 2 * kGM * kRowChunks; e += 256) {
                const int cc = e % kRowChunks, r = (e / kRowChunks) % kGM, plane = e / (kGM * kRowChunks);
                const int row = row0 + r;
                if (row >= a.M) continue;
                bf16* dst = a.P + (size_t)row * a.N + plane * half + j0;
                *reinterpret_cast<uint4*>(dst + 8 * cc) =
                    *reinterpret_cast<const uint4*>(S + (plane * kGM + r) * kLd + 8 * cc);
            }
        }
    } else {
        // the FGLA update in registers, its four bf16 outputs (P and pP,
        // real and imaginary parts of the tile's bins) staged as planes of
        // row stride BN/2 + 8 (conflict-free 4-byte writes), then stored a
        // 16-byte chunk a thread
        constexpr int kLd = BN / 2 + 8, kRowChunks = BN / 16;
        bf16* S = reinterpret_cast<bf16*>(ring);
        const int half = a.N / 2, j0 = blockIdx.x * (BN / 2), bin0 = j0 + 2 * q;
        const float mom = a.mom;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = row0 + rl + 8 * i;
            if (row >= a.M) continue;
            const float* m = a.mag + (size_t)row * a.Kf;
            const bf16* pP = a.pP + (size_t)row * a.N;
            // eight bin pairs at a time: their loads in flight together
#pragma unroll
            for (int g0 = 0; g0 < BN / 16; g0 += 8) {
                __nv_bfloat162 pr[8], pi[8];
                float m0[8], m1[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int bin = bin0 + 8 * (g0 + u);
                    pr[u] = *reinterpret_cast<const __nv_bfloat162*>(pP + bin);
                    pi[u] = *reinterpret_cast<const __nv_bfloat162*>(pP + half + bin);
                    m0[u] = m[bin];
                    m1[u] = m[bin + 1];
                }
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int g = g0 + u;
                    const float2 p_r = __bfloat1622float2(pr[u]), p_i = __bfloat1622float2(pi[u]);
                    const float gr0 = acc[4 * g + 2 * i], gr1 = acc[4 * g + 2 * i + 1];
                    const float gi0 = acc[4 * (g + BN / 16) + 2 * i];
                    const float gi1 = acc[4 * (g + BN / 16) + 2 * i + 1];
                    const float tr0 = gr0 + mom * (gr0 - p_r.x), ti0 = gi0 + mom * (gi0 - p_i.x);
                    const float tr1 = gr1 + mom * (gr1 - p_r.y), ti1 = gi1 + mom * (gi1 - p_i.y);
                    const float inv0 = rsqrtf(fmaxf(tr0 * tr0 + ti0 * ti0, 1e-30f));
                    const float inv1 = rsqrtf(fmaxf(tr1 * tr1 + ti1 * ti1, 1e-30f));
                    bf16* at = S + (rl + 8 * i) * kLd + 8 * g + 2 * q;
                    *reinterpret_cast<__nv_bfloat162*>(at) =
                        __floats2bfloat162_rn(m0[u] * tr0 * inv0, m1[u] * tr1 * inv1);
                    *reinterpret_cast<__nv_bfloat162*>(at + kGM * kLd) =
                        __floats2bfloat162_rn(m0[u] * ti0 * inv0, m1[u] * ti1 * inv1);
                    *reinterpret_cast<__nv_bfloat162*>(at + 2 * kGM * kLd) =
                        __floats2bfloat162_rn(gr0, gr1);
                    *reinterpret_cast<__nv_bfloat162*>(at + 3 * kGM * kLd) =
                        __floats2bfloat162_rn(gi0, gi1);
                }
            }
        }
        consumer_sync();
        for (int e = tid; e < 4 * kGM * kRowChunks; e += 256) {
            const int cc = e % kRowChunks, r = (e / kRowChunks) % kGM, plane = e / (kGM * kRowChunks);
            const int row = row0 + r;
            if (row >= a.M) continue;
            bf16* dst = (plane < 2 ? a.P : a.pP) + (size_t)row * a.N + (plane & 1) * half + j0;
            *reinterpret_cast<uint4*>(dst + 8 * cc) =
                *reinterpret_cast<const uint4*>(S + (plane * kGM + r) * kLd + 8 * cc);
        }
    }
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
}

// overlap-added signal at samples n .. n + 3 of (row, t), hop and n
// multiples of 4: 16-byte loads of the shifted rows, the same adds in the
// same order as ola_at
__device__ __forceinline__ float4 ola4(const float* __restrict__ xw, int row, int t, int T, int N,
                                       int hop, int K, int n) {
    const float* x = xw + (size_t)row * N + n;
    float4 acc = *reinterpret_cast<const float4*>(x);
    for (int k = 1; k <= K; ++k) {
        const int s = k * hop;
        const ptrdiff_t d = (ptrdiff_t)k * N;
        if (n >= s && t + k < T) add4(acc, *reinterpret_cast<const float4*>(x + d - s));
        if (n + s < N && t - k >= 0) add4(acc, *reinterpret_cast<const float4*>(x - d + s));
    }
    return acc;
}

// ola_at at the 8 samples n0 + stride e of (row, t), the shifts outermost
// so that the 8 samples' loads of one shift are in flight together; each
// sample gets the same adds in the same order as ola_at. kTail: samples
// past N may occur (they read 0); without it the compares are left out.
template <bool kTail>
__device__ __forceinline__ void ola8(const float* __restrict__ xw, int row, int t, int T, int N,
                                     int hop, int K, int n0, int stride, float (&acc)[8]) {
    const float* x = xw + (size_t)row * N;
#pragma unroll
    for (int e = 0; e < 8; ++e)
        acc[e] = !kTail || n0 + stride * e < N ? x[n0 + stride * e] : 0.f;
    for (int k = 1; k <= K; ++k) {
        const int s = k * hop;
        const ptrdiff_t d = (ptrdiff_t)k * N;
        const bool fwd = t + k < T, bwd = t - k >= 0;
        float f[8], b[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int n = n0 + stride * e;
            f[e] = fwd && n >= s && (!kTail || n < N) ? x[d + n - s] : 0.f;
            b[e] = bwd && n + s < N ? x[n + s - d] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int n = n0 + stride * e;
            if (fwd && n >= s && (!kTail || n < N)) acc[e] += f[e];
            if (bwd && n + s < N) acc[e] += b[e];
        }
    }
}

// kernel 4's g at 4 samples: bf16(acc * wsi * win), the products in that
// order, held in f32
__device__ __forceinline__ float4 plain_g4(const float4 acc, const float* wsi, const float* win) {
    const float4 s = *reinterpret_cast<const float4*>(wsi);
    const float4 w = *reinterpret_cast<const float4*>(win);
    return make_float4(bf16_round(acc.x * s.x * w.x), bf16_round(acc.y * s.y * w.y),
                       bf16_round(acc.z * s.z * w.z), bf16_round(acc.w * s.w * w.w));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The banded OLA -> g (bf16), `rows` rows a block of `tpr` threads (a
// multiple of 16), 8 samples a thread a pass over 8 tpr samples (one pass
// where N / 8 <= 256): with kVec 8 neighbours (16-byte loads, g stored as
// bf16 x 8), else every tpr-th sample (neighbouring threads on neighbouring
// samples); and the Nyquist channel's projection gn = sum_n acc * nyq with
// its FGLA step and re-magnitude: each thread's passes in order, 16-lane
// sums, then one thread a row adds its row's partials in order. kPlain
// (kernel 4): g = bf16(acc * wsi * win), gn = sum_n g * nyq over the
// rounded g (nyq = C[:, N/2] = +-1), frN = mag_N gn rsqrt(max(gn^2,
// 1e-30)); no momentum, no pN.
template <bool kVec, bool kPlain>
__global__ void __launch_bounds__(256)
    fgla_ola_kernel(const float* __restrict__ xw, const float* __restrict__ nyq,
                    const float* __restrict__ mag, int Kf, bf16* __restrict__ g,
                    float* __restrict__ frN, float* __restrict__ pN, int M, int T, int N, int hop,
                    int K, int tpr, int rows, float mom, const float* __restrict__ wsi,
                    const float* __restrict__ win) {
    __shared__ float red[16];
    const int lr = threadIdx.x / tpr, c = threadIdx.x % tpr;
    const int row = blockIdx.x * rows + lr;
    const bool live = lr < rows && row < M;
    pdl_wait();
    pdl_release();
    float part = 0.f;
    if (live) {
        const int t = row % T;
        bf16* out = g + (size_t)row * N;
        for (int base = 0; base < N; base += 8 * tpr) {
            if constexpr (kVec) {
                const int n = base + 8 * c;
                if (n >= N) break;
                float4 lo = ola4(xw, row, t, T, N, hop, K, n);
                float4 hi = ola4(xw, row, t, T, N, hop, K, n + 4);
                const float4 w0 = *reinterpret_cast<const float4*>(nyq + n);
                const float4 w1 = *reinterpret_cast<const float4*>(nyq + n + 4);
                if constexpr (kPlain) {
                    lo = plain_g4(lo, wsi + n, win + n);
                    hi = plain_g4(hi, wsi + n + 4, win + n + 4);
                }
                part += lo.x * w0.x + lo.y * w0.y + lo.z * w0.z + lo.w * w0.w + hi.x * w1.x +
                        hi.y * w1.y + hi.z * w1.z + hi.w * w1.w;
                *reinterpret_cast<uint4*>(out + n) =
                    make_uint4(bf16x2(lo.x, lo.y), bf16x2(lo.z, lo.w), bf16x2(hi.x, hi.y),
                               bf16x2(hi.z, hi.w));
            } else {
                // a pass past N only where N / 8 > 256 and tpr does not divide it
                const bool whole = base + 8 * tpr <= N;
                float acc[8];
                if (whole)
                    ola8<false>(xw, row, t, T, N, hop, K, base + c, tpr, acc);
                else
                    ola8<true>(xw, row, t, T, N, hop, K, base + c, tpr, acc);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int n = base + c + e * tpr;
                    if (!whole && n >= N) break;
                    if constexpr (kPlain) acc[e] = bf16_round(acc[e] * wsi[n] * win[n]);
                    part += acc[e] * nyq[n];
                    out[n] = __float2bfloat16_rn(acc[e]);
                }
            }
        }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if ((threadIdx.x & 15) == 0) red[threadIdx.x >> 4] = part;
    __syncthreads();
    if (live && c == 0) {
        float gn = 0.f;
        for (int i = 0; i < tpr / 16; ++i) gn += red[threadIdx.x / 16 + i];
        if constexpr (kPlain) {
            frN[row] = mag[(size_t)row * Kf + N / 2] * gn * rsqrtf(fmaxf(gn * gn, 1e-30f));
            return;
        }
        const float tn = gn + mom * (gn - pN[row]);
        const float inv = rsqrtf(fmaxf(tn * tn, 1e-30f));
        frN[row] = mag[(size_t)row * Kf + N / 2] * tn * inv;
        pN[row] = gn;
    }
}

// The final synthesis' waveform samples: OLA columns [c0, c0 + hop) * wsic,
// c0 = N/2 - hop, `rows` rows a block of `tpr` threads (with kVec 4
// neighbouring samples a thread, else every tpr-th)
template <bool kVec>
__global__ void __launch_bounds__(256)
    fgla_emit_kernel(const float* __restrict__ xw, const float* __restrict__ wsic,
                     float* __restrict__ y, int M, int T, int N, int hop, int K, int tpr,
                     int rows) {
    const int lr = threadIdx.x / tpr, c = threadIdx.x % tpr;
    const int row = blockIdx.x * rows + lr;
    pdl_wait();
    pdl_release();
    if (lr >= rows || row >= M) return;
    float* out = y + (size_t)row * hop;
    const int c0 = N / 2 - hop;
    if constexpr (kVec) {
        for (int j = 4 * c; j < hop; j += 4 * tpr) {
            const float4 v = ola4(xw, row, row % T, T, N, hop, K, c0 + j);
            const float4 w = *reinterpret_cast<const float4*>(wsic + j);
            *reinterpret_cast<float4*>(out + j) =
                make_float4(v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
        }
    } else {
        for (int k = c; k < hop; k += tpr)
            out[k] = ola_at(xw, row, row % T, T, N, hop, K, c0 + k) * wsic[k];
    }
}

// The complex spectrum of the loop's state as interleaved (re, im), `rows`
// rows a block of `tpr` threads, two bins a thread a pass over 2 tpr bins:
// bins j < N/2 from the plane's halves, the Nyquist bin from its own real
// channel with a zero imaginary part
__global__ void __launch_bounds__(512)
    fgla_unpack_kernel(const bf16* __restrict__ P, const float* __restrict__ frN,
                       float2* __restrict__ out, int M, int N, int tpr, int rows) {
    const int half = N / 2, lr = threadIdx.x / tpr, c = threadIdx.x % tpr;
    const int row = blockIdx.x * rows + lr;
    pdl_wait();
    pdl_release();
    if (lr >= rows || row >= M) return;
    float2* o = out + (size_t)row * (half + 1);
    for (int j = 2 * c; j < half; j += 2 * tpr) {
        const bf16* p = P + (size_t)row * N + j;
        const float2 re = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
        const float2 im = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + half));
        o[j] = make_float2(re.x, im.x);
        o[j + 1] = make_float2(re.y, im.y);
    }
    if (c == 0) o[half] = make_float2(frN[row], 0.f);
}

int status() { return (int)cudaGetLastError(); }

// --- the packed loop's host side ----------------------------------------------

// error codes past cudaError_t's: cuTensorMapEncodeTiled was not found, or
// refused a map (kEncodeFailed + its CUresult)
constexpr int kNoEncoder = 1000, kEncodeFailed = 2000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: the library links
// no -lcuda
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a row-major bf16 [rows, cols] matrix as TMA boxes of [box_rows, 64] in the
// 128-byte swizzle
int encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (!fn) return kNoEncoder;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
    const cuuint32_t box[2] = {(cuuint32_t)kGK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// A launch of `kernel` that, with `pdl`, may start while the previous
// launch of the stream runs (it waits in pdl_wait). A refused launch
// returns its error.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, bool pdl,
           cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    return status();
}

// An element-wise launch of the launch plan: `tpr` threads a row, `rows`
// rows a block, `threads` a block, `blocks` blocks.
struct Rows {
    int tpr, rows, threads, blocks;
};

// The packed loop's arguments (ctypes mirror: ops/griffin_lim.py `_Fgla`).
// P, pP and g are [M_pad, N] bf16 with zero rows past M; xw [M, N] and
// mag [M, Kf] f32; frN, pN [M]; MwT, Mf [N, N] bf16 (the products' B
// operands, K-major); out: the waveform columns [M, hop] (wave) or the
// complex spectrum [M, Kf] (full). The launch geometry is the launch
// plan's (`fgla_plan`), launched as given: the products' tile width bn,
// grid, threads and shared memory, and the OLA, emit and unpack launches;
// serial: launches without the programmatic dependence. `launches` is
// written back: the launches issued.
struct Fgla {
    int M, M_pad, T, N, hop, K, Kf, n_iters, wave, serial;
    int bn, grid_x, grid_y, threads, smem;
    Rows ola, emit, unpack;
    float mom;
    void *P, *pP, *frN, *pN, *xw, *g;
    const void *mag, *MwT, *Mf, *nyq, *altw, *wsic;
    void* out;
    void* stream;
    int launches;
};

// The product launches' tensor maps: the A operands P and g ([M_pad, N]
// bf16) in boxes of 128 rows, the K-major B operands ([N, N] bf16) in boxes
// of BN rows (synthesis) and BN/2 rows (analysis: two boxes a stage).
struct Maps {
    CUtensorMap P, g, syn, ana;
};

// The maps of one loop, and its two product kernels' shared memory
template <int BN, bool kPlain>
int prepare(Maps& m, const void* P, const void* g, const void* syn, const void* ana, int M_pad,
            int N, int smem) {
    if (int e = encode(&m.P, P, M_pad, N, kGM)) return e;
    if (int e = encode(&m.g, g, M_pad, N, kGM)) return e;
    if (int e = encode(&m.syn, syn, N, N, BN)) return e;
    if (int e = encode(&m.ana, ana, N, N, BN / 2)) return e;
    for (const void* fn : {(const void*)fgla_gemm_kernel<BN, false, kPlain>,
                           (const void*)fgla_gemm_kernel<BN, true, kPlain>})
        if (cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem))
            return (int)e;
    return 0;
}

// The whole loop on `stream`: n_iters x (synthesis, OLA, analysis), then a
// synthesis and the emit (wave) or the unpack (full); the first launch an
// ordinary one, every later one dependent. Counts the launches issued in
// f.launches and returns the first error.
template <int BN>
int fgla_run(Fgla& f) {
    Maps mp;
    if (int e = prepare<BN, false>(mp, f.P, f.g, f.MwT, f.Mf, f.M_pad, f.N, f.smem)) return e;
    void (*synth)(CUtensorMap, CUtensorMap, GemmArgs) = fgla_gemm_kernel<BN, false, false>;
    void (*analysis)(CUtensorMap, CUtensorMap, GemmArgs) = fgla_gemm_kernel<BN, true, false>;
    const cudaStream_t st = (cudaStream_t)f.stream;
    GemmArgs ga = {};
    ga.xw = (float*)f.xw;
    ga.frN = (const float*)f.frN;
    ga.altw = (const float*)f.altw;
    ga.mag = (const float*)f.mag;
    ga.P = (bf16*)f.P;
    ga.pP = (bf16*)f.pP;
    ga.mom = f.mom;
    ga.Kf = f.Kf;
    ga.M = f.M;
    ga.N = f.N;
    const dim3 grid(f.grid_x, f.grid_y);
    const bool vec = f.hop % 4 == 0;
    auto issue = [&](auto kernel, dim3 blocks, int threads, size_t smem, auto... args) {
        const int e = launch(kernel, blocks, threads, smem, !f.serial && f.launches > 0, st,
                             args...);
        if (e == 0) ++f.launches;
        return e;
    };
    auto synthesis = [&]() { return issue(synth, grid, f.threads, f.smem, mp.P, mp.syn, ga); };
    for (int it = 0; it < f.n_iters; ++it) {
        if (int e = synthesis()) return e;
        if (int e = issue(vec ? fgla_ola_kernel<true, false> : fgla_ola_kernel<false, false>,
                          dim3(f.ola.blocks), f.ola.threads, 0, (const float*)f.xw,
                          (const float*)f.nyq, (const float*)f.mag, f.Kf, (bf16*)f.g,
                          (float*)f.frN, (float*)f.pN, f.M, f.T, f.N, f.hop, f.K, f.ola.tpr,
                          f.ola.rows, f.mom, (const float*)nullptr, (const float*)nullptr))
            return e;
        if (int e = issue(analysis, grid, f.threads, f.smem, mp.g, mp.ana, ga)) return e;
    }
    if (f.wave) {
        if (int e = synthesis()) return e;
        return issue(vec ? fgla_emit_kernel<true> : fgla_emit_kernel<false>, dim3(f.emit.blocks),
                     f.emit.threads, 0, (const float*)f.xw, (const float*)f.wsic, (float*)f.out,
                     f.M, f.T, f.N, f.hop, f.K, f.emit.tpr, f.emit.rows);
    }
    return issue(fgla_unpack_kernel, dim3(f.unpack.blocks), f.unpack.threads, 0,
                 (const bf16*)f.P, (const float*)f.frN, (float2*)f.out, f.M, f.N, f.unpack.tpr,
                 f.unpack.rows);
}

// Kernel 4's arguments (ctypes mirror: ops/griffin_lim.py `_Gli`). P and g
// are [M_pad, N] bf16 with zero rows past M (P: the packed spectrum, the
// real parts of bins 0 .. N/2 - 1, then their imaginary parts); frN [M]
// the Nyquist bin's real part, f32; xw [M, N] and mag [M, Kf] f32; synT,
// anaT [N, N] bf16 (the products' B operands, K-major); nyq_syn =
// iC[N/2] = (-1)^n / N and nyq_ana = C[:, N/2] = (-1)^n, win and wsi [N]
// f32; Fr, Fi [M, Kf] f32, the spectrum after the last iteration. The
// launch geometry is the launch plan's (`gl_iteration_plan`), launched as
// given; serial: launches without the programmatic dependence. `launches`
// is written back: the launches issued.
struct Gli {
    int M, M_pad, T, N, hop, K, Kf, n_iters, serial;
    int bn, grid_x, grid_y, threads, smem;
    Rows ola;
    void *P, *frN, *xw, *g;
    const void *mag, *synT, *anaT, *nyq_syn, *nyq_ana, *win, *wsi;
    void *Fr, *Fi;
    void* stream;
    int launches;
};

// Kernel 4's loop on `stream`: n_iters x (synthesis, OLA, analysis), the
// last analysis writing the f32 spectrum; the first launch an ordinary
// one, every later one dependent. Counts the launches issued in f.launches
// and returns the first error.
template <int BN>
int gli_run(Gli& f) {
    Maps mp;
    if (int e = prepare<BN, true>(mp, f.P, f.g, f.synT, f.anaT, f.M_pad, f.N, f.smem)) return e;
    GemmArgs ga = {};
    ga.xw = (float*)f.xw;
    ga.frN = (const float*)f.frN;
    ga.altw = (const float*)f.nyq_syn;
    ga.win = (const float*)f.win;
    ga.mag = (const float*)f.mag;
    ga.P = (bf16*)f.P;
    ga.Kf = f.Kf;
    ga.M = f.M;
    ga.N = f.N;
    GemmArgs last = ga;
    last.Fr = (float*)f.Fr;
    last.Fi = (float*)f.Fi;
    const cudaStream_t st = (cudaStream_t)f.stream;
    const dim3 grid(f.grid_x, f.grid_y);
    auto issue = [&](auto kernel, dim3 blocks, int threads, size_t smem, auto... args) {
        const int e = launch(kernel, blocks, threads, smem, !f.serial && f.launches > 0, st,
                             args...);
        if (e == 0) ++f.launches;
        return e;
    };
    for (int it = 0; it < f.n_iters; ++it) {
        if (int e = issue(fgla_gemm_kernel<BN, false, true>, grid, f.threads, f.smem, mp.P,
                          mp.syn, ga))
            return e;
        if (int e = issue(f.hop % 4 == 0 ? fgla_ola_kernel<true, true>
                                         : fgla_ola_kernel<false, true>,
                          dim3(f.ola.blocks), f.ola.threads, 0, (const float*)f.xw,
                          (const float*)f.nyq_ana, (const float*)f.mag, f.Kf, (bf16*)f.g,
                          (float*)f.frN, (float*)nullptr, f.M, f.T, f.N, f.hop, f.K, f.ola.tpr,
                          f.ola.rows, 0.f, (const float*)f.wsi, (const float*)f.win))
            return e;
        if (int e = issue(fgla_gemm_kernel<BN, true, true>, grid, f.threads, f.smem, mp.g,
                          mp.ana, it + 1 < f.n_iters ? ga : last))
            return e;
    }
    return 0;
}

// whether an element-wise launch covers M rows of tpr threads
bool covers(const Rows& r, int M) {
    return r.tpr > 0 && r.rows * r.tpr <= r.threads && r.rows * r.blocks >= M;
}

// whether a plan's products and OLA fit the kernels: tiles of 128 or 256
// columns covering N, row tiles of 128 covering M_pad >= M, the kernel's
// threads and shared memory; the OLA in whole 16-lane groups of at most
// 256 threads a block, covering M rows
bool plan_fits(int bn, int grid_x, int grid_y, int N, int M, int M_pad, int threads, int smem,
               const Rows& ola) {
    return (bn == 128 || bn == 256) && grid_x * bn == N && grid_y * kGM == M_pad && M <= M_pad &&
           threads == kGThreads && smem == (int)fgla_smem(bn) && ola.tpr % 16 == 0 &&
           ola.threads % 32 == 0 && ola.threads <= 256 && covers(ola, M);
}

}  // namespace

extern "C" {

// The packed FGLA loop of kernels 2 and 3 in one call on an `Fgla`.
// Returns 0, a cudaError_t (cudaErrorInvalidValue for a plan that does not
// fit the kernels), or an encoder error from kNoEncoder up.
int gl_fgla(void* args) {
    Fgla& f = *static_cast<Fgla*>(args);
    f.launches = 0;
    const bool fits = plan_fits(f.bn, f.grid_x, f.grid_y, f.N, f.M, f.M_pad, f.threads, f.smem,
                                f.ola) &&
                      covers(f.emit, f.M) && covers(f.unpack, f.M);
    if (!fits) return (int)cudaErrorInvalidValue;
    return f.bn == 256 ? fgla_run<256>(f) : fgla_run<128>(f);
}

// Kernel 4, n_iters plain Griffin-Lim iterations in one call on a `Gli`:
// 3 n_iters launches, none where n_iters = 0. Returns 0, a cudaError_t (cudaErrorInvalidValue for a plan that does not
// fit the kernels), or an encoder error from kNoEncoder up.
int gl_plain(void* args) {
    Gli& f = *static_cast<Gli*>(args);
    f.launches = 0;
    const bool fits = plan_fits(f.bn, f.grid_x, f.grid_y, f.N, f.M, f.M_pad, f.threads, f.smem,
                                f.ola) &&
                      f.Kf == f.N / 2 + 1 && f.n_iters >= 0;
    if (!fits) return (int)cudaErrorInvalidValue;
    return f.bn == 256 ? gli_run<256>(f) : gli_run<128>(f);
}

}  // extern "C"
