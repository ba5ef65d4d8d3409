// Tacotron(1) free-running decode, one persistent cooperative launch with
// every weight resident in shared memory, for Hopper (sm_90a).
//
// Replaces: your_voice_tts_tpu/ops/pallas/taco1_decode.py
//           `tacotron1_decode_pallas` (its `_kernel` / `_gru`): the whole
//           decode loop as one Pallas launch with every weight in VMEM and
//           the early exit checked once a chunk.
//
// What bounds it on the H100: each step is a chain of dependent batched
// matrix-vector products (B <= a few dozen rows) over ~1.72M bf16 weights
// at full width (3.44 MB: the memory-queue prenet, the attention GRU, the
// query, the projection, two residual GRUs, the mel projection with the
// folded stop row), plus the attention over T encoder frames. The weights
// are not the bound: spread over the grid they fit shared memory (~26 KB a
// block on 132 blocks) and stay there. What is left is latency: the grid
// barriers between the chain's links (~1.3 us each) and every serial trip
// to L2 on the chain (~1 us each: the stage inputs other blocks just
// wrote, the attention's state).
//
// What this design does about it:
// - ONE cooperative launch runs the whole decode (the parent's seven host
//   launches a step are gone); blocks of 512 threads, at most one an SM,
//   all co-resident; the early exit is checked on the device at chunk
//   boundaries. A batch whose tiles do not fit shared memory is cut by the
//   wrapper into slices of whole batch tiles, a launch each (`row0` keeps
//   the dropout's batch row index).
// - Each step is ten rounds separated by grid.sync(). The chain queue ->
//   x1 -> x -> ah -> pq -> e -> ctx -> xd0 -> xd1 -> xd2 -> frame moves one
//   link a round:
//     R1  the prenet's first layer over the queue (dropout salt 21); the
//         location features of every block's (row, t) pairs;
//     R2  its second layer (salt 22) -> x;
//     R3  the attention GRU's product over x, its cell update -> ah;
//     R4  the query q_w ah; off the chain: W_h ah (next step's) and the
//         projection's ah columns;
//     R5  energies, one warp a (row, t) pair;
//     R6  the norm over T; the context [B, E] in 8-column chunks spread
//         over the blocks; alignments, att and cum;
//     R7  the projection's ctx columns -> xd0; off the chain: the attention
//         GRU's ctx columns (next step's);
//     R8  d1's product over xd0, its cell update -> h1, xd1 = xd0 + h1;
//     R9  d2's product over xd1 -> h2, xd2 = xd1 + h2; off the chain: d1's
//         W_h h1 (next step's);
//     R10 the mel projection and the folded stop row over xd2: frames,
//         stops, the done latch, the queue; off the chain: d2's W_h h2.
//   The products off the chain run on blocks idle in that round, where
//   their input is staged anyway; the state starts at zero, so the first
//   step's share of them is zero and no prologue is needed.
// - Weights are resident: the wrapper packs each block's row tiles of
//   every matrix (ops/taco1_decode.py `pack_weights`) into one contiguous
//   region, which the block copies into shared memory once, at the start;
//   no weight byte moves inside the step loop. Each matrix's unit groups
//   (a 16-row tile, or a GRU's 16 units as three tiles, one a gate) are
//   dealt one a block, the matrices one after another around the grid, so
//   at full width on 132 SMs every block holds exactly one group. A GRU's
//   input and hidden matrices go to the same block, which keeps the
//   hidden part of its gates, its biases and its units' state in shared
//   memory (n = tanh(gx_n + r gh_n) needs the two parts apart).
// - Products run on the tensor cores: mma.sync.m16n8k16 on
//   fragment-ordered tiles (16 weight rows x 8 batch rows x 16 columns,
//   f32 accumulation); a warp takes (row tile, k-slice) items, each item's
//   sums go to a slot of its own and the block adds the slots in a fixed
//   order: the same inputs give the same bits.
// - Stage inputs are kept in global memory as bf16 (the residual sums also
//   as f32) and copied with 16-byte cp.async.cg into the blocks that take
//   part in a round, once a round; a GRU block's f32 residual units travel
//   with the same copies and R10 reads the done mask while they fly, so a
//   round makes one serial trip to L2. The W_k m rows of a block's (row, t)
//   pairs stay in its shared memory where they fit, so the location
//   features make one trip too. Data other blocks wrote is read through L2
//   (__ldcg, cp.async.cg), never a stale L1 line.
//
// Probe launches: the same kernel with every part of a step left out but
// the barriers (the floor), or but the stage-input copies, or but the
// products, for the per-part breakdown; and a profiling instantiation that
// serves and times each round on the SMs' clocks. The serving
// instantiation has none of these branches.
//
// Numerics follow the Pallas kernel: matrix inputs rounded to bf16, f32
// accumulation, f32 GRU state, residual sums, attention state, alignments
// and outputs; dropout from the hash PRNG of hash_prng.cuh (salts 21 and
// 22, element index row * width + col).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "decode_common.cuh"
#include "hash_prng.cuh"
#include "taco2_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBarriers = 10;         // grid barriers a step

// Probe bits: what a probe launch keeps of every step; kProfile serves and
// times every round.
enum { kServe = 0, kBarriersOnly = 1, kCopiesOnly = 2, kDotsOnly = 3, kProfile = 4 };
constexpr int kRounds = kBarriers;

// Matrices, in the order of a block's resident region (ops/taco1_decode.py
// MATRICES), and products, in the order of `Params::ks` (PRODUCTS).
enum { kAX, kAH, kD1X, kD1H, kD2X, kD2H, kP1, kP2, kQ, kPJ, kM, kNumMats };
enum { kR1P1, kR2P2, kR3AX, kR4Q, kR4AH, kR4PJ, kR7PJ, kR7AX, kR8D1X, kR9D2X, kR9D1H, kR10M,
       kR10D2H, kNumProducts };

struct Params {
    const uint4* wres;                                        // [G][RES][32] packed tiles
    const float* bres;                                        // [G][BRES] their biases
    const bf16* u;                                            // [2, K, A] location filter
    const float* v_w;                                         // [A]
    const bf16* enc;                                          // [B, T, E16]
    const float *pinp, *maskadd;                              // [B, T, A], [B, T]
    bf16 *queue, *x1, *x, *ah, *ctx, *xd0, *xd1, *h1, *xd2, *h2;  // [B, width16]; queue [2, B, NQ16]
    float *xd0f, *xd1f, *att, *cum, *done, *pq, *e;           // done [2, B], pq [B, A], e [B, T]
    float *out, *aligns, *stops;                              // [S, B, OW], [S, B, T], [S, B]
    int* ran;
    float* prof;                                              // [G, 10, 2] (kProfile)
    int B, T, NT, NM, NQ, NQ16, NMr, P1, P116, P2, P216, H, H16, E16, D, D16, A, K, OW;
    int steps, chunk, softmax, dropout, row0;                 // row0: batch row of row 0
    int XLD, ALN, CPB, PPB, SLOTS, RES, BRES, ACC, HU, PIN_SMEM;
    int mt[kNumMats], mg[kNumMats], mk[kNumMats], mb[kNumMats];  // tiles, tiles a group,
                                                                 // k-tiles, first block
    int ks[kNumProducts];
    float v_b, thresh;
    uint32_t seed;
};

// Shared memory of a block (the fields the attention parts of
// decode_common.cuh read, and the staged tile and item slots).
struct Smem {
    bf16* xs;                                  // [kTile][XLD] staged batch tile
    float *us, *vw;                            // [2, K, A] location filter, [A] v
    float* slot;                               // [SLOTS][16][8] an item's sums
    float* pre;                                // [PPB][A] W_k m + location
    const float* pin;                          // [PPB][A] W_k m of its pairs (shared
                                               // memory where it fits, else pinp's rows)
    float* res;                                // [units][NT * 8][16] a residual's units
    float* dn;                                 // [NT * 8] the done mask (R10)
    float* aln;                                // [ALN][T] normalized alignments
    float* cum;                                // [ALN][T] cum of the rows it writes
    float* xw;                                 // [kNW][2][K rounded up to 32] location windows
};

// This block's share of a matrix: its row tiles' k-tiles in shared memory
// (tile j's k-tile k at w[(j * nkt + k) * 32]), their biases (16 a tile),
// their accumulators ([tiles][NT][16][8]), and its place `o` in the order
// the matrix's groups are dealt in: local tile j is the matrix's row tile
// grp * (o + (j / grp) * G) + j % grp.
struct Mat {
    const uint4* w;
    const float* bias;
    float* acc;
    int tiles, o, grp, nkt;
};

// A product over a column segment of a matrix: k-tiles wkt .. wkt + nk
// against columns xcol .. of the staged tile, each item ks k-slices.
struct Prod {
    Mat m;
    int wkt, nk, xcol, ks;
};

__device__ __forceinline__ int row_tile(const Mat m, int j) {
    return m.grp * (m.o + (j / m.grp) * (int)gridDim.x) + j % m.grp;
}

// Item (local row tile j, k-tile slice kk) of a product on the staged
// batch tile: the A fragments from the resident tiles (one 16-byte shared
// load a lane a k-tile), one mma.sync a k-tile, the 16 x 8 sums stored in
// the item's slot.
__device__ void dot_item(const Prod pr, const bf16* xs, int xld, int j, int kk, float* slot) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int per = (pr.nk + pr.ks - 1) / pr.ks;
    const int k0 = kk * per, k1 = min(pr.nk, k0 + per);
    const uint4* af = pr.m.w + ((size_t)j * pr.m.nkt + pr.wkt) * 32 + lane;
    const bf16* xb = xs + g * xld + pr.xcol + 2 * q;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
        const bf16* xk = xb + 16 * k;
        mma16816(d, af[(size_t)k * 32], *reinterpret_cast<const uint32_t*>(xk),
                 *reinterpret_cast<const uint32_t*>(xk + 8));
    }
    *reinterpret_cast<float2*>(slot + g * kTile + 2 * q) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(slot + (g + 8) * kTile + 2 * q) = make_float2(d[2], d[3]);
}

// One round's products (npr of p0, p1, p2) over every batch tile, on a
// block that owns tiles of any of them (others return at once): stage the
// tile's inputs [s0 | s1], run `mid` once while the first tile's copies
// are in flight, then the products' items over the warps of the block
// (item it -> slot it), then the slots of each row tile summed in slice
// order into its accumulator (no atomics).
template <int PR, typename Mid>
__device__ void run_products(const Params& p, const Smem& s, Src s0, Src s1, Prod p0, Prod p1,
                             Prod p2, int npr, Mid mid) {
    const int t0 = p0.m.tiles, t1 = npr > 1 ? p1.m.tiles : 0, t2 = npr > 2 ? p2.m.tiles : 0;
    if (t0 + t1 + t2 == 0) return;                     // block-uniform
    const int n0 = t0 * p0.ks, n1 = n0 + t1 * p1.ks, total = n1 + t2 * p2.ks;
    const int warp = threadIdx.x >> 5;
    for (int tile = 0; tile < p.NT; ++tile) {
        if (PR != kDotsOnly) stage_tile(s.xs, p.XLD, tile, p.B, s0, s1, {nullptr, 0});
        if (tile == 0) mid();
        cp_async_wait_all();
        __syncthreads();
        if (PR != kCopiesOnly) {
            for (int it = warp; it < total; it += kNW) {
                const int i = it < n0 ? 0 : it < n1 ? 1 : 2;
                const Prod pr = i == 0 ? p0 : i == 1 ? p1 : p2;
                const int k = it - (i == 0 ? 0 : i == 1 ? n0 : n1);
                dot_item(pr, s.xs, p.XLD, k / pr.ks, k % pr.ks, s.slot + it * kAcc);
            }
            __syncthreads();
            for (int e = threadIdx.x; e < (t0 + t1 + t2) * kAcc; e += blockDim.x) {
                const int i = e < t0 * kAcc ? 0 : e < (t0 + t1) * kAcc ? 1 : 2;
                const Prod pr = i == 0 ? p0 : i == 1 ? p1 : p2;
                const int r = e - (i == 0 ? 0 : i == 1 ? t0 : t0 + t1) * kAcc;
                const int j = r / kAcc, l = r % kAcc;
                const float* sl = s.slot + ((i == 0 ? 0 : i == 1 ? n0 : n1) + j * pr.ks) * kAcc + l;
                float v = 0.f;
                for (int kk = 0; kk < pr.ks; ++kk) v += sl[kk * kAcc];
                pr.m.acc[((size_t)j * p.NT + tile) * kAcc + l] += v;
            }
        }
        __syncthreads();
    }
}

// Epilogue of a matrix's rows [0, N): fn(row, b, sum + bias); the
// accumulators are cleared.
template <typename Fn>
__device__ void rows_epilogue(const Params& p, const Mat m, int N, Fn fn) {
    for (int idx = threadIdx.x; idx < m.tiles * p.NT * kAcc; idx += blockDim.x) {
        const int j = idx / (p.NT * kAcc), tile = (idx / kAcc) % p.NT, l = idx % kAcc;
        const int row = kRows * row_tile(m, j) + l / kTile, b = tile * kTile + l % kTile;
        const float v = m.acc[idx] + m.bias[j * kRows + l / kTile];
        m.acc[idx] = 0.f;
        if (row < N && b < p.B) fn(row, b, v);
    }
}

// Start copying the f32 residual input res [B, H16] of this block's unit
// groups of a GRU (mx) into s.res [units][NT * 8][16], 16 bytes at a time;
// the round's wait covers it.
__device__ void stage_residual(const Params& p, const Smem& s, const Mat mx, const float* res,
                               int H16) {
    const int ng = mx.tiles / 3;
    for (int c = threadIdx.x; c < ng * p.B * 4; c += blockDim.x) {
        const int jg = c / (p.B * 4), b = (c / 4) % p.B, v = c % 4;
        const int n0 = kRows * (mx.o + jg * (int)gridDim.x);
        cp_async16(s.res + ((size_t)jg * p.NT * kTile + b) * kRows + 4 * v,
                   res + (size_t)b * H16 + n0 + 4 * v);
    }
}

// GRU cell update of this block's unit groups (torch gate order r, z, n):
// gx from the input matrix's accumulators, gh from the hidden one's, each
// with its bias; h (f32, in shared memory hs [units][NT * 8]) and its bf16
// copy hb [B, H16]. With `res`, the residual sum of h and the staged
// s.res goes to resf [B, H16] (f32, when given) and resb (bf16). Both
// accumulators are cleared.
__device__ void gru_epilogue(const Params& p, const Smem& s, const Mat mx, const Mat mh,
                             float* hs, int H, int H16, bf16* hb, bool res, float* resf,
                             bf16* resb) {
    const int ng = mx.tiles / 3, gs = p.NT * kAcc;
    for (int idx = threadIdx.x; idx < ng * gs; idx += blockDim.x) {
        const int jg = idx / gs, rem = idx - jg * gs, tile = rem / kAcc, l = rem % kAcc;
        const int u = l / kTile, b = tile * kTile + l % kTile;
        const int n = kRows * (mx.o + jg * (int)gridDim.x) + u;
        float* ax = mx.acc + ((size_t)3 * jg * p.NT + tile) * kAcc + l;
        float* ah = mh.acc + ((size_t)3 * jg * p.NT + tile) * kAcc + l;
        const float* bx = mx.bias + 3 * jg * kRows + u;
        const float* bh = mh.bias + 3 * jg * kRows + u;
        float gx[3], gh[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
            gx[g] = ax[g * gs] + bx[g * kRows];
            gh[g] = ah[g * gs] + bh[g * kRows];
            ax[g * gs] = 0.f;
            ah[g * gs] = 0.f;
        }
        if (n >= H || b >= p.B) continue;
        float* hp = hs + (size_t)(jg * kRows + u) * p.NT * kTile + b;
        const float r = sigmoidf_(gx[0] + gh[0]), z = sigmoidf_(gx[1] + gh[1]);
        const float nn = tanhf(gx[2] + r * gh[2]);
        const float h = (1.f - z) * nn + z * *hp;
        *hp = h;
        hb[(size_t)b * H16 + n] = __float2bfloat16_rn(h);
        if (res) {
            const float v = s.res[((size_t)jg * p.NT * kTile + b) * kRows + u] + h;
            if (resf) resf[(size_t)b * H16 + n] = v;
            resb[(size_t)b * H16 + n] = __float2bfloat16_rn(v);
        }
    }
}

template <int PR>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::grid_group grid = cg::this_grid();
    Smem s;
    unsigned char* q = smem;
    auto take = [&](size_t count, size_t unit) {
        unsigned char* at = q;
        q += (count * unit + 15) / 16 * 16;
        return at;
    };
    uint4* wres = reinterpret_cast<uint4*>(take((size_t)p.RES * 32, 16));
    s.xs = reinterpret_cast<bf16*>(take((size_t)kTile * p.XLD, 2));
    s.us = reinterpret_cast<float*>(take((size_t)2 * p.K * p.A, 4));
    s.vw = reinterpret_cast<float*>(take(p.A, 4));
    float* acc = reinterpret_cast<float*>(take((size_t)p.ACC * p.NT * kAcc, 4));
    s.slot = reinterpret_cast<float*>(take((size_t)p.SLOTS * kAcc, 4));
    float* bres = reinterpret_cast<float*>(take(p.BRES, 4));
    float* hst = reinterpret_cast<float*>(take((size_t)p.HU * p.NT * kTile, 4));
    s.aln = reinterpret_cast<float*>(take((size_t)p.ALN * p.T, 4));
    s.cum = reinterpret_cast<float*>(take((size_t)p.ALN * p.T, 4));
    s.xw = reinterpret_cast<float*>(take((size_t)kNW * 2 * ((p.K + 31) / 32 * 32), 4));
    s.pre = reinterpret_cast<float*>(take((size_t)p.PPB * p.A, 4));
    s.res = reinterpret_cast<float*>(take((size_t)p.HU * p.NT * kTile, 4));
    s.dn = reinterpret_cast<float*>(take((size_t)p.NT * kTile, 4));
    float* pin = p.PIN_SMEM ? reinterpret_cast<float*>(take((size_t)p.PPB * p.A, 4)) : nullptr;

    // this block's share of every matrix, in the order of its region
    const int G = gridDim.x;
    Mat m[kNumMats];
    int nw = 0, nb = 0, na = 0;
#pragma unroll
    for (int i = 0; i < kNumMats; ++i) {
        const int o = ((int)blockIdx.x - p.mb[i] + G) % G, ng = p.mt[i] / p.mg[i];
        const int t = o < ng ? (ng - o + G - 1) / G * p.mg[i] : 0;
        m[i] = Mat{wres + (size_t)nw * 32, bres + nb, acc + (size_t)na * p.NT * kAcc, t, o,
                   p.mg[i], p.mk[i]};
        nw += t * p.mk[i];
        nb += t * kRows;
        na += t;
    }
    // the resident weights and biases, once; zero accumulators and states
    const uint4* wsrc = p.wres + (size_t)blockIdx.x * p.RES * 32;
    for (int c = threadIdx.x; c < nw * 32; c += blockDim.x) cp_async16(wres + c, wsrc + c);
    for (int i = threadIdx.x; i < nb; i += blockDim.x) bres[i] = p.bres[(size_t)blockIdx.x * p.BRES + i];
    for (int i = threadIdx.x; i < 2 * p.K * p.A; i += blockDim.x)
        s.us[i] = __bfloat162float(p.u[i]);
    for (int i = threadIdx.x; i < p.A; i += blockDim.x) s.vw[i] = p.v_w[i];
    for (size_t i = threadIdx.x; i < (size_t)na * p.NT * kAcc; i += blockDim.x) acc[i] = 0.f;
    for (int i = threadIdx.x; i < p.HU * p.NT * kTile; i += blockDim.x) hst[i] = 0.f;
    const int pair0 = (int)blockIdx.x * p.PPB;
    const int npin = max(0, min(p.B * p.T - pair0, p.PPB)) * p.A;
    s.pin = p.pinp + (size_t)pair0 * p.A;
    if (pin) {
        for (int i = threadIdx.x; i < npin; i += blockDim.x) pin[i] = s.pin[i];
        s.pin = pin;
    }
    load_cum(p, s);
    cp_async_wait_all();
    __syncthreads();
    float* hs_a = hst;                                 // units of the attention GRU here
    float* hs_1 = hs_a + (size_t)m[kAX].tiles / 3 * kRows * p.NT * kTile;
    float* hs_2 = hs_1 + (size_t)m[kD1X].tiles / 3 * kRows * p.NT * kTile;

    const int NQk = p.NQ16 / 16, P1k = p.P116 / 16, P2k = p.P216 / 16, Hk = p.H16 / 16;
    const int Ek = p.E16 / 16, Dk = p.D16 / 16;
    const Prod pP1{m[kP1], 0, NQk, 0, p.ks[kR1P1]};
    const Prod pP2{m[kP2], 0, P1k, 0, p.ks[kR2P2]};
    const Prod pAXx{m[kAX], 0, P2k, 0, p.ks[kR3AX]};
    const Prod pQ{m[kQ], 0, Hk, 0, p.ks[kR4Q]};
    const Prod pAH{m[kAH], 0, Hk, 0, p.ks[kR4AH]};
    const Prod pPJa{m[kPJ], 0, Hk, 0, p.ks[kR4PJ]};
    const Prod pPJc{m[kPJ], Hk, Ek, 0, p.ks[kR7PJ]};
    const Prod pAXc{m[kAX], P2k, Ek, 0, p.ks[kR7AX]};
    const Prod pD1X{m[kD1X], 0, Dk, 0, p.ks[kR8D1X]};
    const Prod pD2X{m[kD2X], 0, Dk, 0, p.ks[kR9D2X]};
    const Prod pD1H{m[kD1H], 0, Dk, p.D16, p.ks[kR9D1H]};
    const Prod pM{m[kM], 0, Dk, 0, p.ks[kR10M]};
    const Prod pD2H{m[kD2H], 0, Dk, p.D16, p.ks[kR10D2H]};
    const Src none{nullptr, 0};
    auto nothing = [] {};
    constexpr bool work = PR == kServe || PR == kProfile;
    constexpr bool prof = PR == kProfile;
    long long t_work[kRounds] = {}, t_wait[kRounds] = {}, t_mark = 0;
    // kProfile: the block's work in a round (to its last thread), then its
    // wait at the barrier, in SM cycles summed over the steps
    auto done_work = [&](int r) {
        if (!prof) return;
        __syncthreads();
        const long long t = clock64();
        t_work[r] += t - t_mark;
        t_mark = t;
    };
    auto sync = [&](int r) {
        done_work(r);
        grid.sync();
        if (!prof) return;
        const long long t = clock64();
        t_wait[r] += t - t_mark;
        t_mark = t;
    };

    grid.sync();
    if (prof) t_mark = clock64();
    int step = 0;
    for (; step < p.steps; ++step) {
        if (PR == kBarriersOnly) {
            for (int i = 0; i < kBarriers; ++i) grid.sync();
            continue;
        }
        const int cur = step & 1;
        const float* done_in = p.done + (size_t)cur * p.B;
        float* done_out = p.done + (size_t)(cur ^ 1) * p.B;
        const bf16* q_in = p.queue + (size_t)cur * p.B * p.NQ16;
        bf16* q_out = p.queue + (size_t)(cur ^ 1) * p.B * p.NQ16;
        if (work && step > 0 && step % p.chunk == 0) {
            bool all = true;
            for (int b = threadIdx.x; b < p.B; b += blockDim.x)
                all = all && __ldcg(done_in + b) > 0.f;
            if (__syncthreads_and(all)) break;        // the same in every block
        }
        const uint32_t key = hash_step_key(p.seed, (uint32_t)step);
        auto prenet = [&](uint32_t salt, int width, int ld, bf16* dst) {
            return [&, salt, width, ld, dst](int row, int b, float v) {
                v = fmaxf(v, 0.f);
                if (p.dropout)
                    v = hash_uniform((uint32_t)((p.row0 + b) * width + row), key, salt) < 0.5f
                            ? 0.f : v * 2.f;
                dst[(size_t)b * ld + row] = __float2bfloat16_rn(v);
            };
        };
        // R1: the prenet's first layer; the location features of this step
        run_products<PR>(p, s, {q_in, p.NQ16}, none, pP1, pP1, pP1, 1, nothing);
        if (work) {
            location<true>(p, s);
            rows_epilogue(p, m[kP1], p.P1, prenet(21u, p.P1, p.P116, p.x1));
        }
        sync(0);
        // R2: its second layer
        run_products<PR>(p, s, {p.x1, p.P116}, none, pP2, pP2, pP2, 1, nothing);
        if (work) rows_epilogue(p, m[kP2], p.P2, prenet(22u, p.P2, p.P216, p.x));
        sync(1);
        // R3: the attention GRU
        run_products<PR>(p, s, {p.x, p.P216}, none, pAXx, pAXx, pAXx, 1, nothing);
        if (work)
            gru_epilogue(p, s, m[kAX], m[kAH], hs_a, p.H, p.H16, p.ah, false, nullptr, nullptr);
        sync(2);
        // R4: the query; W_h ah and the projection's ah columns
        run_products<PR>(p, s, {p.ah, p.H16}, none, pQ, pAH, pPJa, 3, nothing);
        if (work)
            rows_epilogue(p, m[kQ], p.A, [&](int row, int b, float v) {
                p.pq[(size_t)b * p.A + row] = v;
            });
        sync(3);
        // R5: energies
        if (work) energies(p, s);
        sync(4);
        // R6: norm and context
        if (work) context(p, s, step);
        sync(5);
        // R7: the projection -> xd0; the attention GRU's ctx columns
        run_products<PR>(p, s, {p.ctx, p.E16}, none, pPJc, pAXc, pAXc, 2, nothing);
        if (work)
            rows_epilogue(p, m[kPJ], p.D, [&](int row, int b, float v) {
                p.xd0f[(size_t)b * p.D16 + row] = v;
                p.xd0[(size_t)b * p.D16 + row] = __float2bfloat16_rn(v);
            });
        sync(6);
        // R8: d1, xd1 = xd0 + h1
        run_products<PR>(p, s, {p.xd0, p.D16}, none, pD1X, pD1X, pD1X, 1, [&] {
            if (work) stage_residual(p, s, m[kD1X], p.xd0f, p.D16);
        });
        if (work)
            gru_epilogue(p, s, m[kD1X], m[kD1H], hs_1, p.D, p.D16, p.h1, true, p.xd1f, p.xd1);
        sync(7);
        // R9: d2, xd2 = xd1 + h2; d1's W_h h1
        run_products<PR>(p, s, {p.xd1, p.D16}, {p.h1, p.D16}, pD2X, pD1H, pD1H, 2, [&] {
            if (work) stage_residual(p, s, m[kD2X], p.xd1f, p.D16);
        });
        if (work)
            gru_epilogue(p, s, m[kD2X], m[kD2H], hs_2, p.D, p.D16, p.h2, true, nullptr, p.xd2);
        sync(8);
        // R10: frames, stops, the done latch and the queue; d2's W_h h2
        run_products<PR>(p, s, {p.xd2, p.D16}, {p.h2, p.D16}, pM, pD2H, pD2H, 2, [&] {
            if (work && m[kM].tiles)                   // the done mask, while the copies fly
                for (int b = threadIdx.x; b < p.B; b += blockDim.x) s.dn[b] = __ldcg(done_in + b);
        });
        if (work) {
            // the queue keeps the last NQ values of [queue | frames [0, NMr)]
            const int keep = p.NQ > p.NMr ? p.NQ - p.NMr : 0;
            const unsigned short* qi = reinterpret_cast<const unsigned short*>(q_in);
            unsigned short* qo = reinterpret_cast<unsigned short*>(q_out);
            for (int i = (int)(blockIdx.x * blockDim.x + threadIdx.x); i < p.B * keep;
                 i += G * (int)blockDim.x) {
                const int b = i / keep, c = i - b * keep;
                qo[(size_t)b * p.NQ16 + c] = __ldcg(qi + (size_t)b * p.NQ16 + p.NMr + c);
            }
            rows_epilogue(p, m[kM], p.OW + 1, [&](int row, int b, float v) {
                const float dn = s.dn[b];
                if (row < p.OW) {
                    const float o = v * (1.f - dn);
                    p.out[((size_t)step * p.B + b) * p.OW + row] = o;
                    const int c = p.NQ - p.NMr + row;
                    if (row < p.NMr && c >= 0)
                        q_out[(size_t)b * p.NQ16 + c] = __float2bfloat16_rn(o);
                } else {
                    const float pr = sigmoidf_(v);
                    p.stops[(size_t)step * p.B + b] = pr;
                    done_out[b] = fmaxf(dn, pr > p.thresh ? 1.f : 0.f);
                }
            });
        }
        sync(9);
    }
    if (prof && threadIdx.x == 0)
        for (int r = 0; r < kRounds; ++r) {
            p.prof[((size_t)blockIdx.x * kRounds + r) * 2] = (float)t_work[r];
            p.prof[((size_t)blockIdx.x * kRounds + r) * 2 + 1] = (float)t_wait[r];
        }
    if (blockIdx.x == 0 && threadIdx.x == 0) *p.ran = step;
}

template <int PR>
const void* kernel_of() { return reinterpret_cast<const void*>(decode_kernel<PR>); }

const void* kernel_for(int probe) {
    switch (probe) {
        case kBarriersOnly: return kernel_of<kBarriersOnly>();
        case kCopiesOnly: return kernel_of<kCopiesOnly>();
        case kDotsOnly: return kernel_of<kDotsOnly>();
        case kProfile: return kernel_of<kProfile>();
        default: return kernel_of<kServe>();
    }
}

int occupancy(const void* kernel, int smem, int* blocks_per_sm) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                              (size_t)smem);
}

}  // namespace

extern "C" {

// ptrs: wres, bres, u, v_w, enc, pinp, maskadd, queue, x1, x, ah, ctx, xd0,
// xd1, h1, xd2, h2, xd0f, xd1f, att, cum, done, pq, e, out, aligns, stops,
// ran, prof. dims: the launch plan (ops/taco1_decode.py `_DIMS` order), the
// eleven matrices' row tiles, tiles a group, k-tiles and first block (each
// in MATRICES order), the thirteen products' k-tile slices, blocks, shared
// memory bytes. fl: v_b, thresh. probe: 0 serves, 1 keeps only the
// barriers, 2 only the stage-input copies, 3 only the products, 4 serves
// and writes each block's cycles a round (work, then barrier wait) to prof
// [G, 10, 2] (null for the other launches). Returns a cudaError_t, or -1
// when the grid cannot be co-resident.
int taco1_decode(const void* const* ptrs, const int* dims, const float* fl, unsigned int seed,
                 void* stream, int probe) {
    if (probe < kServe || probe > kProfile) return (int)cudaErrorInvalidValue;
    Params p{};
    p.wres = static_cast<const uint4*>(ptrs[0]);
    p.bres = static_cast<const float*>(ptrs[1]);
    p.u = static_cast<const bf16*>(ptrs[2]);
    p.v_w = static_cast<const float*>(ptrs[3]);
    p.enc = static_cast<const bf16*>(ptrs[4]);
    p.pinp = static_cast<const float*>(ptrs[5]);
    p.maskadd = static_cast<const float*>(ptrs[6]);
    bf16** sb[] = {&p.queue, &p.x1, &p.x, &p.ah, &p.ctx, &p.xd0, &p.xd1, &p.h1, &p.xd2, &p.h2};
    for (int i = 0; i < 10; ++i) *sb[i] = static_cast<bf16*>(const_cast<void*>(ptrs[7 + i]));
    float** sf[] = {&p.xd0f, &p.xd1f, &p.att, &p.cum, &p.done, &p.pq, &p.e, &p.out,
                    &p.aligns, &p.stops};
    for (int i = 0; i < 10; ++i) *sf[i] = static_cast<float*>(const_cast<void*>(ptrs[17 + i]));
    p.ran = static_cast<int*>(const_cast<void*>(ptrs[27]));
    p.prof = static_cast<float*>(const_cast<void*>(ptrs[28]));
    int* di[] = {&p.B, &p.T, &p.NT, &p.NM, &p.NQ, &p.NQ16, &p.NMr, &p.P1, &p.P116, &p.P2,
                 &p.P216, &p.H, &p.H16, &p.E16, &p.D, &p.D16, &p.A, &p.K, &p.OW, &p.steps,
                 &p.chunk, &p.softmax, &p.dropout, &p.row0, &p.XLD, &p.ALN, &p.CPB, &p.PPB,
                 &p.SLOTS, &p.RES, &p.BRES, &p.ACC, &p.HU, &p.PIN_SMEM};
    constexpr int nd = sizeof(di) / sizeof(di[0]);
    for (int i = 0; i < nd; ++i) *di[i] = dims[i];
    int at = nd;
    for (int i = 0; i < kNumMats; ++i) p.mt[i] = dims[at++];
    for (int i = 0; i < kNumMats; ++i) p.mg[i] = dims[at++];
    for (int i = 0; i < kNumMats; ++i) p.mk[i] = dims[at++];
    for (int i = 0; i < kNumMats; ++i) p.mb[i] = dims[at++];
    for (int i = 0; i < kNumProducts; ++i) p.ks[i] = dims[at++];
    const int blocks = dims[at], smem = dims[at + 1];
    p.v_b = fl[0];
    p.thresh = fl[1];
    p.seed = seed;
    if (p.K < 1 || p.B < 1 || p.chunk < 1 || (probe == kProfile && !p.prof))
        return (int)cudaErrorInvalidValue;
    const void* kernel = kernel_for(probe);
    int per_sm = 0, e;
    if ((e = occupancy(kernel, smem, &per_sm)) != 0) return e;
    int dev = 0, sms = 0;
    if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
    if ((e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
        return e;
    if (per_sm < 1 || blocks > per_sm * sms) return -1;
    void* args[] = {&p};
    e = (int)cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                         (size_t)smem, static_cast<cudaStream_t>(stream));
    if (e != 0) return e;
    return (int)cudaGetLastError();
}

}  // extern "C"
