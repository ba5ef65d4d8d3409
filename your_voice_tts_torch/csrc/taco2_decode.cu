// Tacotron2 free-running decode, one persistent cooperative launch, for
// Hopper (sm_90a).
//
// Replaces: your_voice_tts_tpu/ops/pallas/taco2_decode.py
//           `tacotron2_decode_pallas` (its `_kernel` / `_lstm`): the whole
//           decode loop as one Pallas launch with every weight in VMEM and
//           the early exit checked once a chunk.
//
// What bounds it on the H100: each step is a chain of dependent batched
// matrix-vector products (B <= a few dozen rows) over ~19M bf16 weights
// (37.9 MB at full width, which stay in the 50 MB L2), plus the attention
// over T encoder frames. Read once, the weights bound a 250-step decode at
// ~0.16 ms; read from L2 every step they take ~7 us a step at L2's rate.
// Beyond that the step is latency-bound: the grid barriers between its
// dependent stages (~1.3 us each), and every serial trip to L2 on the
// chain (~1 us each: the stage inputs other blocks just wrote, weights,
// the attention's state).
//
// What this design does about it:
// - ONE cooperative launch runs the whole decode (the parent's five host
//   launches a step are gone); the grid is one block of 512 threads per
//   SM, all co-resident; the early exit is checked on the device. A batch
//   whose tiles do not fit shared memory is cut by the wrapper into
//   slices of whole batch tiles, a launch each (`row0` keeps the dropout's
//   batch row index).
// - Each step is seven rounds separated by grid.sync(). The chain frame ->
//   x -> h1 -> pq -> e -> ctx -> h2 -> frame moves one link a round:
//     R1 the prenet, both layers with the hash-PRNG dropout, on the blocks
//        that own its second layer's tiles: each computes the whole first
//        layer (80 columns) itself, so x1 never leaves it;
//     R2 the attention LSTM's product over x, its cell update -> h1;
//     R3 the query q_w h1; the decoder LSTM's product over h1;
//     R4 energies, one warp a (row, t) pair; a_w over h1 (next step's);
//     R5 the norm over T; the context [B, E] in 8-column chunks spread over
//        the blocks; alignments, att and cum;
//     R6 d_w over ctx, its cell update -> h2; the projection over ctx;
//        a_w over ctx (next step's);
//     R7 the projection over h2 and the folded stop row: frames, stops,
//        the done latch, the fed-back frame; d_w over h2 (next step's);
//        the location features of the next step.
//   The LSTM products that are not on the chain run where their input is
//   already staged, so no round waits on more than one short product; a
//   prologue computes them for the initial state.
// - Stream state (the Pallas kernel's `stream=` / `return_stream`): the
//   initial h1, c1, h2, c2 and fed-back frame come from the wrapper's
//   buffers, zeros or a previous text chunk's final state (h and the frame
//   as bf16, the only form any product reads them in; c in f32), while
//   attention and context start at zero. At the end the cell states go back
//   to their buffers and, where asked, the hiddens' f32 values to h1f /
//   h2f; an early exit leaves them as at the all-done chunk boundary.
// - Products run on the tensor cores: mma.sync.m16n8k16 (16 weight rows x
//   8 batch rows x 16 columns, f32 accumulation). pack_weights stores each
//   matrix in the A operand's register order, so a lane loads a 16 x 16
//   tile's fragment as one 16-byte vector. Row tiles are dealt to blocks
//   (tile t -> block t % G; the small matrices, prenet, query and
//   projection, from the last block down, where the LSTMs leave blocks
//   with a tile fewer; the prenet's first layer whole to each block of its
//   second), so an LSTM unit's cell state stays in one block's shared
//   memory for the launch. A warp takes (row tile, k-slice) items;
//   each item's sums go to a slot of its own and the block adds the slots
//   in a fixed order: the same inputs give the same bits.
// - Weights never wait on the chain: during each round the block copies
//   the next product round's weight tiles into shared memory (cp.async),
//   so they land during the epilogue and the barrier; a round that does
//   not fit the buffer (a large batch, a card with fewer SMs) reads its
//   tiles from L2 instead.
// - Stage inputs are kept in global memory as bf16, the only form any
//   product reads them in, and copied into every block with 16-byte
//   cp.async.cg once a round. Data other blocks wrote is read through L2
//   (__ldcg, cp.async.cg), never a stale L1 line. Biases, cell states,
//   the location features of a block's (row, t) pairs and the cum rows it
//   writes stay in its shared memory.
//
// - The attention variants of the Pallas kernel are the kernel's second
//   template parameter, so that the location route's instantiation stays
//   as it was: kOptions serves windowing, forward attention, the
//   transition agent and the forward mask (runtime flags within it), and
//   kGraves the GMM attention. Both add no round:
//     windowing: the norm of a row in R5 takes the energies outside the
//        window as -1e9, and then the row's next centre, the first
//        maximum of the final alignment;
//     forward attention: the alpha recursion, the forward mask and the
//        second norm run in R5 after the norm over T;
//     transition agent: u = sigmoid(ta . [ctx_prev | h1] + b), a warp a
//        row beside R4's energies (both inputs are final since R2 / R5);
//     Graves: l1 over h1 takes the query product's place in R3 (its
//        epilogue writes tanh(l1 h1 + b) as bf16, the only form l2 reads);
//        l2 over it runs in R4 beside a_w over h1, on the staged
//        [h1 | qg]; the mixture over T replaces the norm in R5. No W_k m,
//        energies or location features.
//   A row's norm in R5 runs, one warp each, on every block whose context
//   chunks touch the row, from the same inputs: each keeps the row's
//   attention state (alpha, the window's centre, Graves's means) in its
//   own shared memory, bit for bit the same in every such block, so no
//   state goes through global memory and none races.
//
// Probe launches: the same kernel with every part of a step left out but
// the barriers (the floor), or but the stage-input copies, or but the
// products (weight copies and mma), for the per-part breakdown; and a
// profiling instantiation that serves and times each round on the SMs'
// clocks. The serving instantiation has none of these branches.
//
// Numerics follow the Pallas kernel: matrix inputs rounded to bf16, f32
// accumulation, f32 cell state, attention state, alignments and outputs;
// dropout from the hash PRNG of hash_prng.cuh (salts 11 and 12, element
// index row * P + col).

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

constexpr int kBarriers = 7;          // grid barriers a step

// Probe bits: what a probe launch keeps of every step; kProfile serves and
// times every round.
enum { kServe = 0, kBarriersOnly = 1, kCopiesOnly = 2, kDotsOnly = 3, kProfile = 4 };
constexpr int kRounds = kBarriers;

// How a matrix's row tiles are dealt to the blocks: from block 0 up, from
// the last block down, or every tile to every block that takes part.
enum { kDealUp = 0, kDealDown = 1, kDealAll = 2 };

// Products, in the order of `Params::ks`: the round and the input (kG2:
// Graves's l2, R4).
enum { kP1, kP2, kA2, kQ, kD3, kA4, kD6, kO6, kA6, kO7, kD7, kG2, kNumProducts };

// Attention routes: location-sensitive attention alone, with its options
// (windowing, forward attention, transition agent, forward mask), Graves.
enum { kLocation = 0, kOptions = 1, kGraves = 2 };
constexpr int kMaxGK = 32;            // Graves's components: one a lane

struct Params {
    const bf16 *p1, *p2, *a, *q, *d, *o, *u;                 // packed weights
    const float *p1_b, *p2_b, *a_b, *d_b, *o_b, *v_w;         // f32 vectors
    const bf16* enc;                                          // [B, T, E16]
    const float *pinp, *maskadd;                              // [B, T, A], [B, T]
    bf16 *frame, *x1, *x, *h1, *h2, *ctx;                     // [B, width16]
    float *c1, *c2, *att, *cum, *done;                        // done [2, B]
    float *pq, *e, *pre;                                      // [B, A], [B, T], [B, T, A]
    float *out, *aligns, *stops;                              // [S, B, OW], [S, B, T], [S, B]
    int* ran;
    float* prof;                                              // [G, 7, 2] (kProfile)
    float *h1f, *h2f;                                         // [B, H] f32 stream out, or null
    const bf16* ta;                                           // [E16 + H116] transition agent
    const float* g1_b;                                        // [Q16] Graves's l1 bias
    const bf16* g2;                                           // packed l2 [3K -> 16, Q16]
    const float* g2_b;                                        // [16] its bias
    float* uta;                                               // [B] the agent's u
    bf16* qg;                                                 // [B, H116] tanh(l1 h1 + b)
    float* gbk;                                               // [B, 3K] l2's output
    int B, T, NT, NM, NM16, P, P16, E16, H1, H116, H2, H216, A, K, OW, r;
    int KA, KD, KO;                                           // k-tiles of a, d, o
    int steps, chunk, softmax, dropout;
    int row0;                                                 // batch row of row 0 (dropout)
    int XLD, X2LD, ALN, CPB, PPB, GA, GD, GO, GP, GQ, SLOTS, WBUF, WB_ROUNDS, PRE_SMEM;
    int ks[kNumProducts];
    int windowing, win_back, win_front, fwd, ta_on, fmask, GK;  // the attention's options
    float v_b, thresh, ta_b;
    uint32_t seed;
};

// Shared memory of a block.
struct Smem {
    bf16* xs;                                  // [kTile][XLD] staged batch tile
    float *us, *vw;                            // [2, K, A] location filter, [A] v
    float *acc_a, *acc_d, *acc_o, *acc_1;      // [row tiles][NT][16][8] accumulators
    bf16* xs2;                                 // [kTile][X2LD] prenet layer 1's output
    float* slot;                               // [SLOTS][16][8] an item's sums
    uint4* wbuf;                               // [WBUF k-tiles][32] a round's weights
    float* pre;                                // [PPB][A] W_k m + location (or null)
    float *ba, *bd, *bo, *bp1, *bp2;           // biases of this block's row tiles
                                               // (bp1: every row of layer 1)
    float *ca, *cd;                            // cell states of its units [units][NT * 8]
    float* aln;                                // [ALN][T] normalized alignments
    float* cum;                                // [ALN][T] cum of the rows it writes
    float* xw;                                 // [kNW][2][K rounded up to 32] location windows
    float* alpha;                              // [ALN][T] forward attention's alpha (kOptions)
    int* wctr;                                 // [ALN] the windows' centres (kOptions)
    float* mu;                                 // [ALN][kMaxGK] Graves's means (kGraves)
};

// A product over a column segment of a packed matrix (fragment order,
// [row tiles][nkt][32][8]): k-tiles wkt .. wkt + nk of W against columns
// xcol .. of the staged tile, over the matrix's `tiles` row tiles; this
// block's tiles of it lie in the weight buffer from k-tile `wbase`, or, at
// wbase -1, are read from global memory (L2). The LSTMs' tiles go to the
// blocks from block 0 up, the small products' from the last block down,
// where the LSTMs leave blocks with a tile fewer; the prenet's first layer
// goes whole to each block of its second.
struct Prod {
    const bf16* W;
    int nkt, wkt, xcol, nk, tiles, ks, wbase, deal;
    float* acc;
};

// This block's place in the order tiles are dealt in.
__device__ __forceinline__ int owner(int deal) {
    return deal == kDealDown ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
}

// Tiles of `tiles` this block owns: tile_of(j) for j < tiles_here.
__device__ __forceinline__ int tiles_here(int tiles, int deal = kDealUp) {
    if (deal == kDealAll) return tiles;
    const int b = owner(deal), G = gridDim.x;
    return b < tiles ? (tiles - b + G - 1) / G : 0;
}

__device__ __forceinline__ int tile_of(int j, int deal = kDealUp) {
    return deal == kDealAll ? j : owner(deal) + j * (int)gridDim.x;
}

// Start copying this block's row tiles of a round's products into the
// weight buffer (product 0's tiles, then product 1's, then 2's; a tile's
// k-tiles in order), 16 bytes a lane a k-tile; the round's first wait
// covers them.
__device__ void fetch_weights(uint4* wbuf, Prod a, Prod b, Prod c, int npr) {
    for (int i = 0; i < npr; ++i) {
        const Prod pr = i == 0 ? a : i == 1 ? b : c;
        if (pr.wbase < 0) continue;
        const int n = tiles_here(pr.tiles, pr.deal) * pr.nk * 32;
        for (int c = threadIdx.x; c < n; c += blockDim.x) {
            const int lane = c & 31, jk = c >> 5, j = jk / pr.nk, k = jk - j * pr.nk;
            const int rt = tile_of(j, pr.deal);
            cp_async16(wbuf + (size_t)(pr.wbase + jk) * 32 + lane,
                       pr.W + (((size_t)rt * pr.nkt + pr.wkt + k) * 32 + lane) * 8);
        }
    }
}

// Item (local row tile j, k-tile slice kk) of a product on the staged
// batch tile: the A fragments from the weight buffer or from L2 (one
// 16-byte load a lane a k-tile), one mma.sync a k-tile, the 16 x 8 sums
// stored in the item's slot.
__device__ void dot_item(const Prod pr, const uint4* wbuf, const bf16* xs, int xld, int j,
                         int kk, float* slot) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int per = (pr.nk + pr.ks - 1) / pr.ks;
    const int k0 = kk * per, k1 = min(pr.nk, k0 + per);
    const uint4* af = pr.wbase >= 0
        ? wbuf + (size_t)(pr.wbase + j * pr.nk) * 32 + lane
        : reinterpret_cast<const uint4*>(pr.W)
              + ((size_t)tile_of(j, pr.deal) * pr.nkt + pr.wkt) * 32 + lane;
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

// One round's products over every batch tile: stage the tile's inputs,
// run `mid` once while the first tile's copies are in flight, then the
// products' items over the warps of the block (item it -> slot it), then
// the slots of each row tile summed in slice order into its accumulator
// (no atomics: the same inputs give the same bits).
template <int PR, typename Mid>
__device__ void run_products(const Params& p, const Smem& s, Src s0, Src s1, Src s2, Prod p0,
                             Prod p1, Prod p2, int npr, Mid mid) {
    const int t0 = tiles_here(p0.tiles, p0.deal);
    const int t1 = npr > 1 ? tiles_here(p1.tiles, p1.deal) : 0;
    const int t2 = npr > 2 ? tiles_here(p2.tiles, p2.deal) : 0;
    const int n0 = t0 * p0.ks, n1 = n0 + t1 * p1.ks, total = n1 + t2 * p2.ks;
    const int warp = threadIdx.x >> 5;
    for (int tile = 0; tile < p.NT; ++tile) {
        if (PR != kDotsOnly) stage_tile(s.xs, p.XLD, tile, p.B, s0, s1, s2);
        if (tile == 0) mid();
        cp_async_wait_all();                       // the inputs, and the weights
        __syncthreads();
        if (PR != kCopiesOnly) {
            for (int it = warp; it < total; it += kNW) {
                const int i = it < n0 ? 0 : it < n1 ? 1 : 2;
                const Prod pr = i == 0 ? p0 : i == 1 ? p1 : p2;
                const int k = it - (i == 0 ? 0 : i == 1 ? n0 : n1);
                dot_item(pr, s.wbuf, s.xs, p.XLD, k / pr.ks, k % pr.ks, s.slot + it * kAcc);
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
                pr.acc[((size_t)j * p.NT + tile) * kAcc + l] += v;
            }
        }
        __syncthreads();
    }
}

// R1, the prenet, on the blocks that own row tiles of its second layer:
// per batch tile, the first layer over every row (its tiles are small, so
// each such block computes them all and x1 never leaves it) into xs2
// through the dropout of salt 11, then this block's tiles of the second
// layer over xs2. Other blocks have no work in this round.
template <int PR>
__device__ void prenet_round(const Params& p, const Smem& s, Prod p1, Prod p2, uint32_t key) {
    const int t2 = tiles_here(p2.tiles, p2.deal);
    if (t2 == 0) return;                               // block-uniform
    const int warp = threadIdx.x >> 5;
    const int n1 = p1.tiles * p1.ks, n2 = t2 * p2.ks;
    for (int tile = 0; tile < p.NT; ++tile) {
        if (PR != kDotsOnly) stage_tile(s.xs, p.XLD, tile, p.B, {p.frame, p.NM16}, {nullptr, 0},
                                        {nullptr, 0});
        cp_async_wait_all();
        __syncthreads();
        if (PR == kCopiesOnly) {
            __syncthreads();
            continue;
        }
        for (int it = warp; it < n1; it += kNW)
            dot_item(p1, s.wbuf, s.xs, p.XLD, it / p1.ks, it % p1.ks, s.slot + it * kAcc);
        __syncthreads();
        for (int e = threadIdx.x; e < p1.tiles * kAcc; e += blockDim.x) {
            const int j = e / kAcc, l = e % kAcc;
            const float* sl = s.slot + j * p1.ks * kAcc + l;
            float v = 0.f;
            for (int kk = 0; kk < p1.ks; ++kk) v += sl[kk * kAcc];
            const int row = kRows * j + l / kTile, bb = l % kTile, b = tile * kTile + bb;
            if (row < p.P) {
                v = fmaxf(v + s.bp1[row], 0.f);
                if (p.dropout)
                    v = hash_uniform((uint32_t)((p.row0 + b) * p.P + row), key, 11u) < 0.5f
                            ? 0.f : v * 2.f;
                s.xs2[bb * p.X2LD + row] = __float2bfloat16_rn(v);
            }
        }
        __syncthreads();
        for (int it = warp; it < n2; it += kNW)
            dot_item(p2, s.wbuf, s.xs2, p.X2LD, it / p2.ks, it % p2.ks, s.slot + it * kAcc);
        __syncthreads();
        for (int e = threadIdx.x; e < t2 * kAcc; e += blockDim.x) {
            const int j = e / kAcc, l = e % kAcc;
            const float* sl = s.slot + j * p2.ks * kAcc + l;
            float v = 0.f;
            for (int kk = 0; kk < p2.ks; ++kk) v += sl[kk * kAcc];
            p2.acc[((size_t)j * p.NT + tile) * kAcc + l] += v;
        }
        __syncthreads();
    }
}

// Copy this block's rows of a bias vector (padded to whole row tiles) into
// shared memory.
__device__ void load_bias(float* dst, const float* bias, int tiles, int deal) {
    const int ng = tiles_here(tiles, deal);
    for (int i = threadIdx.x; i < ng * kRows; i += blockDim.x)
        dst[i] = bias[tile_of(i / kRows, deal) * kRows + i % kRows];
}

// Between global [B, H] and this block's units' cell states [units][NT * 8]
// (unit n = 4 * row tile + u), for the launch's start and end.
template <bool kLoad>
__device__ void move_cells(float* cs, float* c, int H, const Params& p) {
    const int ng = tiles_here((4 * H + kRows - 1) / kRows), G = gridDim.x, W = p.NT * kTile;
    for (int i = threadIdx.x; i < ng * 4 * W; i += blockDim.x) {
        const int ju = i / W, b = i - ju * W;
        const int n = ((int)blockIdx.x + (ju / 4) * G) * 4 + ju % 4;
        if (n >= H || b >= p.B) continue;
        if (kLoad) cs[i] = c[(size_t)b * H + n];
        else c[(size_t)b * H + n] = cs[i];
    }
}

// LSTM cell update from the accumulated gates of this block's units (a row
// tile holds 4 units' interleaved i, f, g, o): c in shared memory, h as
// bf16 into hb [B, H16] and, for a stream, as f32 into hf [B, H] (null
// without one); the accumulators are cleared.
__device__ void lstm_epilogue(const Params& p, float* acc, const float* bias, float* cs, int H,
                              int H16, bf16* hb, float* hf) {
    const int ng = tiles_here((4 * H + kRows - 1) / kRows), G = gridDim.x;
    for (int idx = threadIdx.x; idx < ng * p.NT * 32; idx += blockDim.x) {
        const int j = idx / (p.NT * 32), rem = idx - j * p.NT * 32;
        const int tile = rem / 32, u = (rem / kTile) % 4, bb = rem % kTile;
        const int n = ((int)blockIdx.x + j * G) * 4 + u, b = tile * kTile + bb;
        float* a = acc + ((size_t)j * p.NT + tile) * kAcc + 4 * u * kTile + bb;
        const float* bi = bias + j * kRows + 4 * u;
        const float gi = a[0] + bi[0], gf = a[kTile] + bi[1];
        const float gg = a[2 * kTile] + bi[2], go = a[3 * kTile] + bi[3];
        a[0] = a[kTile] = a[2 * kTile] = a[3 * kTile] = 0.f;
        if (n >= H || b >= p.B) continue;
        float* c = cs + (j * 4 + u) * p.NT * kTile + b;
        const float cn = sigmoidf_(gf) * *c + sigmoidf_(gi) * tanhf(gg);
        *c = cn;
        const float h = sigmoidf_(go) * tanhf(cn);
        hb[(size_t)b * H16 + n] = __float2bfloat16_rn(h);
        if (hf) hf[(size_t)b * H + n] = h;
    }
}

// Epilogue of a small product (dealt down) over rows [0, N): fn(row, b,
// sum + bias); the accumulators are cleared.
template <typename Fn>
__device__ void rows_epilogue(const Params& p, float* acc, const float* bias, int N, Fn fn) {
    const int ng = tiles_here((N + kRows - 1) / kRows, kDealDown);
    for (int idx = threadIdx.x; idx < ng * p.NT * kAcc; idx += blockDim.x) {
        const int j = idx / (p.NT * kAcc), tile = (idx / kAcc) % p.NT, l = idx % kAcc;
        const int row = kRows * tile_of(j, kDealDown) + l / kTile;
        const int b = tile * kTile + l % kTile;
        const float v = acc[idx] + (bias ? bias[j * kRows + l / kTile] : 0.f);
        acc[idx] = 0.f;
        if (row < N && b < p.B) fn(row, b, v);
    }
}

// The first maximum over a warp: each lane holds its own (v, t), the first
// maximum of its values; every lane gets the larger v, on a tie the smaller t.
__device__ __forceinline__ void warp_first_max(float& v, int& t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int ot = __shfl_xor_sync(0xffffffffu, t, o);
        if (ov > v || (ov == v && ot < t)) {
            v = ov;
            t = ot;
        }
    }
}

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// log(1 + e^x) as jax.nn.softplus computes it
__device__ __forceinline__ float softplusf(float x) {
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// R4, beside the energies: the transition agent's u = sigmoid(ta . [ctx_prev
// | h1] + ta_b) of each row (bf16 inputs, f32 sums), a warp a row from the
// last warp of block 0 down (the energies take the first warps).
__device__ void trans_agent(const Params& p) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n = p.E16 + p.H116;
    for (int b = (int)blockIdx.x * kNW + (kNW - 1 - warp); b < p.B; b += (int)gridDim.x * kNW) {
        float acc = 0.f;
        for (int c = 8 * lane; c < n; c += 256) {
            const uint4 xv = c < p.E16
                ? __ldcg(reinterpret_cast<const uint4*>(p.ctx + (size_t)b * p.E16 + c))
                : __ldcg(reinterpret_cast<const uint4*>(p.h1 + (size_t)b * p.H116 + c - p.E16));
            float x[8], wv[8];
            unpack8(xv, x);
            unpack8(__ldg(reinterpret_cast<const uint4*>(p.ta + c)), wv);
#pragma unroll
            for (int k = 0; k < 8; ++k) acc = fmaf(x[k], wv[k], acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) p.uta[b] = sigmoidf_(acc + p.ta_b);
    }
}

// R5's norm of row rb under the location-sensitive attention's options, by
// one warp; i indexes the block's state of the row. The window, the norm
// over T, forward attention (alpha from the previous alpha, its shift
// rounded to bf16, u, the forward mask, pads zeroed, normalised; alpha is
// the alignment), then the window's next centre.
__device__ void norm_options(const Params& p, const Smem& s, int rb, int i, float* al) {
    const int lane = threadIdx.x & 31;
    if (p.windowing) {
        const int c = s.wctr[i];
        norm_energies<true>(p, rb, al, c - p.win_back, c + p.win_front);
    } else {
        norm_energies(p, rb, al);
    }
    if (p.fwd) {
        float* ap = s.alpha + (size_t)i * p.T;
        const float* mk = p.maskadd + (size_t)rb * p.T;
        const float u = p.ta_on ? __ldcg(p.uta + rb) : 0.5f;
        float mx = -INFINITY;
        int at = p.T;
        for (int t = lane; t < p.T; t += 32) {
            const float sh = t > 0 ? bf16_round(ap[t - 1]) : 0.f;
            const float v = ((1.f - u) * ap[t] + u * sh + 1e-8f) * al[t];
            al[t] = v;
            if (v > mx) {
                mx = v;
                at = t;
            }
        }
        warp_first_max(mx, at);
        float part = 0.f;
        for (int t = lane; t < p.T; t += 32) {
            float v = al[t];
            if (p.fmask) v = (t >= at - 1 ? v : 0.f) + 1e-8f;
            if (__ldg(mk + t) < -0.5f) v = 0.f;
            al[t] = v;
            part += v;
        }
        const float d = fmaxf(warp_sum(part), 1e-8f);
        __syncwarp();                                  // every lane has read ap
        for (int t = lane; t < p.T; t += 32) {
            const float v = al[t] / d;
            al[t] = v;
            ap[t] = v;
        }
    }
    if (p.windowing) {
        float mx = -INFINITY;
        int at = p.T;
        for (int t = lane; t < p.T; t += 32)
            if (al[t] > mx) {
                mx = al[t];
                at = t;
            }
        warp_first_max(mx, at);
        if (lane == 0) s.wctr[i] = at;
    }
    __syncwarp();
}

// R5's alignment of row rb under Graves attention, by one warp: lane j < K
// takes component j's (g, b, k) from l2's output: weights softmax(g) +
// 1e-5, widths softplus(b) + 1e-5, its mean advanced by softplus(k); the
// mixture 1/sqrt(2 pi) sum_j g_j exp(-z_j^2 / 2), z_j = (mu_j - t) / sig_j,
// pads zeroed, normalised.
__device__ void norm_graves(const Params& p, const Smem& s, int rb, int i, float* al) {
    const int lane = threadIdx.x & 31, K = p.GK;
    const float* gb = p.gbk + (size_t)rb * 3 * K;
    const bool on = lane < K;
    const float g = on ? __ldcg(gb + lane) : -INFINITY;
    float gm = g;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, o));
    const float ge = on ? expf(g - gm) : 0.f;
    const float gw = ge / warp_sum(ge) + 1e-5f;
    const float sig = on ? softplusf(__ldcg(gb + K + lane)) + 1e-5f : 1.f;
    float* mu = s.mu + (size_t)i * kMaxGK;
    const float m = on ? mu[lane] + softplusf(__ldcg(gb + 2 * K + lane)) : 0.f;
    if (on) mu[lane] = m;
    const float* mk = p.maskadd + (size_t)rb * p.T;
    float part = 0.f;
    for (int t0 = 0; t0 < p.T; t0 += 32) {
        const int t = t0 + lane;
        float a = 0.f;
        for (int j = 0; j < K; ++j) {
            const float gj = __shfl_sync(0xffffffffu, gw, j);
            const float sj = __shfl_sync(0xffffffffu, sig, j);
            const float mj = __shfl_sync(0xffffffffu, m, j);
            const float z = (mj - (float)t) / sj;
            a += gj * expf(-0.5f * z * z);
        }
        if (t < p.T) {
            a = __ldg(mk + t) < -0.5f ? 0.f : 0.3989422917366028f * a;
            al[t] = a;
            part += a;
        }
    }
    const float d = fmaxf(warp_sum(part), 1e-8f);
    for (int t = lane; t < p.T; t += 32) al[t] = al[t] / d;
    __syncwarp();
}

template <int PR, int AT>
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
    const int OR = p.OW + 1;                           // projection rows + stop row
    const int TA = (4 * p.H1 + kRows - 1) / kRows, TD = (4 * p.H2 + kRows - 1) / kRows;
    const int TP = (p.P + kRows - 1) / kRows, TQ = (p.A + kRows - 1) / kRows;
    const int TO = (OR + kRows - 1) / kRows;
    const int TG2 = (3 * p.GK + kRows - 1) / kRows;    // Graves's l2
    constexpr bool kLoc = AT != kGraves;               // energies, location features
    const size_t nt_acc = (size_t)p.NT * kAcc;
    s.wbuf = reinterpret_cast<uint4*>(take((size_t)p.WBUF * 32, 16));
    s.xs = reinterpret_cast<bf16*>(take((size_t)kTile * p.XLD, 2));
    s.us = reinterpret_cast<float*>(take(kLoc ? (size_t)2 * p.K * p.A : 0, 4));
    s.vw = reinterpret_cast<float*>(take(kLoc ? p.A : 0, 4));
    s.acc_a = reinterpret_cast<float*>(
        take((p.GA + p.GD + p.GO + max(p.GP, p.GQ)) * nt_acc, 4));
    s.acc_d = s.acc_a + p.GA * nt_acc;
    s.acc_o = s.acc_d + p.GD * nt_acc;
    s.acc_1 = s.acc_o + p.GO * nt_acc;
    s.slot = reinterpret_cast<float*>(take((size_t)p.SLOTS * kAcc, 4));
    s.ba = reinterpret_cast<float*>(
        take((size_t)kRows * (p.GA + p.GD + p.GO + TP + p.GP), 4));
    s.bd = s.ba + kRows * p.GA;
    s.bo = s.bd + kRows * p.GD;
    s.bp1 = s.bo + kRows * p.GO;
    s.bp2 = s.bp1 + kRows * TP;
    s.ca = reinterpret_cast<float*>(take((size_t)4 * (p.GA + p.GD) * p.NT * kTile, 4));
    s.cd = s.ca + 4 * p.GA * p.NT * kTile;
    s.aln = reinterpret_cast<float*>(take((size_t)p.ALN * p.T, 4));
    s.cum = reinterpret_cast<float*>(take((size_t)p.ALN * p.T, 4));
    s.xw = reinterpret_cast<float*>(take(kLoc ? (size_t)kNW * 2 * ((p.K + 31) / 32 * 32) : 0, 4));
    s.xs2 = reinterpret_cast<bf16*>(take((size_t)kTile * p.X2LD, 2));
    s.alpha = reinterpret_cast<float*>(take(AT == kOptions ? (size_t)p.ALN * p.T : 0, 4));
    s.wctr = reinterpret_cast<int*>(take(AT == kOptions ? p.ALN : 0, 4));
    s.mu = reinterpret_cast<float*>(take(AT == kGraves ? (size_t)p.ALN * kMaxGK : 0, 4));
    // this block's pairs' W_k m + location: in shared memory when the plan
    // has room for it, else in its rows of the global scratch
    s.pre = !kLoc ? nullptr
          : p.PRE_SMEM ? reinterpret_cast<float*>(take((size_t)p.PPB * p.A, 4))
                       : p.pre + (size_t)blockIdx.x * p.PPB * p.A;
    if (kLoc) {
        for (int i = threadIdx.x; i < 2 * p.K * p.A; i += blockDim.x)
            s.us[i] = __bfloat162float(p.u[i]);
        for (int i = threadIdx.x; i < p.A; i += blockDim.x) s.vw[i] = p.v_w[i];
    }
    // the attention state of the rows this block's context chunks touch:
    // alpha [1, 0, ...], the windows' centres 0, Graves's means 0
    if (AT == kOptions) {
        for (int i = threadIdx.x; i < p.ALN * p.T; i += blockDim.x)
            s.alpha[i] = i % p.T == 0 ? 1.f : 0.f;
        for (int i = threadIdx.x; i < p.ALN; i += blockDim.x) s.wctr[i] = 0;
    }
    if (AT == kGraves)
        for (int i = threadIdx.x; i < p.ALN * kMaxGK; i += blockDim.x) s.mu[i] = 0.f;
    const size_t nacc = (p.GA + p.GD + p.GO + max(p.GP, p.GQ)) * nt_acc;
    for (size_t i = threadIdx.x; i < nacc; i += blockDim.x) s.acc_a[i] = 0.f;
    for (int i = threadIdx.x; i < kTile * p.X2LD; i += blockDim.x)    // its pad columns
        s.xs2[i] = __float2bfloat16_rn(0.f);
    load_bias(s.ba, p.a_b, TA, kDealUp);
    load_bias(s.bd, p.d_b, TD, kDealUp);
    load_bias(s.bo, p.o_b, TO, kDealDown);
    load_bias(s.bp1, p.p1_b, TP, kDealAll);
    load_bias(s.bp2, p.p2_b, TP, kDealDown);
    move_cells<true>(s.ca, p.c1, p.H1, p);
    move_cells<true>(s.cd, p.c2, p.H2, p);
    load_cum(p, s);
    __syncthreads();

    // the products of each round; wbase places a product's tiles after the
    // round's other products in the weight buffer
    const int P16k = p.P16 / 16, H116k = p.H116 / 16, H216k = p.H216 / 16, E16k = p.E16 / 16;
    const int nQ = tiles_here(TQ, kDealDown) * H116k, nD6 = tiles_here(TD) * E16k;
    const int nO6 = tiles_here(TO, kDealDown) * E16k, nO7 = tiles_here(TO, kDealDown) * H216k;
    // layer 1 of the prenet runs whole on the blocks that own layer 2's tiles
    const int TP1 = tiles_here(TP, kDealDown) > 0 ? TP : 0, nP1 = TP1 * (p.NM16 / 16);
    // bit i of WB_ROUNDS: the i-th product round's weights are prefetched
    auto wb = [&](int round, int base) { return (p.WB_ROUNDS >> round) & 1 ? base : -1; };
    const Prod pP1{p.p1, p.NM16 / 16, 0, 0, p.NM16 / 16, TP1, p.ks[kP1], wb(0, 0), kDealAll,
                   nullptr};
    const Prod pP2{p.p2, P16k, 0, 0, P16k, TP, p.ks[kP2], wb(0, nP1), kDealDown, s.acc_1};
    const Prod pA2{p.a, p.KA, 0, 0, P16k, TA, p.ks[kA2], wb(1, 0), kDealUp, s.acc_a};
    const Prod pQ{p.q, H116k, 0, 0, H116k, TQ, p.ks[kQ], wb(2, 0), kDealDown, s.acc_1};
    const Prod pD3{p.d, p.KD, 0, 0, H116k, TD, p.ks[kD3], wb(2, nQ), kDealUp, s.acc_d};
    const Prod pA4{p.a, p.KA, P16k + E16k, 0, H116k, TA, p.ks[kA4], wb(3, 0), kDealUp,
                   s.acc_a};
    const Prod pD6{p.d, p.KD, H116k, 0, E16k, TD, p.ks[kD6], wb(4, 0), kDealUp, s.acc_d};
    const Prod pO6{p.o, p.KO, H216k, 0, E16k, TO, p.ks[kO6], wb(4, nD6), kDealDown, s.acc_o};
    const Prod pA6{p.a, p.KA, P16k, 0, E16k, TA, p.ks[kA6], wb(4, nD6 + nO6), kDealUp,
                   s.acc_a};
    const Prod pO7{p.o, p.KO, 0, 0, H216k, TO, p.ks[kO7], wb(5, 0), kDealDown, s.acc_o};
    const Prod pD7{p.d, p.KD, H116k + E16k, 0, H216k, TD, p.ks[kD7], wb(5, nO7), kDealUp,
                   s.acc_d};
    // Graves's l2 over the staged [h1 | qg], after a_w's tiles in R4's buffer
    const Prod pG2{p.g2, H116k, 0, p.H116, H116k, TG2, p.ks[kG2],
                   wb(3, tiles_here(TA) * H116k), kDealDown, s.acc_1};
    // the prologue's products of the initial state, from L2
    const Prod pA0{p.a, p.KA, P16k, 0, p.KA - P16k, TA, p.ks[kA4], -1, kDealUp, s.acc_a};
    const Prod pD0{p.d, p.KD, H116k + E16k, 0, H216k, TD, p.ks[kD7], -1, kDealUp, s.acc_d};
    const Src none{nullptr, 0};
    auto nothing = [] {};
    constexpr bool work = PR == kServe || PR == kProfile;
    constexpr bool prof = PR == kProfile;
    constexpr bool fetch = PR == kServe || PR == kProfile || PR == kDotsOnly;
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

    // prologue: the attention LSTM's product over the initial [ctx | h1]
    // and the decoder LSTM's over the initial h2 (step 0's share of what
    // R4, R6 and R7 compute for the next step), R1's weights, step 0's pre
    if (work) {
        run_products<PR>(p, s, {p.ctx, p.E16}, {p.h1, p.H116}, none, pA0, pA0, pA0, 1, nothing);
        run_products<PR>(p, s, {p.h2, p.H216}, none, none, pD0, pD0, pD0, 1, nothing);
    }
    if (fetch) fetch_weights(s.wbuf, pP1, pP2, pP2, 2);
    if (work && kLoc) location(p, s);
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
        if (work && step > 0 && step % p.chunk == 0) {
            bool all = true;
            for (int b = threadIdx.x; b < p.B; b += blockDim.x)
                all = all && __ldcg(done_in + b) > 0.f;
            if (__syncthreads_and(all)) break;        // the same in every block
        }
        const uint32_t key = hash_step_key(p.seed, (uint32_t)step);
        auto prenet = [&](int salt, bf16* dst) {
            return [&, salt, dst](int row, int b, float v) {
                v = fmaxf(v, 0.f);
                if (p.dropout)
                    v = hash_uniform((uint32_t)((p.row0 + b) * p.P + row), key,
                                     (uint32_t)salt) < 0.5f ? 0.f : v * 2.f;
                dst[(size_t)b * p.P16 + row] = __float2bfloat16_rn(v);
            };
        };
        // each round: its products, the next product round's weights into
        // the buffer (they land during the epilogue and the barrier), the
        // epilogue. The chain frame -> x -> h1 -> pq -> e -> ctx -> h2 ->
        // frame runs one link a round; the LSTM products that do not lie on
        // it (a_w over h1 and ctx, d_w over h2) run where their input is
        // already staged, for the next step.
        // R1: the prenet
        prenet_round<PR>(p, s, pP1, pP2, key);
        if (fetch) fetch_weights(s.wbuf, pA2, pA2, pA2, 1);
        if (work) rows_epilogue(p, s.acc_1, s.bp2, p.P, prenet(12, p.x));
        sync(0);
        // R2
        run_products<PR>(p, s, {p.x, p.P16}, none, none, pA2, pA2, pA2, 1, nothing);
        if (fetch) fetch_weights(s.wbuf, pQ, pD3, pD3, 2);
        if (work) lstm_epilogue(p, s.acc_a, s.ba, s.ca, p.H1, p.H116, p.h1, p.h1f);
        sync(1);
        // R3
        run_products<PR>(p, s, {p.h1, p.H116}, none, none, pQ, pD3, pD3, 2, nothing);
        if (fetch) fetch_weights(s.wbuf, pA4, pG2, pG2, kLoc ? 1 : 2);
        if (work && kLoc)
            rows_epilogue(p, s.acc_1, nullptr, p.A, [&](int row, int b, float v) {
                p.pq[(size_t)b * p.A + row] = v;
            });
        if (work && !kLoc)                             // Graves: l1 in q's place
            rows_epilogue(p, s.acc_1, nullptr, p.A, [&](int row, int b, float v) {
                p.qg[(size_t)b * p.H116 + row] = __float2bfloat16_rn(tanhf(v + __ldg(p.g1_b + row)));
            });
        sync(2);
        // R4: the energies (and the transition agent's u) while h1 is staged
        // again, then a_w over h1; Graves: a_w over h1 and l2 over qg
        if constexpr (kLoc) {
            run_products<PR>(p, s, {p.h1, p.H116}, none, none, pA4, pA4, pA4, 1, [&] {
                if (work) energies(p, s);
                if (work && AT == kOptions && p.ta_on) trans_agent(p);
            });
        } else {
            run_products<PR>(p, s, {p.h1, p.H116}, {p.qg, p.H116}, none, pA4, pG2, pG2, 2,
                             nothing);
        }
        if (fetch) fetch_weights(s.wbuf, pD6, pO6, pA6, 3);
        if (work && !kLoc)
            rows_epilogue(p, s.acc_1, nullptr, 3 * p.GK, [&](int row, int b, float v) {
                p.gbk[(size_t)b * 3 * p.GK + row] = v + __ldg(p.g2_b + row);
            });
        sync(3);
        // R5
        if (work) {
            if constexpr (AT == kOptions)
                context(p, s, step, [&](int rb, int i, float* al) { norm_options(p, s, rb, i, al); });
            else if constexpr (AT == kGraves)
                context(p, s, step, [&](int rb, int i, float* al) { norm_graves(p, s, rb, i, al); });
            else
                context(p, s, step);
        }
        sync(4);
        // R6
        run_products<PR>(p, s, {p.ctx, p.E16}, none, none, pD6, pO6, pA6, 3, nothing);
        if (fetch) fetch_weights(s.wbuf, pO7, pD7, pD7, 2);
        if (work) lstm_epilogue(p, s.acc_d, s.bd, s.cd, p.H2, p.H216, p.h2, p.h2f);
        sync(5);
        // R7
        run_products<PR>(p, s, {p.h2, p.H216}, none, none, pO7, pD7, pD7, 2, nothing);
        if (fetch) fetch_weights(s.wbuf, pP1, pP2, pP2, 2);
        if (work) {
            if (kLoc) location(p, s);                  // the next step's pre
            rows_epilogue(p, s.acc_o, s.bo, OR, [&](int row, int b, float v) {
                const float dn = __ldcg(done_in + b);
                if (row < p.OW) {
                    const float o = v * (1.f - dn);
                    p.out[((size_t)step * p.B + b) * p.OW + row] = o;
                    const int f = row - p.NM * (p.r - 1);
                    if (f >= 0 && f < p.NM)
                        p.frame[(size_t)b * p.NM16 + f] = __float2bfloat16_rn(o);
                } else {
                    const float pr = sigmoidf_(v);
                    p.stops[(size_t)step * p.B + b] = pr;
                    done_out[b] = fmaxf(dn, pr > p.thresh ? 1.f : 0.f);
                }
            });
        }
        sync(6);
    }
    cp_async_wait_all();                               // the last prefetch
    if (work) {
        move_cells<false>(s.ca, p.c1, p.H1, p);
        move_cells<false>(s.cd, p.c2, p.H2, p);
    }
    if (prof && threadIdx.x == 0)
        for (int r = 0; r < kRounds; ++r) {
            p.prof[((size_t)blockIdx.x * kRounds + r) * 2] = (float)t_work[r];
            p.prof[((size_t)blockIdx.x * kRounds + r) * 2 + 1] = (float)t_wait[r];
        }
    if (blockIdx.x == 0 && threadIdx.x == 0) *p.ran = step;
}

template <int PR, int AT = kLocation>
const void* kernel_of() { return reinterpret_cast<const void*>(decode_kernel<PR, AT>); }

// The probes take the location route only; every route serves and profiles.
const void* kernel_for(int probe, int route) {
    if (route == kOptions)
        return probe == kProfile ? kernel_of<kProfile, kOptions>() : kernel_of<kServe, kOptions>();
    if (route == kGraves)
        return probe == kProfile ? kernel_of<kProfile, kGraves>() : kernel_of<kServe, kGraves>();
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

// ptrs: p1, p2, a, q, d, o, u, p1_b, p2_b, a_b, d_b, o_b, v_w, enc, pinp,
// maskadd, frame, x1, x, h1, h2, ctx, c1, c2, att, cum, done, pq, e, pre,
// out, aligns, stops, ran, prof, h1f, h2f, ta, g1_b, g2, g2_b, uta, qg, gbk
// (the attention variants' weights and scratch, null where the route has
// none; Graves: q holds l1, pinp, pq, e and pre are null, u and v_w
// unread). The state buffers (frame, h1, h2 as bf16 product inputs, c1, c2
// in f32) hold the initial state, zeros or a previous text chunk's
// stream; c1 and c2 hold the final cell states after the launch, and h1f /
// h2f, where not null, the final hiddens in f32 (the stream out). dims: the launch plan (ops/taco2_decode.py
// `launch_plan`, `_DIMS` order), the twelve products' k-tile slices, blocks,
// shared memory bytes, then the attention: route (0 location, 1 with
// options, 2 Graves), windowing, win_back, win_front, forward attention,
// transition agent, forward mask, Graves's components. fl: v_b, thresh,
// ta_b. probe (1-3 on the location route only): 0 serves, 1 keeps only the
// barriers, 2 only the stage-input copies, 3 only the products, 4 serves
// and writes each block's cycles a round (work, then barrier wait) to
// prof [G, 7, 2] (null for the other launches). Returns a cudaError_t, or
// -1 when the grid cannot be co-resident.
int taco2_decode(const void* const* ptrs, const int* dims, const float* fl, unsigned int seed,
                 void* stream, int probe) {
    if (probe < kServe || probe > kProfile) return (int)cudaErrorInvalidValue;
    Params p{};
    const bf16** wb[] = {&p.p1, &p.p2, &p.a, &p.q, &p.d, &p.o, &p.u};
    for (int i = 0; i < 7; ++i) *wb[i] = static_cast<const bf16*>(ptrs[i]);
    const float** wf[] = {&p.p1_b, &p.p2_b, &p.a_b, &p.d_b, &p.o_b, &p.v_w};
    for (int i = 0; i < 6; ++i) *wf[i] = static_cast<const float*>(ptrs[7 + i]);
    p.enc = static_cast<const bf16*>(ptrs[13]);
    p.pinp = static_cast<const float*>(ptrs[14]);
    p.maskadd = static_cast<const float*>(ptrs[15]);
    bf16** sb[] = {&p.frame, &p.x1, &p.x, &p.h1, &p.h2, &p.ctx};
    for (int i = 0; i < 6; ++i) *sb[i] = static_cast<bf16*>(const_cast<void*>(ptrs[16 + i]));
    float** sf[] = {&p.c1, &p.c2, &p.att, &p.cum, &p.done, &p.pq, &p.e, &p.pre, &p.out,
                    &p.aligns, &p.stops};
    for (int i = 0; i < 11; ++i) *sf[i] = static_cast<float*>(const_cast<void*>(ptrs[22 + i]));
    p.ran = static_cast<int*>(const_cast<void*>(ptrs[33]));
    p.prof = static_cast<float*>(const_cast<void*>(ptrs[34]));
    p.h1f = static_cast<float*>(const_cast<void*>(ptrs[35]));
    p.h2f = static_cast<float*>(const_cast<void*>(ptrs[36]));
    p.ta = static_cast<const bf16*>(ptrs[37]);
    p.g1_b = static_cast<const float*>(ptrs[38]);
    p.g2 = static_cast<const bf16*>(ptrs[39]);
    p.g2_b = static_cast<const float*>(ptrs[40]);
    p.uta = static_cast<float*>(const_cast<void*>(ptrs[41]));
    p.qg = static_cast<bf16*>(const_cast<void*>(ptrs[42]));
    p.gbk = static_cast<float*>(const_cast<void*>(ptrs[43]));
    int* di[] = {&p.B, &p.T, &p.NT, &p.NM, &p.NM16, &p.P, &p.P16, &p.E16, &p.H1, &p.H116,
                 &p.H2, &p.H216, &p.A, &p.K, &p.OW, &p.r, &p.KA, &p.KD, &p.KO, &p.steps,
                 &p.chunk, &p.softmax, &p.dropout, &p.XLD, &p.ALN, &p.CPB, &p.PPB, &p.GA,
                 &p.GD, &p.GO, &p.GP, &p.GQ, &p.SLOTS, &p.WBUF, &p.WB_ROUNDS,
                 &p.PRE_SMEM, &p.X2LD, &p.row0};
    constexpr int nd = sizeof(di) / sizeof(di[0]);
    for (int i = 0; i < nd; ++i) *di[i] = dims[i];
    for (int i = 0; i < kNumProducts; ++i) p.ks[i] = dims[nd + i];
    const int blocks = dims[nd + kNumProducts], smem = dims[nd + kNumProducts + 1];
    const int* at = dims + nd + kNumProducts + 2;
    const int route = at[0];
    int* da[] = {&p.windowing, &p.win_back, &p.win_front, &p.fwd, &p.ta_on, &p.fmask, &p.GK};
    for (int i = 0; i < 7; ++i) *da[i] = at[1 + i];
    p.v_b = fl[0];
    p.thresh = fl[1];
    p.ta_b = fl[2];
    p.seed = seed;
    if (p.K < 1 || p.B < 1 || p.chunk < 1 || (probe == kProfile && !p.prof))
        return (int)cudaErrorInvalidValue;
    if (route < kLocation || route > kGraves ||
        (route != kLocation && probe != kServe && probe != kProfile) ||
        (route == kGraves && (p.GK < 1 || p.GK > kMaxGK || !p.g2 || !p.g1_b || !p.g2_b ||
                              !p.qg || !p.gbk)) ||
        (route == kOptions && p.ta_on && (!p.ta || !p.uta)))
        return (int)cudaErrorInvalidValue;
    const void* kernel = kernel_for(probe, route);
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
