"""Tacotron(1) free-running decode: the CUDA kernel (csrc/taco1_decode.cu),
its plain PyTorch version, and the weight layout both read.

Counterpart of the JAX package's ops/pallas/taco1_decode.py
`tacotron1_decode_pallas` for the configuration it serves (location-
sensitive attention with sigmoid or softmax norm, original or BN-folded
prenet with the hash-PRNG dropout). Same arguments, same
outputs: time-major frames [steps, B, n_mels * r_init], alignments
[steps, B, T], stop probabilities [steps, B] and lengths [B] in r-groups.

Semantics of the Pallas route, which both versions keep:
- the decoder input is a flat [B, memory * n_mels] queue of the last
  frames; each step appends its first n_mels * r outputs (zero for a row
  that is done) and keeps the last memory * n_mels values. For r <= memory
  that is the Pallas kernel's roll; the reference serves r > memory on its
  XLA scan only (`TacotronDecoder.inference`), whose queue keeps the
  step's last memory frames, and both versions here follow that rule;
- every `chunk` steps the done mask is read once (by the host in the plain
  version, on the device in the kernel); once every row is done the
  remaining chunks are zero;
- within a chunk a row that is done keeps advancing its GRU and attention
  state and still writes its alignment and stop probability; only its
  output frame and its queue input are zero;
- prenet dropout draws from the hash PRNG keyed by (seed, step), salts 21
  and 22, element index row * width + col;
- the stopnet is folded through the mel projection;
- matrix inputs are rounded to the working dtype (bf16 by default), with
  f32 accumulation, f32 state and f32 outputs.

The location features use one formulation for every T: the folded [2, K, A]
correlation of the Tacotron2 decode, which equals both of the reference's
(banded for T <= 256, tiled beyond). The reference pads the batch to a
multiple of 8; the port does not (dropout bits are indexed by the row, so
real rows draw the same ones).

`tacotron1_decode` runs the plain version for a CPU tensor and the kernel
for a CUDA tensor; the kernel wrapper raises on what it does not take and
never falls back. The kernel is one persistent launch a decode with every
weight resident in shared memory (`launch_plan`, `pack_weights`); it
checks the early exit on the device and writes how many steps ran, which
the wrapper reads once. A batch too large for one launch's shared memory
runs as slices of whole batch tiles, a launch each (`batch_slices`,
`run_slices`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build
from .prng import step_key, uniform
from .taco2_decode import (_drive, _finish, _pad16, _round_up, _rows, _segments,
                           _sm_count, alignment_plain, batch_slices, fragment_order,
                           round_profile, run_slices)

F32 = torch.float32
BF16 = torch.bfloat16


def _interleave_gru(w):
    """[3H, ...] stacked (r, z, n) blocks -> rows 3 * j + g."""
    H = w.shape[0] // 3
    return w.reshape(3, H, *w.shape[1:]).transpose(0, 1).reshape(3 * H, *w.shape[1:])


@torch.no_grad()
def prepare_weights(prenet, attention_rnn, query_w, loc_u, v_w, v_b, project,
                    decoder_rnns, proj_mel, stopnet, *, n_mels: int, dtype=BF16) -> dict:
    """Lay the decoder's weights out for the decode, once per load.

    prenet: [(weight [P1, M * n_mels], bias), (weight [P2, P1], bias)] (BN
    already folded); attention_rnn and each of the two decoder_rnns:
    (weight_ih, weight_hh, bias_ih, bias_hh) in torch's GRU layout;
    query_w [A, H]; loc_u [2, K, A] folded location filter or None; v_w
    [1, A], v_b [1]; project (weight [D, H + E], bias); proj_mel (weight
    [OW, D], bias); stopnet (weight [1, D + OW], bias).

    Every matrix is [out, in] in `dtype`; GRU gate rows are interleaved so
    that rows 3j..3j+2 are unit j's r, z, n; the mel projection gets the stop
    row appended, folded through it (stop([x, mel(x)]) = W_eff x + b_eff).
    Biases, v and the state stay f32."""
    (p1_w, p1_b), (p2_w, p2_b) = prenet
    a_ih, a_hh, a_bx, a_bh = attention_rnn
    pj_w, pj_b = project
    m_w, m_b = (t.detach().to(F32) for t in proj_mel)
    stop_w, stop_b = (t.detach().to(F32) for t in stopnet)
    H, A, D, OW = a_hh.shape[1], query_w.shape[0], pj_w.shape[0], m_w.shape[0]
    if loc_u is None:
        loc_u = torch.zeros(2, 1, A, device=query_w.device)
    so = stop_w[0, D:]
    stop_w_eff = so @ m_w + stop_w[0, :D]
    stop_b_eff = stop_b + m_b @ so
    f32 = lambda t: t.detach().to(F32).contiguous()  # noqa: E731
    w = {
        "dtype": dtype,
        "dims": {"NQ": p1_w.shape[1], "NM": n_mels, "P1": p1_w.shape[0],
                 "P2": p2_w.shape[0], "H": H, "E": pj_w.shape[1] - H, "A": A,
                 "K": loc_u.shape[1], "D": D, "OW": OW},
        "p1_w": _rows(p1_w, dtype), "p1_b": f32(p1_b),
        "p2_w": _rows(p2_w, dtype), "p2_b": f32(p2_b),
        "a_wx": _rows(_interleave_gru(a_ih), dtype), "a_bx": f32(_interleave_gru(a_bx)),
        "a_wh": _rows(_interleave_gru(a_hh), dtype), "a_bh": f32(_interleave_gru(a_bh)),
        "q_w": _rows(query_w, dtype),
        "u": loc_u.detach().to(F32).to(dtype).contiguous(),
        "v_w": f32(v_w[0]), "v_b": float(v_b[0]),
        "pj_w": _rows(pj_w, dtype), "pj_b": f32(pj_b),
        "m_w": _rows(torch.cat([m_w, stop_w_eff[None]], 0), dtype),
        "m_b": f32(torch.cat([m_b, stop_b_eff])),
    }
    for i, (w_ih, w_hh, bx, bh) in enumerate(decoder_rnns, 1):
        w[f"d{i}_wx"] = _rows(_interleave_gru(w_ih), dtype)
        w[f"d{i}_bx"] = f32(_interleave_gru(bx))
        w[f"d{i}_wh"] = _rows(_interleave_gru(w_hh), dtype)
        w[f"d{i}_bh"] = f32(_interleave_gru(bh))
    return w


def _dims(w: dict, r: int):
    d = w["dims"]
    if d["NQ"] % d["NM"] or not 1 <= r * d["NM"] <= d["OW"]:
        raise ValueError(f"r={r} frames of {d['NM']} mels a step need 1 <= r <= r_init "
                         f"(the mel projection is {d['OW']} wide) and a queue of whole "
                         f"frames ({d['NQ']} values)")
    return d


def gru_step(W: dict, pre: str, xs, h, rnd):
    """One GRU update on weights laid out as `prepare_weights` lays them
    (unit j's r, z and n gate rows at 3j .. 3j + 2; matrix columns past the
    inputs' width are padding): W[pre + "wx"] over the concatenated inputs
    `xs`, W[pre + "wh"] over the state h [B, H], their biases; `rnd` casts
    each product's input to the working dtype."""
    B = h.shape[0]
    n = sum(x.shape[1] for x in xs)
    gx = (rnd(torch.cat(xs, 1)) @ W[pre + "wx"][:, :n].T + W[pre + "bx"]).view(B, -1, 3)
    gh = (rnd(h) @ W[pre + "wh"][:, :h.shape[1]].T + W[pre + "bh"]).view(B, -1, 3)
    rg = torch.sigmoid(gx[..., 0] + gh[..., 0])
    zg = torch.sigmoid(gx[..., 1] + gh[..., 1])
    ng = torch.tanh(gx[..., 2] + rg * gh[..., 2])
    return (1.0 - zg) * ng + zg * h


def decoder_step(W: dict, v_b, x, state: tuple, enc, pinp, maskadd, norm: str, rnd):
    """One decoder step after the prenet, the one step function of the plain
    decode (below) and of the teacher-forced pass (models/tacotron.py
    `TacotronDecoder.forward`, under autograd): the attention GRU over
    [prenet output x, last context], the location-sensitive alignment
    (`alignment_plain`), the context, the projection to the decoder width
    and the two residual GRUs. W: `prepare_weights`' keys (a_*, q_w, u,
    v_w, pj_w, pj_b, d1_*, d2_*); v_b the energy bias; state (attention GRU
    h [B, H], h1, h2 [B, D], context [B, E], alignment, cumulative
    alignment [B, T]); maskadd [B, T] 0 / -1e9. Returns (the new state, the
    residual stack's output [B, D]), which the mel projection and the
    stopnet take."""
    ah, h1, h2, ctx, att, cum = state
    H, E = ah.shape[1], enc.shape[2]
    ah = gru_step(W, "a_", [x, ctx], ah, rnd)
    align = alignment_plain(ah, att, cum, W["q_w"][:, :H], W["u"], W["v_w"], v_b, pinp,
                            maskadd, norm, rnd)
    ctx = (align[:, :, None] * enc).sum(1)
    xd = rnd(torch.cat([ah, ctx], 1)) @ W["pj_w"][:, :H + E].T + W["pj_b"]
    h1 = gru_step(W, "d1_", [xd], h1, rnd)
    xd = xd + h1
    h2 = gru_step(W, "d2_", [xd], h2, rnd)
    xd = xd + h2
    return (ah, h1, h2, ctx, align, cum + align), xd


def tacotron1_decode_plain(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                           norm: str = "sigmoid", thresh: float = 0.6,
                           prenet_dropout: bool = True, seed: int = 0, chunk: int = 50):
    """The decode in plain PyTorch ops, on any device: the reference the
    kernel is held against. Arguments as `tacotron1_decode`."""
    d = _dims(w, r)
    NQ, NM, P1, H, E, D, OW = (d[k] for k in ("NQ", "NM", "P1", "H", "E", "D", "OW"))
    rnd = (lambda x: x.to(BF16).float()) if w["dtype"] == BF16 else (lambda x: x)
    W = {k: v.float() for k, v in w.items() if isinstance(v, torch.Tensor)}
    B, T, _ = enc_out.shape
    dev = enc_out.device
    enc = rnd(enc_out.float())
    pinp = pinp.float()
    maskadd = torch.where(mask, 0.0, -1e9).to(F32)
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    state = (z(B, H), z(B, D), z(B, D), z(B, E), z(B, T), z(B, T))
    queue, done = z(B, NQ), z(B)
    n_steps = -(-max_steps // chunk) * chunk
    out = torch.empty(n_steps, B, OW, device=dev)
    aligns = torch.empty(n_steps, B, T, device=dev)
    stops = torch.empty(n_steps, B, device=dev)

    def dropout(x, key, salt):
        if not prenet_dropout:
            return x
        return torch.where(uniform(tuple(x.shape), key, salt, dev) < 0.5, 0.0, x * 2.0)

    def step(s):
        nonlocal state, queue, done
        key = step_key(seed, s)
        x = dropout(torch.relu(rnd(queue) @ W["p1_w"][:, :NQ].T + W["p1_b"]), key, 21)
        x = dropout(torch.relu(rnd(x) @ W["p2_w"][:, :P1].T + W["p2_b"]), key, 22)
        state, xd = decoder_step(W, w["v_b"], x, state, enc, pinp, maskadd, norm, rnd)
        o = rnd(xd) @ W["m_w"][:, :D].T + W["m_b"]
        stop = torch.sigmoid(o[:, OW])
        dec = o[:, :OW] * (1.0 - done)[:, None]
        done = torch.maximum(done, (stop > thresh).to(F32))
        queue = torch.cat([queue, dec[:, :NM * r]], 1)[:, -NQ:]
        out[s], aligns[s], stops[s] = dec, state[4], stop

    ran = _drive(n_steps, chunk, step, lambda s: bool(done.min() > 0))
    return _finish(out, aligns, stops, ran, max_steps, thresh)


# ---------------------------------------------------------------- the kernel

THREADS, WARPS, TILE, BARRIERS = 512, 16, 8, 10
ROWS, KT = 16, 16          # a tensor-core tile: 16 weight rows x 16 columns
# The matrices, in the order of a block's resident region: (prepare_weights
# key, bias key or None, input segments, rows, GRU). A GRU matrix's rows go
# in unit groups of 16 units, three 16-row tiles a group (its r, z and n
# rows); its input and hidden matrices are two matrices dealt alike.
MATRICES = {
    "ax": ("a_wx", "a_bx", ("P2", "E"), "H", True),
    "ah": ("a_wh", "a_bh", ("H",), "H", True),
    "d1x": ("d1_wx", "d1_bx", ("D",), "D", True),
    "d1h": ("d1_wh", "d1_bh", ("D",), "D", True),
    "d2x": ("d2_wx", "d2_bx", ("D",), "D", True),
    "d2h": ("d2_wh", "d2_bh", ("D",), "D", True),
    "p1": ("p1_w", "p1_b", ("NQ",), "P1", False),
    "p2": ("p2_w", "p2_b", ("P1",), "P2", False),
    "q": ("q_w", None, ("H",), "A", False),
    "pj": ("pj_w", "pj_b", ("H", "E"), "D", False),
    "m": ("m_w", "m_b", ("D",), "OW+1", False),
}
# the blocks a matrix's groups are dealt to start where the previous
# owner's end (a GRU's two matrices share their blocks), modulo the grid
OWNERS = (("ax", "ah"), ("d1x", "d1h"), ("d2x", "d2h"), ("p1",), ("p2",), ("q",), ("pj",),
          ("m",))
# the products of a step, in the kernel's order (csrc/taco1_decode.cu):
# (round, matrix, input segment, the segment's column in the staged tile)
PRODUCTS = (("R1", "p1", 0, 0), ("R2", "p2", 0, 0), ("R3", "ax", 0, 0), ("R4", "q", 0, 0),
            ("R4", "ah", 0, 0), ("R4", "pj", 0, 0), ("R7", "pj", 1, 0), ("R7", "ax", 1, 0),
            ("R8", "d1x", 0, 0), ("R9", "d2x", 0, 0), ("R9", "d1h", 0, 1),
            ("R10", "m", 0, 0), ("R10", "d2h", 0, 1))
ROUNDS = ("R1 prenet layer 1, location", "R2 prenet layer 2", "R3 attention GRU",
          "R4 query, a_h ah, pj ah", "R5 energies", "R6 norm, context", "R7 pj ctx, a_x ctx",
          "R8 d1", "R9 d2, d1_h h1", "R10 mel, stop, d2_h h2")
PROBES = {"barriers_only": 1, "copies_only": 2, "dots_only": 3}
_PROFILE = 4
_DIMS = ("B", "T", "NT", "NM", "NQ", "NQ16", "NMr", "P1", "P116", "P2", "P216", "H", "H16",
         "E16", "D", "D16", "A", "K", "OW", "steps", "chunk", "softmax", "dropout", "row0",
         "XLD", "ALN", "CPB", "PPB", "SLOTS", "RES", "BRES", "ACC", "HU", "PIN_SMEM")
SMEM_LIMIT = 232448        # bytes of shared memory a block may use on the H100


def _shapes(d: dict) -> dict:
    """(row tiles, tiles a group, k-tiles, input segment widths) of each
    matrix at dims d."""
    widths = dict(d, **{"OW+1": d["OW"] + 1})
    out = {}
    for name, (_, _, segs, rows, gru) in MATRICES.items():
        n = widths[rows]
        tiles = 3 * (_pad16(n) // ROWS) if gru else -(-n // ROWS)
        out[name] = (tiles, 3 if gru else 1, sum(_pad16(widths[k]) for k in segs) // KT,
                     [widths[k] for k in segs])
    return out


def _bases(d: dict, G: int) -> dict:
    """The block each matrix's group 0 goes to: the owners laid out one
    after another around the grid (a GRU's two matrices share theirs)."""
    shapes, out, base = _shapes(d), {}, 0
    for names in OWNERS:
        for name in names:
            out[name] = base
        base = (base + shapes[names[0]][0] // shapes[names[0]][1]) % G
    return out


def owned_tiles(d: dict, G: int) -> dict:
    """Each matrix's row tiles each block holds: {matrix: [[tile, ...] for
    block b in range(G)]}. Unit groups (one tile, or a GRU's three) are
    dealt one a block, group i to block (base + i) % G (`_bases`)."""
    shapes, bases = _shapes(d), _bases(d, G)
    out = {}
    for name, (tiles, grp, _, _) in shapes.items():
        out[name] = [[grp * i + g for i in range(tiles // grp) if (bases[name] + i) % G == b
                      for g in range(grp)] for b in range(G)]
    return out


def launch_plan(dims: dict, B: int, T: int, blocks: int) -> dict:
    """`_plan` at the current SMEM_LIMIT, kept for the last 256 shapes: a
    decode asks for its plan twice and its Python costs milliseconds. The
    plan is shared: callers do not change it."""
    return _plan(tuple(sorted(dims.items())), B, T, blocks, SMEM_LIMIT)


@functools.lru_cache(maxsize=256)
def _plan(dims: tuple, B: int, T: int, blocks: int, smem_limit: int) -> dict:
    """The persistent kernel's launch plan on `blocks` blocks of 512
    threads: batch tiles of 8 rows (the n of mma.m16n8k16); the row tiles
    of every matrix each block keeps resident in shared memory for the
    launch (`owned_tiles`), their k-tiles (RES, in 512-byte tiles), biases
    (BRES floats), accumulators (ACC tiles) and GRU states (HU units); the
    k-tile slices an item of each product takes (enough items for the 16
    warps); the attention's (row, t) pairs and context chunks a block;
    shared memory bytes, as the kernel lays them out. Raises where a block
    needs more shared memory than the card has."""
    d, G = dict(dims), blocks
    shapes = _shapes(d)
    own = owned_tiles(d, G)
    NT = -(-B // TILE)
    w16 = {k: _pad16(d[k]) for k in ("NQ", "P1", "P2", "H", "E", "D")}
    here = {name: [len(own[name][b]) for b in range(G)] for name in MATRICES}
    per_block = lambda f: [sum(f(name, b) for name in MATRICES) for b in range(G)]  # noqa: E731
    res = per_block(lambda n, b: here[n][b] * shapes[n][2])
    bres = per_block(lambda n, b: here[n][b] * ROWS)
    hu = [sum(here[n][b] // 3 * ROWS for n in ("ax", "d1x", "d2x")) for b in range(G)]
    ks = [max(1, min(WARPS // max(1, max(here[m])), _pad16(shapes[m][3][seg]) // KT))
          for _, m, seg, _ in PRODUCTS]
    rounds = {}
    for (rnd, m, _, _), k in zip(PRODUCTS, ks):
        rounds.setdefault(rnd, []).append((m, k))
    slots = max(sum(here[m][b] * k for m, k in prods) for prods in rounds.values()
                for b in range(G))
    CE = w16["E"] // 8
    CPB = -(-(B * CE) // G)
    plan = {
        "blocks": G, "threads": THREADS, "barriers_per_step": BARRIERS, "tiles": NT,
        "NQ16": w16["NQ"], "P116": w16["P1"], "P216": w16["P2"], "H16": w16["H"],
        "E16": w16["E"], "D16": w16["D"],
        # the staged tile's row stride: 8 bf16 past a multiple of 16, so
        # that the 8 rows of a B-fragment load fall in distinct banks
        "XLD": max(w16["NQ"], w16["P1"], w16["P2"], w16["H"], w16["E"], 2 * w16["D"]) + 8,
        "RES": max(res), "BRES": max(bres), "ACC": max(per_block(lambda n, b: here[n][b])),
        "HU": max(hu), "SLOTS": slots, "ks": ks,
        "PPB": -(-(B * T) // G), "CPB": CPB, "ALN": min(B, -(-CPB // CE) + 1),
        "matrices": {name: (shapes[name][0], shapes[name][1], shapes[name][2], base)
                     for name, base in _bases(d, G).items()},
        "tiles_per_block": {name: max(here[name]) for name in MATRICES},
    }
    seg = lambda n: -(-n // 16) * 16  # noqa: E731
    A, K = d["A"], d["K"]
    plan["smem_bytes"] = (plan["RES"] * 512 + seg(TILE * plan["XLD"] * 2) + seg(2 * K * A * 4)
                          + seg(A * 4) + seg(plan["ACC"] * NT * ROWS * TILE * 4)
                          + seg(slots * ROWS * TILE * 4) + seg(plan["BRES"] * 4)
                          + seg(plan["HU"] * NT * TILE * 4) + 2 * seg(plan["ALN"] * T * 4)
                          + seg(WARPS * 2 * _round_up(K, 32) * 4)
                          + seg(plan["PPB"] * A * 4)                   # pre
                          + seg(plan["HU"] * NT * TILE * 4)            # a staged residual
                          + seg(NT * TILE * 4))                        # the done mask
    # the block's pairs' W_k m stay in shared memory when they fit
    pin = seg(plan["PPB"] * A * 4)
    plan["PIN_SMEM"] = int(plan["smem_bytes"] + pin <= smem_limit)
    plan["smem_bytes"] += pin * plan["PIN_SMEM"]
    if plan["smem_bytes"] > smem_limit:
        raise ValueError(f"the decode kernel needs {plan['smem_bytes']} bytes of shared memory "
                         f"a block at these widths, B={B}, T={T} on {G} blocks "
                         f"(at most {smem_limit})")
    # stage inputs copied into a block that takes part in a round, a step
    plan["staged_bytes_per_block"] = 2 * TILE * NT * (
        w16["NQ"] + w16["P1"] + w16["P2"] + w16["H"] + w16["E"] + 5 * w16["D"])
    return plan


def _gate_tiles(m, H: int):
    """Rows 3 n + g (unit n's r, z, n gates, as prepare_weights interleaves
    them) -> unit groups of 16 units, three 16-row tiles a group: row
    48 (n // 16) + 16 g + n % 16; rows of units past H are zero."""
    n = torch.arange(H, device=m.device)
    out = m.new_zeros((3 * _pad16(H),) + tuple(m.shape[1:]))
    for g in range(3):
        out[48 * (n // 16) + 16 * g + n % 16] = m[3 * n + g]
    return out


@torch.no_grad()
def pack_weights(w: dict, blocks: int) -> dict:
    """The kernel's resident layout of `prepare_weights` output on `blocks`
    blocks, kept in w["resident"][blocks]: every matrix's input segments
    zero-padded to a multiple of 16 columns, rows to whole row tiles (a
    GRU's in unit groups, `_gate_tiles`), each matrix in `fragment_order`;
    then for each block its tiles of every matrix (`owned_tiles`, MATRICES
    order), each with all its k-tiles, in one contiguous region "w"
    [blocks, RES, 32, 8], and their biases in "b" [blocks, BRES] f32. A block
    copies its region into shared memory once a launch."""
    cache = w.setdefault("resident", {})
    if blocks in cache:
        return cache[blocks]
    d = w["dims"]
    shapes = _shapes(d)
    own = owned_tiles(d, blocks)
    frags, biases = {}, {}
    for name, (wk, bk, _, rows, gru) in MATRICES.items():
        tiles, _, _, widths = shapes[name]
        m = _segments(w[wk][:, :sum(widths)].float(), widths)
        b = w[bk] if bk else torch.zeros(m.shape[0], device=m.device)
        n = dict(d, **{"OW+1": d["OW"] + 1})[rows]
        m, b = (_gate_tiles(m, n), _gate_tiles(b, n)) if gru else (m, b)
        pad = tiles * ROWS - m.shape[0]
        frags[name] = fragment_order(F.pad(m, (0, 0, 0, pad))).to(BF16)
        biases[name] = F.pad(b.float(), (0, pad))
    plan_res = max(sum(len(own[n][b]) * shapes[n][2] for n in MATRICES) for b in range(blocks))
    plan_bres = max(sum(len(own[n][b]) * ROWS for n in MATRICES) for b in range(blocks))
    dev = frags["p1"].device
    wres = torch.zeros(blocks, plan_res, 32, 8, dtype=BF16, device=dev)
    bres = torch.zeros(blocks, plan_bres, device=dev)
    for b in range(blocks):
        parts = [frags[n][t] for n in MATRICES for t in own[n][b]]
        if parts:
            flat = torch.cat(parts)
            wres[b, :flat.shape[0]] = flat
            bb = torch.cat([biases[n][ROWS * t:ROWS * (t + 1)] for n in MATRICES
                            for t in own[n][b]])
            bres[b, :bb.shape[0]] = bb
    cache[blocks] = {"w": wres.contiguous(), "b": bres.contiguous()}
    return cache[blocks]


_ARGTYPES = {
    "taco1_decode": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
                     ctypes.c_void_p, ctypes.c_int],
}


def _lib():
    lib = cuda_build.load("taco1_decode")
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def _blocks(dev) -> int:
    """Blocks a launch: one an SM."""
    return _sm_count(dev)


def _check_inputs(w, enc_out, pinp, mask, norm, r):
    if enc_out.device.type != "cuda":
        raise ValueError("tacotron1_decode_cuda takes CUDA tensors")
    if w["dtype"] != BF16:
        raise ValueError("the decode kernel runs bf16 weights")
    if norm not in ("sigmoid", "softmax"):
        raise ValueError(f"unknown attention norm {norm!r}")
    d = _dims(w, r)
    B, T, E_in = enc_out.shape
    if E_in != d["E"] or tuple(pinp.shape) != (B, T, d["A"]) or tuple(mask.shape) != (B, T):
        raise ValueError(f"shape mismatch: enc_out {tuple(enc_out.shape)}, "
                         f"pinp {tuple(pinp.shape)}, mask {tuple(mask.shape)}")
    if B < 1 or T < 1:
        raise ValueError(f"empty batch: B={B}, T={T}")
    for k, v in w.items():
        if isinstance(v, torch.Tensor) and v.device != enc_out.device:
            raise ValueError(f"decode weight {k} is on {v.device}, "
                             f"inputs on {enc_out.device}")


def _launch(w, enc_out, pinp, mask, *, r, max_steps, norm, thresh, prenet_dropout, seed,
            chunk, probe, row0=0):
    """One launch of the kernel (probe 0 serves) over rows of the batch
    whose first is batch row `row0`; returns (out, aligns, stops, steps ran,
    the profile's cycles or None)."""
    _check_inputs(w, enc_out, pinp, mask, norm, r)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    d = w["dims"]
    B, T, E = enc_out.shape
    dev = enc_out.device
    G = _blocks(dev)
    plan = launch_plan(d, B, T, G)
    pk = pack_weights(w, G)
    OW = d["OW"]
    enc = F.pad(enc_out.to(BF16), (0, plan["E16"] - E)).contiguous()
    pinp = pinp.to(F32).contiguous()
    maskadd = torch.where(mask, 0.0, -1e9).to(F32).contiguous()
    zb = lambda *s: torch.zeros(*s, device=dev, dtype=BF16)  # noqa: E731
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    D16 = plan["D16"]
    stage = [zb(2, B, plan["NQ16"]), zb(B, plan["P116"]), zb(B, plan["P216"]),
             zb(B, plan["H16"]), zb(B, plan["E16"])] + [zb(B, D16) for _ in range(5)]
    state = [z(B, D16), z(B, D16), z(B, T), z(B, T), z(2, B), z(B, d["A"]), z(B, T)]
    n_steps = -(-max_steps // chunk) * chunk
    out = torch.empty(n_steps, B, OW, device=dev)
    aligns = torch.empty(n_steps, B, T, device=dev)
    stops = torch.empty(n_steps, B, device=dev)
    ran = torch.zeros(1, device=dev, dtype=torch.int32)
    prof = (torch.zeros(G, len(ROUNDS), 2, device=dev) if probe == _PROFILE else None)
    ptrs = [pk["w"], pk["b"], w["u"], w["v_w"], enc, pinp, maskadd] + stage + state \
        + [out, aligns, stops, ran, prof]
    vals = dict(plan, B=B, T=T, NT=plan["tiles"], NM=d["NM"], NQ=d["NQ"], NMr=d["NM"] * r,
                P1=d["P1"], P2=d["P2"], H=d["H"], D=d["D"], A=d["A"], K=d["K"], OW=OW,
                steps=n_steps, chunk=chunk, softmax=int(norm == "softmax"),
                dropout=int(bool(prenet_dropout)), row0=row0)
    mats = [plan["matrices"][name] for name in MATRICES]
    dims = ([int(vals[k]) for k in _DIMS] + [m[i] for i in range(4) for m in mats]
            + plan["ks"] + [G, plan["smem_bytes"]])
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*[0 if t is None else t.data_ptr() for t in ptrs])
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_fl = (ctypes.c_float * 2)(float(w["v_b"]), float(thresh))
    with cuda_build.on_device(dev) as stream:
        err = _lib().taco1_decode(c_ptrs, c_dims, c_fl, seed & 0xFFFFFFFF, stream, probe)
    if err == -1:
        raise RuntimeError("the decode kernel's grid cannot be co-resident")
    cuda_build.check(err, "taco1_decode")
    return out, aligns, stops, ran, prof


def tacotron1_decode_cuda(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                          norm: str = "sigmoid", thresh: float = 0.6,
                          prenet_dropout: bool = True, seed: int = 0, chunk: int = 50):
    """The decode as one persistent launch on the current stream
    (csrc/taco1_decode.cu); the steps that ran come back in a device int,
    read once after the launch. A batch that `batch_slices` cuts runs a
    launch a slice (`run_slices`)."""
    _check_inputs(w, enc_out, pinp, mask, norm, r)
    B, T, _ = enc_out.shape
    slices = batch_slices(w["dims"], B, T, _blocks(enc_out.device), plan=launch_plan)
    kw = dict(r=r, norm=norm, thresh=thresh, prenet_dropout=prenet_dropout, seed=seed,
              probe=0)

    def run(b0, b1, steps, every):
        got = _launch(w, enc_out[b0:b1], pinp[b0:b1], mask[b0:b1], max_steps=steps,
                      chunk=every, row0=b0, **kw)
        tacotron1_decode_cuda.launches += 1
        return got

    return run_slices(slices, run, max_steps, chunk, thresh)


tacotron1_decode_cuda.launches = 0


def tacotron1_decode_probe_cuda(w: dict, enc_out, pinp, mask, probe: str, *, r: int,
                                max_steps: int, norm: str = "sigmoid", seed: int = 0,
                                chunk: int = 50):
    """A probe launch: the same grid and barriers with every part of a step
    left out but `probe`'s ("barriers_only", "copies_only": the stage-input
    copies, "dots_only": the products on the resident weights). It runs
    every step; its outputs mean nothing, its time is the measurement."""
    _launch(w, enc_out, pinp, mask, r=r, max_steps=max_steps, norm=norm, thresh=0.6,
            prenet_dropout=False, seed=seed, chunk=chunk, probe=PROBES[probe])


def tacotron1_decode_profile_cuda(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                                  norm: str = "sigmoid", thresh: float = 0.6,
                                  prenet_dropout: bool = True, seed: int = 0,
                                  chunk: int = 50) -> dict:
    """The serving decode with every round timed on the SMs' clocks
    (`round_profile`). Not counted as a launch."""
    return round_profile(lambda: _launch(
        w, enc_out, pinp, mask, r=r, max_steps=max_steps, norm=norm, thresh=thresh,
        prenet_dropout=prenet_dropout, seed=seed, chunk=chunk, probe=_PROFILE), ROUNDS)


def tacotron1_decode(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                     norm: str = "sigmoid", thresh: float = 0.6,
                     prenet_dropout: bool = True, seed: int = 0, chunk: int = 50):
    """Free-running Tacotron(1) decode. w: `prepare_weights` output on the
    inputs' device; enc_out [B, T, E] encoder memory; pinp [B, T, A] = W_k m;
    mask [B, T] bool. Returns (frames [max_steps, B, n_mels * r_init],
    alignments [max_steps, B, T], stop probabilities [max_steps, B], lengths
    [B] in r-groups). CPU tensors run the plain version, CUDA tensors the
    kernel."""
    fn = tacotron1_decode_plain if enc_out.device.type == "cpu" else tacotron1_decode_cuda
    return fn(w, enc_out, pinp, mask, r=r, max_steps=max_steps, norm=norm, thresh=thresh,
              prenet_dropout=prenet_dropout, seed=seed, chunk=chunk)
