"""Tacotron2 free-running decode: the CUDA kernel (csrc/taco2_decode.cu), its
plain PyTorch version, and the weight layout both read.

Counterpart of the JAX package's ops/pallas/taco2_decode.py
`tacotron2_decode_pallas` with every attention it serves: location-sensitive
attention with sigmoid or softmax norm, location features on or off, and
its options (windowing, forward attention with the transition agent and the
forward mask), or Graves GMM attention (weights prepared with `graves=`);
original or BN-folded prenet with the hash-PRNG dropout. Same arguments,
same outputs: time-major frames [steps, B, n_mels * r_init], alignments
[steps, B, T], stop probabilities [steps, B] and lengths [B] in r-groups.

Semantics of the Pallas route, which both versions keep:
- every `chunk` steps the done mask is read once (by the host in the plain
  version, on the device in the kernel); once every row is done the
  remaining chunks are zero;
- within a chunk a row that is done keeps advancing its LSTM and attention
  state and still writes its alignment and stop probability; only its
  output frame and its fed-back frame are zero;
- prenet dropout draws from the hash PRNG keyed by (seed, step), salts 11
  and 12, element index row * width + col;
- the stopnet is folded through the projection;
- matrix inputs are rounded to the working dtype (bf16 by default), with
  f32 accumulation, f32 state and f32 outputs;
- the attention options follow the Pallas kernel, not the JAX scan: pads
  and the window's outside get -1e9 energies; the window's centre is the
  first maximum of the last alignment, from 0; forward attention's shift
  reads alpha rounded to the working dtype, its (1 - u) alpha term f32;
  the transition agent's products take rounded inputs; the forward mask
  zeroes alpha more than one position behind its first maximum, then adds
  1e-8; Graves's mixture is f32 over its l1 / l2 products' rounded inputs;
- stream state (`stream=`, `return_stream`): a previous text chunk's
  ((h1, c1), (h2, c2), frame) seeds the LSTMs and the fed-back frame while
  attention (alignments, alpha, the window, Graves's means), context and
  the done mask start afresh; the state after the last step run comes
  back, frozen at the all-done chunk boundary where every row stopped,
  else after ceil(max_steps / chunk) * chunk steps.

`tacotron2_decode` runs the plain version for a CPU tensor and the kernel
for a CUDA tensor; the kernel wrapper raises on what it does not take and
never falls back. The kernel is one persistent launch a decode
(`launch_plan`, `pack_weights`); it checks the early exit on the device and
writes how many steps ran, which the wrapper reads once. A batch too large
for one launch's shared memory runs as slices of whole batch tiles
(`batch_slices`), a launch each.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build
from .prng import step_key, uniform

F32 = torch.float32
BF16 = torch.bfloat16


def _round_up(n: int, m: int = 8) -> int:
    return (n + m - 1) // m * m


def _interleave_gates(w):
    """[4H, ...] stacked (i, f, g, o) blocks -> rows 4 * j + g."""
    H = w.shape[0] // 4
    return w.reshape(4, H, *w.shape[1:]).transpose(0, 1).reshape(4 * H, *w.shape[1:])


def _rows(w, dtype):
    """Weight [out, in] -> `dtype` rows padded to a multiple of 8 columns
    (16-byte rows for the kernel's vector loads)."""
    return F.pad(w.detach().to(F32), (0, _round_up(w.shape[1]) - w.shape[1])) \
        .to(dtype).contiguous()


@torch.no_grad()
def prepare_weights(prenet, attention_rnn, query_w, loc_u, v_w, v_b,
                    decoder_rnn, projection, stopnet, *, dtype=BF16, trans_agent=None,
                    graves=None) -> dict:
    """Lay the decoder's weights out for the decode, once per load.

    prenet: [(weight [P, in], bias [P]), ...] (two layers, BN already
    folded); attention_rnn / decoder_rnn: (weight_ih, weight_hh, bias) with
    torch gate order; query_w [A, H1]; loc_u [2, K, A] folded location
    filter or None; v_w [1, A], v_b [1]; projection (weight [OW, H2 + E],
    bias); stopnet (weight [1, H2 + OW], bias); trans_agent: the transition
    agent's (weight [1, E + H1], bias [1]) or None. graves: Graves
    attention's (l1 weight [H1, H1], l1 bias, l2 weight [3K, H1], l2 bias)
    in place of query_w, loc_u, v_w and v_b (None each); its l1 takes the
    query product's place (dims A = H1) and dims GK = K (0 otherwise).

    Every matrix is [out, in] in `dtype`; LSTM gate rows are interleaved so
    that rows 4j..4j+3 are unit j's i, f, g, o over inputs [x | ctx | h];
    the projection gets the stop row appended, folded through it
    (stop([h2, proj(h2, ctx)]) = W_eff [h2 | ctx] + b_eff). Biases, v and the
    state stay f32."""
    (p1_w, p1_b), (p2_w, p2_b) = prenet
    a_ih, a_hh, a_b = attention_rnn
    d_ih, d_hh, d_b = decoder_rnn
    proj_w, proj_b = (t.detach().to(F32) for t in projection)
    stop_w, stop_b = (t.detach().to(F32) for t in stopnet)
    H1, H2 = a_hh.shape[1], d_hh.shape[1]
    OW = proj_w.shape[0]
    dev = a_hh.device
    f32 = lambda t: t.detach().to(F32).contiguous()  # noqa: E731
    att = {}
    if graves is not None:
        l1_w, l1_b, l2_w, l2_b = graves
        query_w = l1_w
        loc_u, v_w, v_b = torch.zeros(2, 1, 1, device=dev), torch.zeros(1, 1, device=dev), \
            torch.zeros(1, device=dev)
        att = {"g1_b": f32(l1_b), "g2_w": _rows(l2_w, dtype), "g2_b": f32(l2_b)}
    A = query_w.shape[0]
    if loc_u is None:
        loc_u = torch.zeros(2, 1, A, device=dev)
    if trans_agent is not None:
        att.update(ta_w=_rows(trans_agent[0], dtype), ta_b=float(trans_agent[1][0]))
    so = stop_w[0, H2:]
    stop_w_eff = so @ proj_w
    stop_w_eff[:H2] += stop_w[0, :H2]
    stop_b_eff = stop_b + proj_b @ so
    return {
        "dtype": dtype,
        "dims": {"n_in": p1_w.shape[1], "P": p1_w.shape[0], "H1": H1,
                 "H2": H2, "E": d_ih.shape[1] - H1, "A": A,
                 "K": loc_u.shape[1], "OW": OW,
                 "GK": 0 if graves is None else graves[2].shape[0] // 3},
        "p1_w": _rows(p1_w, dtype), "p1_b": f32(p1_b),
        "p2_w": _rows(p2_w, dtype), "p2_b": f32(p2_b),
        "a_w": _rows(_interleave_gates(torch.cat([a_ih, a_hh], 1)), dtype),
        "a_b": f32(_interleave_gates(a_b)),
        "q_w": _rows(query_w, dtype),
        "u": loc_u.detach().to(F32).to(dtype).contiguous(),
        "v_w": f32(v_w[0]), "v_b": float(v_b[0]),
        "d_w": _rows(_interleave_gates(torch.cat([d_ih, d_hh], 1)), dtype),
        "d_b": f32(_interleave_gates(d_b)),
        "o_w": _rows(torch.cat([proj_w, stop_w_eff[None]], 0), dtype),
        "o_b": f32(torch.cat([proj_b, stop_b_eff])),
        **att,
    }


# attention routes: location-sensitive with no option that acts, with
# windowing or forward attention, Graves
LOCATION, OPTIONS, GRAVES = 0, 1, 2


# the attention options as the decode functions take them, and their defaults
ATTN_OPTIONS = dict(windowing=False, win_back=1, win_front=3, forward_attn=False,
                    trans_agent=False, forward_attn_mask=False)


def attn_options(attn: dict) -> dict:
    """The attention options `attn` over their defaults (`ATTN_OPTIONS`);
    an unknown one raises."""
    unknown = set(attn) - set(ATTN_OPTIONS)
    if unknown:
        raise TypeError(f"unknown attention options {sorted(unknown)}")
    return dict(ATTN_OPTIONS, **attn)


def attention_route(w: dict, **attn) -> int:
    """The route a decode with the attention options `attn` takes on these
    weights; raises on a combination neither version serves. The
    transition agent and the forward mask act only with forward attention,
    as in the reference."""
    o = attn_options(attn)
    if w["dims"]["GK"]:
        if o["windowing"] or o["forward_attn"] or o["trans_agent"] or o["forward_attn_mask"]:
            raise ValueError("Graves attention takes none of the location-sensitive "
                             "attention's options")
        return GRAVES
    if o["forward_attn"] and o["trans_agent"] and "ta_w" not in w:
        raise ValueError("the transition agent needs its weights: "
                         "prepare_weights(..., trans_agent=(weight, bias))")
    return OPTIONS if o["windowing"] or o["forward_attn"] else LOCATION


def first_fork(got_aligns, ref_aligns):
    """The first step at which two decodes' first maxima of a row's
    alignment ([steps, B, T]) differ, or None."""
    differ = (got_aligns.argmax(-1) != ref_aligns.argmax(-1)).any(-1).nonzero()
    return int(differ[0]) if len(differ) else None


def held_steps(got, ref, premask=None, **attn):
    """How far a kernel decode `got` must agree with the plain one `ref`
    (`tacotron2_decode`'s outputs) under the attention options `attn`:
    (steps, the fork or None, the fork's tie gap or None). Without
    windowing or the forward mask nothing takes a maximum: every step. The
    window's centre is the first maximum of the previous alignment, so a
    tie in sums taken in another order may fork the trajectories; the
    fork's own step ran with the same centre and is held too. The forward
    mask acts on its own step's first maximum: its fork step is held only
    as a tie, the gap between the plain version's alignment before the mask
    (`premask`, from `tacotron2_decode_plain`) at the kernel's first maximum
    and at its own, the largest over the rows that fork."""
    o = attn_options(attn)
    steps = ref[1].shape[0]
    if not (o["windowing"] or o["forward_attn_mask"]):
        return steps, None, None
    fork = first_fork(got[1], ref[1])
    if fork is None:
        return steps, None, None
    if not o["forward_attn_mask"]:
        return fork + 1, fork, None
    pre = premask[fork]
    k, p = got[1][fork].argmax(-1).to(pre.device), ref[1][fork].argmax(-1).to(pre.device)
    rows = (k != p).nonzero()[:, 0]
    gap = (pre[rows, p[rows]] - pre[rows, k[rows]]).abs().max()
    return fork, fork, float(gap)


def _stream_in(stream, B: int, dims: dict, dev) -> list:
    """((h1, c1), (h2, c2), frame) -> [h1, c1, h2, c2, frame] as float32
    copies, checked against the batch and the decoder's widths."""
    (h1, c1), (h2, c2), frame = stream
    H1, H2, NM = dims["H1"], dims["H2"], dims["n_in"]
    want = [(B, H1), (B, H1), (B, H2), (B, H2), (B, NM)]
    got = []
    for name, t, shape in zip(("h1", "c1", "h2", "c2", "frame"), (h1, c1, h2, c2, frame), want):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"stream {name} is {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {dev}")
        got.append(t.to(F32, memory_format=torch.contiguous_format, copy=True))
    return got


def _drive(n_steps: int, chunk: int, step, all_done) -> int:
    """Run step(s) for s < n_steps; at each chunk boundary stop once every
    row is done. Returns the number of steps run."""
    for s in range(n_steps):
        if s and s % chunk == 0 and all_done(s):
            return s
        step(s)
    return n_steps


def _finish(out, aligns, stops, ran: int, max_steps: int, thresh: float):
    """Zero the skipped chunks, cut to max_steps, and count each row's
    length in r-groups: a step counts while the row was active at its
    start (the stop token's own step counts)."""
    out[ran:].zero_()
    aligns[ran:].zero_()
    stops[ran:].zero_()
    out, aligns, stops = out[:max_steps], aligns[:max_steps], stops[:max_steps]
    done_before = torch.cumsum((stops > thresh).to(torch.int32), 0) > 0
    done_at_start = torch.cat([torch.zeros_like(done_before[:1]), done_before[:-1]])
    lengths = (~done_at_start).sum(0)
    return out, aligns, stops, lengths


def alignment_plain(h, att, cum, q_w, u, v_w, v_b: float, pinp, maskadd, norm: str, rnd,
                    window=None):
    """One location-sensitive alignment of the plain decodes: query
    h [B, H] against q_w [A, H]; location features from the folded filter
    u [2, K, A] over the rounded [att, cum]; energies, -1e9 at pads and, with
    window = (lo, hi) ([B, 1] each), outside [lo, hi]; sigmoid or softmax
    norm. Returns the alignment [B, T]."""
    K = u.shape[1]
    pad = (K - 1) // 2
    pq = rnd(h) @ q_w.T                                   # [B, A]
    loc = F.conv1d(F.pad(rnd(torch.stack([att, cum], 1)), (pad, K - 1 - pad)),
                   u.permute(2, 0, 1)).transpose(1, 2)    # [B, T, A]
    e = (torch.tanh(pq[:, None, :] + loc + pinp) * v_w).sum(-1) + v_b
    e = e + maskadd
    if window is not None:
        e = window_energies(e, *window)
    if norm == "softmax":
        return torch.softmax(e, -1)
    sg = torch.sigmoid(e)
    return sg / sg.sum(-1, keepdim=True).clamp_min(1e-8)


def window_energies(e, lo, hi):
    """Windowing at inference: energies [B, T] outside [lo, hi] ([B, 1]
    each, the window around the previous alignment's first maximum) set to
    -1e9, which the sigmoid or softmax norm maps to 0. The plain decodes
    and the attention's step (models/attention.py) both window through
    it."""
    t = torch.arange(e.shape[1], device=e.device)
    return torch.where((t >= lo) & (t <= hi), e, -1e9)


def forward_plain(align, alpha, u, maskadd, mask_ahead: bool, rnd):
    """Forward attention's alpha recursion on the normalised alignment
    [B, T]: the shift of the previous alpha through the working dtype, the
    transition weight u (0.5 or [B, 1]), the forward mask with `mask_ahead`,
    pads zeroed, normalised."""
    shift = F.pad(rnd(alpha)[:, :-1], (1, 0))
    a = ((1.0 - u) * alpha + u * shift + 1e-8) * align
    if mask_ahead:
        t = torch.arange(a.shape[1], device=a.device)
        a = torch.where(t >= a.argmax(-1, keepdim=True) - 1, a, 0.0) + 1e-8
    a = torch.where(maskadd >= -0.5, a, 0.0)
    return a / a.sum(-1, keepdim=True).clamp_min(1e-8)


def softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def graves_plain(h, mu, W: dict, dims: dict, maskadd, rnd):
    """One Graves step: (g, b, k) = l2(tanh(l1(h))) over rounded inputs, the
    mixture over T in f32 from the means mu [B, K] advanced by softplus(k),
    pads zeroed, normalised. Returns (alignment [B, T], mu)."""
    H1, K = dims["H1"], dims["GK"]
    qg = torch.tanh(rnd(h) @ W["q_w"][:, :H1].T + W["g1_b"])
    g, b, k = (rnd(qg) @ W["g2_w"][:, :H1].T + W["g2_b"]).split(K, -1)
    ge = torch.exp(g - g.amax(-1, keepdim=True))
    gw = ge / ge.sum(-1, keepdim=True) + 1e-5
    sig = softplus(b) + 1e-5
    mu = mu + softplus(k)
    t = torch.arange(maskadd.shape[1], device=h.device, dtype=F32)
    align = torch.zeros_like(maskadd)
    for j in range(K):
        z = (mu[:, j:j + 1] - t) / sig[:, j:j + 1]
        align = align + gw[:, j:j + 1] * torch.exp(-0.5 * z * z)
    align = torch.where(maskadd >= -0.5, 0.3989422917366028 * align, 0.0)
    return align / align.sum(-1, keepdim=True).clamp_min(1e-8), mu


def tacotron2_decode_plain(w: dict, enc_out, pinp, mask, *, r: int,
                           max_steps: int, norm: str = "sigmoid",
                           thresh: float = 0.6, prenet_dropout: bool = True,
                           seed: int = 0, chunk: int = 50, stream=None,
                           return_stream: bool = False, premask: list | None = None,
                           **attn):
    """The decode in plain PyTorch ops, on any device: the reference the
    kernel is held against. Arguments as `tacotron2_decode`; with the
    forward mask, a list `premask` gets each step's alignment before the
    mask (normalised, pads zeroed) for `held_steps`."""
    opts = attn_options(attn)
    route = attention_route(w, **opts)
    windowing, forward_attn, trans_agent, forward_attn_mask = (
        opts[k] for k in ("windowing", "forward_attn", "trans_agent", "forward_attn_mask"))
    d = w["dims"]
    NM, P, H1, H2, E, OW = (d[k] for k in ("n_in", "P", "H1", "H2", "E", "OW"))
    rnd = (lambda x: x.to(BF16).float()) if w["dtype"] == BF16 else (lambda x: x)
    W = {k: v.float() for k, v in w.items() if isinstance(v, torch.Tensor)}
    B, T, _ = enc_out.shape
    dev = enc_out.device
    enc = rnd(enc_out.float())
    pinp = None if route == GRAVES else pinp.float()
    maskadd = torch.where(mask, 0.0, -1e9).to(F32)
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    h1, c1, h2, c2, frame = (z(B, H1), z(B, H1), z(B, H2), z(B, H2), z(B, NM)) \
        if stream is None else _stream_in(stream, B, d, dev)
    ctx, att, cum, done = z(B, E), z(B, T), z(B, T), z(B)
    # attention state: alpha from [1, 0, ...], the window's centre, the means
    alpha, centre, mu = F.pad(z(B, T)[:, 1:], (1, 0), value=1.0), z(B, 1), z(B, d["GK"])
    n_steps = -(-max_steps // chunk) * chunk
    out = torch.empty(n_steps, B, OW, device=dev)
    aligns = torch.empty(n_steps, B, T, device=dev)
    stops = torch.empty(n_steps, B, device=dev)

    def lstm(wk, bk, xs, c):
        gates = (rnd(torch.cat(xs, 1)) @ W[wk][:, :sum(x.shape[1] for x in xs)].T
                 + W[bk]).view(B, -1, 4)
        c = torch.sigmoid(gates[..., 1]) * c + torch.sigmoid(gates[..., 0]) * torch.tanh(gates[..., 2])
        return torch.sigmoid(gates[..., 3]) * torch.tanh(c), c

    def dropout(x, key, salt):
        if not prenet_dropout:
            return x
        return torch.where(uniform(tuple(x.shape), key, salt, dev) < 0.5, 0.0, x * 2.0)

    def attend():
        nonlocal alpha, centre, mu
        if route == GRAVES:
            align, mu = graves_plain(h1, mu, W, d, maskadd, rnd)
            return align
        window = ((centre - opts["win_back"], centre + opts["win_front"]) if windowing
                  else None)
        align = alignment_plain(h1, att, cum, W["q_w"][:, :H1], W["u"], W["v_w"], w["v_b"],
                                pinp, maskadd, norm, rnd, window)
        if forward_attn:
            u = 0.5 if not trans_agent else torch.sigmoid(
                rnd(ctx) @ W["ta_w"][0, :E] + rnd(h1) @ W["ta_w"][0, E:E + H1]
                + w["ta_b"])[:, None]
            if forward_attn_mask and premask is not None:
                premask.append(forward_plain(align, alpha, u, maskadd, False, rnd))
            align = alpha = forward_plain(align, alpha, u, maskadd, forward_attn_mask, rnd)
        if windowing:
            centre = align.argmax(-1, keepdim=True).to(F32)
        return align

    def step(s):
        nonlocal h1, c1, h2, c2, ctx, att, cum, frame, done
        key = step_key(seed, s)
        x = torch.relu(rnd(frame) @ W["p1_w"][:, :NM].T + W["p1_b"])
        x = dropout(x, key, 11)
        x = torch.relu(rnd(x) @ W["p2_w"][:, :P].T + W["p2_b"])
        x = dropout(x, key, 12)
        h1, c1 = lstm("a_w", "a_b", [x, ctx, h1], c1)
        align = attend()
        ctx = (align[:, :, None] * enc).sum(1)
        h2, c2 = lstm("d_w", "d_b", [h1, ctx, h2], c2)
        o = rnd(torch.cat([h2, ctx], 1)) @ W["o_w"][:, :H2 + E].T + W["o_b"]
        stop = torch.sigmoid(o[:, OW])
        dec = o[:, :OW] * (1.0 - done)[:, None]
        done = torch.maximum(done, (stop > thresh).to(F32))
        frame = dec[:, NM * (r - 1): NM * r]
        att, cum = align, cum + align
        out[s], aligns[s], stops[s] = dec, align, stop

    ran = _drive(n_steps, chunk, step, lambda s: bool(done.min() > 0))
    got = _finish(out, aligns, stops, ran, max_steps, thresh)
    return (*got, ((h1, c1), (h2, c2), frame)) if return_stream else got


# ---------------------------------------------------------------- the kernel

THREADS, WARPS, TILE, BARRIERS = 512, 16, 8, 7
ROWS, KT = 16, 16          # a tensor-core tile: 16 weight rows x 16 columns
# the products of a step, in the kernel's order (csrc/taco2_decode.cu):
# (round, matrix, input segment)
PRODUCTS = ("R1 p1 frame", "R1 p2 x1", "R2 a x", "R3 q h1", "R3 d h1", "R4 a h1",
            "R6 d ctx", "R6 o ctx", "R6 a ctx", "R7 o h2", "R7 d h2")
PROBES = {"barriers_only": 1, "copies_only": 2, "dots_only": 3}
_PROFILE = 4
ROUNDS = ("R1 prenet", "R2 a x, cell", "R3 query, d h1", "R4 energies, a h1", "R5 norm, context",
          "R6 d ctx, cell, o ctx, a ctx", "R7 o h2, d h2, stop, location")
# the products of each round that has any (R5 has none), as indices into
# PRODUCTS; R1's two run one after the other
ROUND_PRODUCTS = ((0, 1), (2,), (3, 4), (5,), (6, 7, 8), (9, 10))
# Graves attention's route: l1 takes R3's query product ("R3 q h1" over l1),
# and R4 adds its l2 over tanh(l1 h1)
GRAVES_PRODUCT = "R4 g2 qg"
GRAVES_ROUND_PRODUCTS = ROUND_PRODUCTS[:3] + ((5, 11),) + ROUND_PRODUCTS[4:]
MAX_GRAVES_K = 32          # mixture components: one a lane of a warp
_DIMS = ("B", "T", "NT", "NM", "NM16", "P", "P16", "E16", "H1", "H116", "H2", "H216", "A",
         "K", "OW", "r", "KA", "KD", "KO", "steps", "chunk", "softmax", "dropout", "XLD",
         "ALN", "CPB", "PPB", "GA", "GD", "GO", "GP", "GQ", "SLOTS", "WBUF", "WB_ROUNDS",
         "PRE_SMEM", "X2LD", "row0")
SMEM_LIMIT = 232448        # bytes of shared memory a block may use on the H100


def _pad16(n: int) -> int:
    return _round_up(n, KT)


def _segments(w, widths):
    """Columns of w [rows, sum(widths) (+ pad)] cut into segments, each
    zero-padded to a multiple of 16 columns (a tensor-core k-tile)."""
    out, c = [], 0
    for n in widths:
        out.append(F.pad(w[:, c:c + n], (0, _pad16(n) - n)))
        c += n
    return torch.cat(out, 1)


def _rows16(w):
    """Rows zero-padded to a multiple of 16 (a tensor-core row tile)."""
    n = _round_up(w.shape[0], ROWS) - w.shape[0]
    return F.pad(w, (0, 0, 0, n) if w.dim() == 2 else (0, n))


def fragment_order(m):
    """[R, K] (multiples of 16) -> [R/16, K/16, 32, 8]: each 16 x 16 tile
    in the register order of mma.sync.m16n8k16's A operand, so that lane L
    loads its four registers as one 16-byte vector: rows g and g + 8
    (g = L / 4), columns 2q, 2q + 1 and 2q + 8, 2q + 9 (q = L % 4), as
    (g, 2q..), (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..)."""
    R, K = m.shape
    lane = torch.arange(32, device=m.device)
    g, q = lane // 4, lane % 4
    rows = torch.stack([g, g + 8, g, g + 8], 1)[:, :, None].expand(32, 4, 2)
    cols = torch.stack([2 * q, 2 * q, 2 * q + 8, 2 * q + 8], 1)[:, :, None] \
        + torch.arange(2, device=m.device)
    tiles = m.reshape(R // ROWS, ROWS, K // KT, KT).permute(0, 2, 1, 3)
    return tiles[:, :, rows, cols].reshape(R // ROWS, K // KT, 32, 8)


@torch.no_grad()
def pack_weights(w: dict) -> dict:
    """The kernel's layout of `prepare_weights` output, kept in w["packed"]:
    every matrix's input segments ([x | ctx | h1] for a_w, [h1 | ctx | h2]
    for d_w, [h2 | ctx] for the projection) zero-padded to a multiple of 16
    columns, so that each segment starts on a k-tile and the staged inputs
    of a round line up with it; rows zero-padded to a multiple of 16 (a row
    tile; four LSTM units' gates, interleaved by prepare_weights); each
    matrix in `fragment_order`; biases padded alike."""
    if "packed" in w:
        return w["packed"]
    d = w["dims"]
    NM, P, H1, H2, E = (d[k] for k in ("n_in", "P", "H1", "H2", "E"))
    cut = lambda k, n: w[k][:, :n]  # noqa: E731
    frag = lambda k, widths: fragment_order(  # noqa: E731
        _rows16(_segments(cut(k, sum(widths)), widths)))
    pk = {
        "p1": frag("p1_w", [NM]), "p2": frag("p2_w", [P]), "a": frag("a_w", [P, E, H1]),
        "q": frag("q_w", [H1]), "d": frag("d_w", [H1, E, H2]), "o": frag("o_w", [H2, E]),
        "u": w["u"],
        "p1_b": _rows16(w["p1_b"]), "p2_b": _rows16(w["p2_b"]), "a_b": _rows16(w["a_b"]),
        "d_b": _rows16(w["d_b"]), "o_b": _rows16(w["o_b"]), "v_w": w["v_w"],
    }
    if "ta_w" in w:                 # [ctx | h1], each segment padded to 16 columns
        pk["ta"] = _segments(cut("ta_w", E + H1), [E, H1])[0]
    if d["GK"]:
        pk.update(g1_b=_rows16(w["g1_b"]), g2=frag("g2_w", [H1]), g2_b=_rows16(w["g2_b"]))
    w["packed"] = {k: v.contiguous() for k, v in pk.items()}
    return w["packed"]


def launch_plan(dims: dict, B: int, T: int, sms: int, route: int = LOCATION) -> dict:
    """The persistent kernel's launch plan on `sms` SMs: one block of 512
    threads an SM; batch tiles of 8 rows (the n of mma.m16n8k16); for each
    product the 16-row tiles a block owns at most (the prenet's first
    layer: all of them, on the blocks of its second) and the k-tile slices
    an item takes (enough items for the 16 warps); the attention's (row, t)
    pairs and context chunks a block; shared memory bytes, as the kernel
    lays them out. `route` (`attention_route`) adds the options' state (a
    row's alpha and window centre, for the rows a block's context chunks
    touch) or Graves's (its l2 product in R4 over the staged [h1 | qg], its
    means; no location features or W_k m)."""
    NM, P, H1, H2, E, A, K, OW = (dims[k] for k in ("n_in", "P", "H1", "H2", "E", "A",
                                                    "K", "OW"))
    graves = route == GRAVES
    G = sms
    NM16, P16, E16, H116, H216 = (_pad16(n) for n in (NM, P, E, H1, H2))
    gpb = lambda tiles: -(-tiles // G)  # noqa: E731
    tp, ta, tq, td = (-(-n // ROWS) for n in (P, 4 * H1, A, 4 * H2))
    to = -(-(OW + 1) // ROWS)
    products = [(tp, NM16 // KT), (tp, P16 // KT), (ta, P16 // KT), (tq, H116 // KT),
                (td, H116 // KT), (ta, H116 // KT), (td, E16 // KT), (to, E16 // KT),
                (ta, E16 // KT), (to, H216 // KT), (td, H216 // KT)]
    names, rounds = PRODUCTS, ROUND_PRODUCTS
    if graves:
        products.append((-(-3 * dims["GK"] // ROWS), H116 // KT))
        names, rounds = PRODUCTS + (GRAVES_PRODUCT,), GRAVES_ROUND_PRODUCTS
    per_block = [tp] + [gpb(t) for t, _ in products[1:]]
    NT = -(-B // TILE)
    CE = E16 // 8
    CPB = -(-(B * CE) // G)
    xld = max(NM16, P16, H116, E16, H216, E16 + H116)     # E16 + H116: the prologue
    if graves:
        xld = max(xld, 2 * H116)                           # R4's [h1 | qg]
    plan = {
        "blocks": G, "threads": THREADS, "barriers_per_step": BARRIERS, "tiles": NT,
        "NM16": NM16, "P16": P16, "E16": E16, "H116": H116, "H216": H216,
        "KA": (P16 + E16 + H116) // KT, "KD": (H116 + E16 + H216) // KT,
        "KO": (H216 + E16) // KT,
        # the staged tile's row stride: 8 bf16 past a multiple of 16, so
        # that the 8 rows of a B-fragment load fall in distinct banks
        "XLD": xld + 8,
        "GA": gpb(ta), "GD": gpb(td), "GO": gpb(to), "GP": gpb(tp), "GQ": gpb(tq),
        "PPB": -(-(B * T) // G), "CPB": CPB, "ALN": min(B, -(-CPB // CE) + 1),
        "X2LD": P16 + 8,
        "ks": [max(1, min(WARPS // max(g, 1), n)) for g, (_, n) in zip(per_block, products)],
        "tiles_per_block": dict(zip(names, per_block)),
    }
    # an item's 16 x 8 sums go to a slot of its own, summed in a fixed order
    items = [g * k for g, k in zip(per_block, plan["ks"])]
    plan["SLOTS"] = max([max(items[0], items[1])]                 # R1: one after the other
                        + [sum(items[i] for i in r) for r in rounds[1:]])
    seg = lambda n: -(-n // 16) * 16  # noqa: E731
    acc_tiles = plan["GA"] + plan["GD"] + plan["GO"] + max(plan["GP"], plan["GQ"])
    bias_rows = ROWS * (plan["GA"] + plan["GD"] + plan["GO"] + tp + plan["GP"])
    cells = 4 * (plan["GA"] + plan["GD"]) * NT * TILE
    # the location features' filter, v and the warps' filter windows
    loc = 0 if graves else seg(2 * K * A * 4) + seg(A * 4) + WARPS * 2 * _round_up(K, 32) * 4
    state = {LOCATION: 0, OPTIONS: seg(plan["ALN"] * T * 4) + seg(plan["ALN"] * 4),
             GRAVES: seg(plan["ALN"] * MAX_GRAVES_K * 4)}[route]
    smem = (seg(TILE * plan["XLD"] * 2) + loc
            + acc_tiles * NT * ROWS * TILE * 4 + plan["SLOTS"] * ROWS * TILE * 4
            + seg(bias_rows * 4) + seg(cells * 4) + 2 * seg(plan["ALN"] * T * 4)
            + seg(TILE * plan["X2LD"] * 2) + state)
    # a round's weight tiles of a block (512 bytes a 16 x 16 tile) are
    # prefetched into shared memory during the round before, for every
    # round whose tiles fit what is left; the others read them from L2
    ktiles = [g * n for g, (_, n) in zip(per_block, products)]
    need = [sum(ktiles[i] for i in r) for r in rounds]
    room = max(0, SMEM_LIMIT - smem) // 512
    plan["WB_ROUNDS"] = sum(1 << i for i, n in enumerate(need) if n <= room)
    plan["WBUF"] = max([n for n in need if n <= room], default=0)
    smem += plan["WBUF"] * 512
    # the block's pairs' W_k m + location stay in shared memory when they fit
    pre = 0 if graves else seg(plan["PPB"] * A * 4)
    plan["PRE_SMEM"] = int(not graves and smem + pre <= SMEM_LIMIT)
    plan["smem_bytes"] = smem + pre * plan["PRE_SMEM"]
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"the decode kernel needs {plan['smem_bytes']} bytes of shared memory "
                         f"a block at these widths and B={B} (at most {SMEM_LIMIT})")
    # weights a block reads from L2 every step (its row tiles of every matrix)
    plan["weight_bytes_per_block"] = 2 * ROWS * KT * sum(ktiles)
    # stage inputs copied into every block every step
    plan["staged_bytes_per_block"] = 2 * TILE * NT * (NM16 + P16 + H116 + H116 + E16 + H216
                                                      + (H116 if graves else 0))
    return plan


def batch_slices(dims: dict, B: int, T: int, sms: int, plan=None) -> list[tuple[int, int]]:
    """Rows [b0, b1) of each launch: the whole batch where its plan (`plan`,
    this kernel's `launch_plan` unless given) fits shared memory, else the
    fewest slices of whole batch tiles that fit, as even as the tiles
    allow. Raises where one tile does not fit."""
    plan = plan or launch_plan

    def fits(n):
        try:
            plan(dims, n, T, sms)
            return True
        except ValueError:
            return False

    if fits(B):
        return [(0, B)]
    lo, hi = 0, -(-B // TILE)             # tiles: lo fit (0 trivially), hi do not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid * TILE) else (lo, mid)
    if lo == 0:
        plan(dims, min(B, TILE), T, sms)          # raises: not even one tile fits
    n = -(-B // (lo * TILE))
    size = _round_up(-(-B // n), TILE)    # <= lo * TILE
    return [(b0, min(B, b0 + size)) for b0 in range(0, B, size)]


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_ARGTYPES = {
    "taco2_decode": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
                     ctypes.c_void_p, ctypes.c_int],
}


def _lib():
    lib = cuda_build.load("taco2_decode")
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def _check_inputs(w, enc_out, pinp, mask, norm, attn: dict) -> int:
    """Raise on what the kernel does not take; the attention route of the
    options `attn` (`ATTN_OPTIONS`) on these weights."""
    if enc_out.device.type != "cuda":
        raise ValueError("tacotron2_decode_cuda takes CUDA tensors")
    route = attention_route(w, **attn)
    if w["dtype"] != BF16:
        raise ValueError("the decode kernel runs bf16 weights")
    if norm not in ("sigmoid", "softmax"):
        raise ValueError(f"unknown attention norm {norm!r}")
    d = w["dims"]
    B, T, E_in = enc_out.shape
    want_pinp = None if route == GRAVES else (B, T, d["A"])
    if (E_in != d["E"] or (pinp if pinp is None else tuple(pinp.shape)) != want_pinp
            or tuple(mask.shape) != (B, T)):
        raise ValueError(f"shape mismatch: enc_out {tuple(enc_out.shape)}, pinp "
                         f"{None if pinp is None else tuple(pinp.shape)} (expected "
                         f"{want_pinp}), mask {tuple(mask.shape)}")
    if B < 1 or T < 1:
        raise ValueError(f"empty batch: B={B}, T={T}")
    if not 0 <= d["GK"] <= MAX_GRAVES_K:
        raise ValueError(f"the decode kernel takes 1-{MAX_GRAVES_K} Graves components, "
                         f"got {d['GK']}")
    for k, v in w.items():
        if isinstance(v, torch.Tensor) and v.device != enc_out.device:
            raise ValueError(f"decode weight {k} is on {v.device}, "
                             f"inputs on {enc_out.device}")
    return route


def _launch(w, enc_out, pinp, mask, *, r, max_steps, norm, thresh, prenet_dropout, seed,
            chunk, probe, row0=0, stream=None, return_stream=False, **attn):
    """One launch of the kernel (probe 0 serves) over rows of the batch
    whose first is batch row `row0`, from `stream`'s state or zeros; returns
    (out, aligns, stops, steps ran, the profile's cycles or None, the final
    (h1, c1, h2, c2) in f32 with return_stream, else None). Every launch
    fills its own state buffers from `stream`, which it never writes.
    `attn`: the attention options (`ATTN_OPTIONS`); a probe launch takes
    the location route only."""
    o = attn_options(attn)
    route = _check_inputs(w, enc_out, pinp, mask, norm, o)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if probe not in (0, _PROFILE) and route != LOCATION:
        raise ValueError("probe launches take the location route only")
    d = w["dims"]
    B, T, E = enc_out.shape
    dev = enc_out.device
    plan = launch_plan(d, B, T, _sm_count(dev), route)
    pk = pack_weights(w)
    NM, P, H1, H2, A, OW = (d[k] for k in ("n_in", "P", "H1", "H2", "A", "OW"))
    enc = F.pad(enc_out.to(BF16), (0, plan["E16"] - E)).contiguous()
    maskadd = torch.where(mask, 0.0, -1e9).to(F32).contiguous()
    zb = lambda n: torch.zeros(B, n, device=dev, dtype=BF16)  # noqa: E731
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    # the initial state: zeros, or the stream's h and frame rounded to bf16
    # (they feed only products, which round them so) and its cells in f32
    state = [zb(plan["NM16"]), zb(plan["P16"]), zb(plan["P16"]), zb(plan["H116"]),
             zb(plan["H216"]), zb(plan["E16"]), z(B, H1), z(B, H2), z(B, T), z(B, T),
             z(2, B)]
    if stream is not None:
        h1, c1, h2, c2, frame = _stream_in(stream, B, d, dev)
        for buf, t in ((state[0], frame), (state[3], h1), (state[4], h2)):
            buf[:, :t.shape[1]] = t.to(BF16)
        state[6], state[7] = c1, c2
    hf = [z(B, H1), z(B, H2)] if return_stream else [None, None]
    n_steps = -(-max_steps // chunk) * chunk
    out = torch.empty(n_steps, B, OW, device=dev)
    aligns = torch.empty(n_steps, B, T, device=dev)
    stops = torch.empty(n_steps, B, device=dev)
    ran = torch.zeros(1, device=dev, dtype=torch.int32)
    prof = (torch.zeros(plan["blocks"], len(ROUNDS), 2, device=dev) if probe == _PROFILE
            else None)
    if route == GRAVES:
        # no W_k m, energies or location features; l1 h1 as bf16 and the
        # mixture parameters of l2 in their place
        pinp, scratch = None, [None, None, None]
        attn_bufs = [None, pk["g1_b"], pk["g2"], pk["g2_b"], None, zb(plan["H116"]),
                     z(B, 3 * d["GK"])]
    else:
        pinp = pinp.to(F32).contiguous()
        scratch = [z(B, A), z(B, T), z(B, T, A)]
        ta = route == OPTIONS and o["forward_attn"] and o["trans_agent"]
        attn_bufs = [pk["ta"] if ta else None, None, None, None, z(B) if ta else None, None,
                     None]
    ptrs = [pk[k] for k in ("p1", "p2", "a", "q", "d", "o", "u", "p1_b", "p2_b", "a_b",
                            "d_b", "o_b", "v_w")]
    ptrs += ([enc, pinp, maskadd] + state + scratch + [out, aligns, stops, ran, prof] + hf
             + attn_bufs)
    vals = dict(plan, B=B, T=T, NT=plan["tiles"], NM=NM, P=P, H1=H1, H2=H2, A=A, K=d["K"],
                OW=OW, r=r, steps=n_steps, chunk=chunk, softmax=int(norm == "softmax"),
                dropout=int(bool(prenet_dropout)), row0=row0)
    ks = plan["ks"] + [1] * (len(PRODUCTS) + 1 - len(plan["ks"]))     # the l2 product's last
    attn_dims = [route, o["windowing"], o["win_back"], o["win_front"], o["forward_attn"],
                 o["forward_attn"] and o["trans_agent"], o["forward_attn_mask"], d["GK"]]
    dims = ([int(vals[k]) for k in _DIMS] + ks + [plan["blocks"], plan["smem_bytes"]]
            + [int(v) for v in attn_dims])
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*[0 if t is None else t.data_ptr() for t in ptrs])
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_fl = (ctypes.c_float * 3)(float(w["v_b"]), float(thresh), float(w.get("ta_b", 0.0)))
    with cuda_build.on_device(dev) as stream:
        err = _lib().taco2_decode(c_ptrs, c_dims, c_fl, seed & 0xFFFFFFFF, stream, probe)
    if err == -1:
        raise RuntimeError("the decode kernel's grid cannot be co-resident")
    cuda_build.check(err, "taco2_decode")
    final = (hf[0], state[6], hf[1], state[7]) if return_stream else None
    return out, aligns, stops, ran, prof, final


def tacotron2_decode_cuda(w: dict, enc_out, pinp, mask, *, r: int,
                          max_steps: int, norm: str = "sigmoid",
                          thresh: float = 0.6, prenet_dropout: bool = True,
                          seed: int = 0, chunk: int = 50, stream=None,
                          return_stream: bool = False, **attn):
    """The decode as one persistent launch on the current stream; the
    steps that ran come back in a device int, read once after the launch.
    A batch that `batch_slices` cuts runs a launch a slice (`launch_slices`),
    each from its rows of `stream`. The stream out: the launches' final h
    and c, and the fed-back frame, which is the last step's r-th output
    frame (zero for a row that was done). `attn`: the attention options
    (`ATTN_OPTIONS`); a combination the kernel lacks raises."""
    o = attn_options(attn)
    route = _check_inputs(w, enc_out, pinp, mask, norm, o)
    B, T, _ = enc_out.shape
    slices = batch_slices(w["dims"], B, T, _sm_count(enc_out.device),
                          functools.partial(launch_plan, route=route))
    kw = dict(r=r, norm=norm, thresh=thresh, prenet_dropout=prenet_dropout, seed=seed,
              probe=0, return_stream=return_stream, **o)

    def rows(b0, b1):
        if stream is None:
            return None
        (h1, c1), (h2, c2), frame = stream
        return (h1[b0:b1], c1[b0:b1]), (h2[b0:b1], c2[b0:b1]), frame[b0:b1]

    def run(b0, b1, steps, every):
        got = _launch(w, enc_out[b0:b1], None if pinp is None else pinp[b0:b1], mask[b0:b1],
                      max_steps=steps, chunk=every, row0=b0, stream=rows(b0, b1), **kw)
        tacotron2_decode_cuda.launches += 1
        return got

    out, aligns, stops, ran, parts = launch_slices(slices, run, max_steps, chunk)
    NM = w["dims"]["n_in"]
    frame = out[ran - 1, :, NM * (r - 1): NM * r].clone() if return_stream else None
    got = _finish(out, aligns, stops, ran, max_steps, thresh)
    if not return_stream:
        return got
    h1, c1, h2, c2 = (torch.cat([part[5][i] for part in parts]) for i in range(4))
    return (*got, ((h1, c1), (h2, c2), frame))


def launch_slices(slices, run, max_steps: int, chunk: int):
    """The decode of a batch as launches over its slices: run(b0, b1, steps,
    chunk) launches rows [b0, b1) and returns (out, aligns, stops, steps ran
    as a device int, ...). A slice that left before the slowest one runs
    again to its step count, with no exit on the way, so that every row
    advances as far as in one launch (the rows do not interact; the dropout
    keys on the batch row). Returns the whole batch's (out, aligns, stops)
    over ceil(max_steps / chunk) * chunk steps, the steps ran, and each
    slice's last launch's outputs."""
    parts = [run(b0, b1, max_steps, chunk) for b0, b1 in slices]
    rans = [int(part[3].item()) for part in parts]
    ran = max(rans)
    if len(slices) == 1:
        return (*parts[0][:3], ran, parts)
    for i, (b0, b1) in enumerate(slices):
        if rans[i] < ran:
            parts[i] = run(b0, b1, ran, ran)
    out, aligns, stops = (torch.cat([part[j][:ran] for part in parts], 1) for j in range(3))
    n_steps = -(-max_steps // chunk) * chunk
    out, aligns, stops = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, n_steps - ran))
                          for t in (out, aligns, stops))
    return out, aligns, stops, ran, parts


def run_slices(slices, run, max_steps: int, chunk: int, thresh: float):
    """`launch_slices`, then `_finish`'s outputs."""
    out, aligns, stops, ran, _ = launch_slices(slices, run, max_steps, chunk)
    return _finish(out, aligns, stops, ran, max_steps, thresh)


def tacotron2_decode_probe_cuda(w: dict, enc_out, pinp, mask, probe: str, *, r: int,
                                max_steps: int, norm: str = "sigmoid", seed: int = 0,
                                chunk: int = 50):
    """A probe launch: the same grid and barriers with every part of a step
    left out but `probe`'s ("barriers_only", "copies_only": the stage-input
    copies, "dots_only": the products' weight copies and mma). It runs every
    step; its outputs mean nothing, its time is the measurement."""
    _launch(w, enc_out, pinp, mask, r=r, max_steps=max_steps, norm=norm, thresh=0.6,
            prenet_dropout=False, seed=seed, chunk=chunk, probe=PROBES[probe])


def tacotron2_decode_profile_cuda(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                                  norm: str = "sigmoid", thresh: float = 0.6,
                                  prenet_dropout: bool = True, seed: int = 0,
                                  chunk: int = 50, **attn) -> dict:
    """The serving decode with every round timed on the SMs' clocks
    (`round_profile`), on any attention route (`attn`: its options). Not
    counted as a launch."""
    return round_profile(lambda: _launch(
        w, enc_out, pinp, mask, r=r, max_steps=max_steps, norm=norm, thresh=thresh,
        prenet_dropout=prenet_dropout, seed=seed, chunk=chunk, probe=_PROFILE, **attn), ROUNDS)


def round_profile(launch, rounds) -> dict:
    """Run launch(), a profiling launch that returns (..., steps ran, cycles
    [G, rounds, 2]): for each round, the blocks' work (mean and largest
    over the blocks) and their wait at its barrier, in us a step; the
    cycles convert to time by the launch's own duration (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ran, prof = launch()[3:5]
    end.record()
    end.synchronize()
    steps = int(ran.item())
    cycles = prof.sum(dim=(1, 2))                 # every block spans the same loop
    us_per_cycle = start.elapsed_time(end) * 1e3 / float(cycles.mean())
    per = prof * us_per_cycle / steps             # [G, rounds, 2], us a step
    return {"ms": start.elapsed_time(end), "steps": steps,
            "rounds": {name: {"work_mean_us": float(per[:, i, 0].mean()),
                              "work_max_us": float(per[:, i, 0].max()),
                              "wait_mean_us": float(per[:, i, 1].mean())}
                       for i, name in enumerate(rounds)}}


tacotron2_decode_cuda.launches = 0


def tacotron2_decode(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                     norm: str = "sigmoid", thresh: float = 0.6,
                     prenet_dropout: bool = True, seed: int = 0,
                     chunk: int = 50, stream=None, return_stream: bool = False, **attn):
    """Free-running decode. w: `prepare_weights` output on the inputs'
    device; enc_out [B, T, E] encoder memory; pinp [B, T, A] = W_k m (None
    for Graves attention); mask [B, T] bool. Returns (frames
    [max_steps, B, OW], alignments [max_steps, B, T], stop probabilities
    [max_steps, B], lengths [B] in r-groups). stream: a previous text
    chunk's ((h1, c1), (h2, c2), frame) (f32 [B, H1], [B, H2], [B, n_mels])
    to start from; return_stream appends the final such tuple (see the
    module's docstring for when it freezes). attn: the location-sensitive
    attention's options (`ATTN_OPTIONS`: windowing with win_back and
    win_front, forward_attn, trans_agent, forward_attn_mask; the Pallas
    kernel's flags; Graves attention comes with its weights). CPU tensors
    run the plain version, CUDA tensors the kernel."""
    fn = tacotron2_decode_plain if enc_out.device.type == "cpu" else tacotron2_decode_cuda
    return fn(w, enc_out, pinp, mask, r=r, max_steps=max_steps, norm=norm,
              thresh=thresh, prenet_dropout=prenet_dropout, seed=seed,
              chunk=chunk, stream=stream, return_stream=return_stream, **attn)
