"""Tacotron2 teacher-forced training decoder: the CUDA kernels
(csrc/taco2_train.cu), their plain PyTorch versions, and the weight layout
both read.

Counterparts of the JAX package's ops/pallas/taco2_train.py:

- `taco2_train_fwd` (`taco2_train_fwd_pallas`): the teacher-forced scan
  of models/decoder_grad.py forward, attention LSTM -> location-sensitive
  attention -> context -> decoder LSTM over all steps, emitting the
  residuals the backward reads;
- `taco2_train_bwd` (`taco2_train_bwd_pallas`): its reverse-time scan over
  the activation cotangents, emitting the per-step gate, context, prenet and
  energy cotangents (the weight gradients are whole-sequence products
  outside, in models/decoder_grad.py).

Rounding points of the Pallas kernels, which both versions keep: h, c and
the context are held in the working dtype (bf16 on the card) between steps;
gate math and every sum run in float32; gates, cells, dech and the gate /
context / prenet cotangents are stored in the working dtype; alignments,
energy cotangents and the backward carries stay float32; the location
features read the alignment state rounded to the working dtype.

`taco2_train_fwd` / `taco2_train_bwd` run the plain version for CPU tensors
and the kernels for CUDA tensors; the kernel wrappers raise on what they do
not take. Each scan is one C call that issues all of its launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .taco2_decode import _interleave_gates, _round_up, _rows, fragment_order

F32 = torch.float32
BF16 = torch.bfloat16


@torch.no_grad()
def prepare_train_weights(attention_rnn, query_w, loc_conv_w, loc_dense_w, v_w, v_b,
                          decoder_rnn) -> dict:
    """Lay the decoder core's weights out for both kernels, once per
    optimizer step. All matrices keep the dtype they come in (the working
    dtype); biases and v go to float32.

    attention_rnn / decoder_rnn: (weight_ih [4H, in], weight_hh [4H, H],
    bias [4H]) in gate order (i, f, g, o); query_w [A, H1]; loc_conv_w
    [F, 2, K] and loc_dense_w [A, F], or None without location features;
    v_w [1, A], v_b [1].

    Forward: "a_w" / "d_w" [4H, in + H] rows with interleaved gates (row
    4j + g is unit j's gate g over [x | ctx | h]), padded to 8 columns, and
    for bf16 "a_wf" / "d_wf", those in the tensor cores' fragment order
    (`mma_fragments`); backward: "a_wT" / "d_wT" [in + H, 4H], the same
    weights transposed in block gate order, and for bf16 "a_wTf" / "d_wTf",
    those in fragment order; "u" [2, K, A] is the location conv folded with
    the location dense."""
    a_ih, a_hh, a_b = attention_rnn
    d_ih, d_hh, d_b = decoder_rnn
    dtype = a_ih.dtype
    H1, H2, A = a_hh.shape[1], d_hh.shape[1], query_w.shape[0]
    E = d_ih.shape[1] - H1
    loc = loc_conv_w is not None
    if loc:
        u = torch.einsum("fck,af->cka", loc_conv_w.float(), loc_dense_w.float()).to(dtype)
    else:
        u = torch.zeros(2, 1, A, dtype=dtype, device=a_ih.device)
    a_full, d_full = torch.cat([a_ih, a_hh], 1), torch.cat([d_ih, d_hh], 1)
    a_il, d_il = _interleave_gates(a_full), _interleave_gates(d_full)
    frag = {"a_wf": mma_fragments(a_il), "d_wf": mma_fragments(d_il),
            "a_wTf": mma_fragments(a_full.T), "d_wTf": mma_fragments(d_full.T)} \
        if dtype == BF16 else {}
    return {**frag,
        "dtype": dtype, "loc": loc,
        "dims": {"P": a_ih.shape[1] - E, "E": E, "H1": H1, "H2": H2, "A": A,
                 "K": u.shape[1]},
        "a_w": _rows(a_il, dtype),
        "a_b": _interleave_gates(a_b.detach()).float().contiguous(),
        "d_w": _rows(d_il, dtype),
        "d_b": _interleave_gates(d_b.detach()).float().contiguous(),
        "a_wT": _rows(a_full.T, dtype), "d_wT": _rows(d_full.T, dtype),
        "q_w": _rows(query_w, dtype), "u": u.contiguous(),
        "v_w": v_w.detach()[0].float().contiguous(),
        "v_b": v_b.detach().float().reshape(1).contiguous(),
    }


def mma_fragments(m):
    """Any [n, k] matrix (bf16; the forward's interleaved W, the backward's
    W^T) -> [ceil(n/16), ceil(k/16), 32, 8]: zero-padded to 16-row and
    16-column tiles, each in the register order of mma.sync m16n8k16's A
    operand (`taco2_decode.fragment_order`), so that a warp reads one tile
    as 16 bytes a lane. Built on the weights' device."""
    n, k = m.shape
    return fragment_order(F.pad(m.detach(), (0, _round_up(k, 16) - k, 0,
                                             _round_up(n, 16) - n))).contiguous()


MAT_CLUSTER = 8      # blocks a W^T product's cluster splits 4H over, at most (portable)
ATTN_CLUSTER = 4     # blocks of an attention cluster (either scan), at most
FWD_CLUSTER = 4      # blocks a forward LSTM product's cluster splits its inputs over, at most
MAT_WARPS, MAT_NT = 8, 8     # 16-row tiles a product block; n-tiles of 8 rows a batch slice


def _even(n: int, parts: int):
    return [(r * n // parts, (r + 1) * n // parts) for r in range(parts)]


def bwd_plan(dims: dict, B: int, T: int) -> dict:
    """The backward kernel's launch plan (csrc/taco2_train.cu computes the
    same parts from the cluster sizes it is given). For each W^T product
    ("d": rows q | ctx | h2 over 4 H2; "a": prenet | ctx | h1 over 4 H1):
    the cluster (the largest power of two up to MAT_CLUSTER and the k-tiles),
    its row bands of 16 MAT_WARPS rows, each block's k-tile slice, each
    block's share of a band's rows in the cluster's sum, and the batch
    slices of up to 8 MAT_NT rows. For the attention backward: the cluster
    (the largest power of two up to ATTN_CLUSTER and T), and each block's
    even part of the text positions, the attention units and H1."""
    P, E, H1, H2, A = (dims[k] for k in ("P", "E", "H1", "H2", "A"))

    def mat(rows: int, H: int) -> dict:
        k16, rt = -(-4 * H // 16), -(-rows // 16)
        cs = 1
        while 2 * cs <= min(MAT_CLUSTER, k16):
            cs *= 2
        per = -(-k16 // cs)
        band = 16 * MAT_WARPS
        return {"cluster": cs, "k_tiles": k16, "row_tiles": rt, "bands": -(-rt // MAT_WARPS),
                "k_slices": [(min(k16, r * per), min(k16, r * per + per)) for r in range(cs)],
                "sum_rows": _even(band, cs),
                "batch_slices": [(s, min(B, s + 8 * MAT_NT)) for s in range(0, B, 8 * MAT_NT)]}

    cs = 1
    while 2 * cs <= min(ATTN_CLUSTER, T):
        cs *= 2
    return {"d": mat(H1 + E + H2, H2), "a": mat(P + E + H1, H1),
            "attn": {"cluster": cs, "t": _even(T, cs), "a": _even(A, cs),
                     "h1": _even(H1, cs)}}


def _pow2_upto(n: int) -> int:
    """The largest power of two <= n (n >= 1)."""
    return 1 << (n.bit_length() - 1)


def _after_wait(n0: int, n1: int, k16: int, cs: int, rank: int) -> range:
    """`lstm_mma_kernel`'s [kp0, kp1): the local indices, among block
    `rank`'s k-tiles (rank, rank + cs, ...), of the tiles over the context
    columns [n0, n0 + n1), which it multiplies after its wait."""
    nk = -(-(k16 - rank) // cs) if rank < k16 else 0
    kf, kl = n0 // 16, (n0 + n1 - 1) // 16
    kp0 = min(nk, -(-(kf - rank) // cs) if kf > rank else 0)
    return range(kp0, max(kp0, min(nk, (kl - rank) // cs + 1 if kl >= rank else 0)))


def fwd_plan(dims: dict, B: int, T: int) -> dict:
    """The forward kernel's launch plan. The launch takes the two cluster
    sizes from it; csrc/taco2_train.cu derives every part from those with
    the formulas written here once (the tests hold these parts, and the
    emulations run on them). Both LSTM products
    ("a": prenet | ctx | h1 -> 4 H1; "d": q | ctx | h2 -> 4 H2) run in one
    launch, so they share one cluster: the largest power of two up to
    FWD_CLUSTER and either product's k-tiles. For each: its row tiles of 16
    interleaved gate rows in bands of MAT_WARPS, each block's k-tiles
    (rank, rank + cs, ...), of those the ones it multiplies after its wait
    (the context's: their local indices), each block's share of a band's
    units (the four gate rows of each) in the cluster's sum and cell
    update, and the batch slices of up to 8 MAT_NT rows. For the attention:
    the cluster (the largest power of two up to ATTN_CLUSTER and T), and
    each block's even part of the text positions and, in chunks of 8, of H1
    (its part of the query projection) and of E (its columns of the
    context)."""
    P, E, H1, H2 = (dims[k] for k in ("P", "E", "H1", "H2"))
    segs = {"a": (P, E, H1), "d": (H1, E, H2)}
    k16 = {key: -(-sum(s) // 16) for key, s in segs.items()}
    cs = _pow2_upto(min(FWD_CLUSTER, *k16.values()))

    def mat(key: str, H: int) -> dict:
        n0, n1, _ = segs[key]
        rt, units = -(-4 * H // 16), 16 * MAT_WARPS // 4
        return {"k_tiles": k16[key], "row_tiles": rt, "bands": -(-rt // MAT_WARPS),
                "tiles": [list(range(r, k16[key], cs)) for r in range(cs)],
                "after_wait": [list(_after_wait(n0, n1, k16[key], cs, r)) for r in range(cs)],
                "sum_units": _even(units, cs),
                "batch_slices": [(s, min(B, s + 8 * MAT_NT)) for s in range(0, B, 8 * MAT_NT)]}

    acs = _pow2_upto(min(ATTN_CLUSTER, T))
    chunks = lambda n: [(8 * lo, min(n, 8 * hi)) for lo, hi in _even(-(-n // 8), acs)]  # noqa: E731
    return {"cluster": cs, "a": mat("a", H1), "d": mat("d", H2),
            "attn": {"cluster": acs, "t": _even(T, acs), "h1": chunks(H1), "e": chunks(E)}}


SMEM_LIMIT = 232448          # dynamic shared memory a block may use on the H100
Q2_PARTS = 4                 # csrc/taco2_train.cu kQ2Parts


def attn_fwd_smem(T: int, A: int, K: int, H1: int, E: int, cs: int, esize: int):
    """(bytes, staged): a block's dynamic shared memory in the forward's
    attention cluster and whether the encoder's columns are staged in it,
    as csrc/taco2_train.cu `attn_fwd_layout` computes them (the card holds
    this copy against the C function). The rest (the filter, W_k m of the
    block's positions, the alignments of its row, ...) takes about
    4 (8.6k + 1.03 T) bytes at full width; the staged columns take T rows
    of ELD elements, ELD = E / cs rounded to an odd multiple of 16 bytes,
    so the T up to which they fit falls as E grows."""
    Tq = -(-T // cs)
    Jq = -(-(-(-H1 // 8)) // cs) * 8
    Ec = -(-(-(-E // 8)) // cs) * 8
    eld = (Ec * esize // 16 | 1) * 16 // esize
    o = (2 * K + 1) * A + 3 * A + 2 * (Tq + K - 1) + Tq * A + Tq + T + 32 + 4 + 8
    hq = (o + 3) & ~3
    rest = 4 * (hq + (Jq * esize + 15) // 16 * 4)
    enc = T * eld * esize
    staged = rest + enc <= SMEM_LIMIT
    return rest + (enc if staged else 0), staged


def attn_bwd_smem(T: int, A: int, K: int, E: int, ldq: int, H1: int, cs: int, esize: int):
    """A block's dynamic shared memory in the backward's attention cluster,
    as csrc/taco2_train.cu `attn_layout` computes it: the tanh stack
    [A][T / cs] and the location correlation rows dominate, d_ctx keeps E
    floats."""
    Tq = -(-T // cs)
    tld, K2 = Tq | 1, 2 * K
    Jq = -(-H1 // cs)
    o = ((2 * K + 1) * A + 4 * A + 2 * (Tq + K2) + 2 * Tq + 32 + 4 + 4 + A * tld + Tq * K2
         + (Tq + K - 1) * K2 + E + Q2_PARTS * Jq)
    return 4 * ((o + 3) & ~3) + ldq * esize


def t_in_limits(dims: dict, esize: int) -> dict:
    """The text lengths the scans take at these widths and element size
    (2 bf16, 4 float32): "fwd_staged", the longest T_in whose encoder
    columns the forward's attention stages in shared memory; "fwd", the
    longest it runs at all (past the staged limit it reads them from
    global memory); "bwd", the longest the backward's attention runs. Each
    with the attention cluster of 4 blocks that T_in >= 4 gets."""
    A, K, H1, E = (dims[k] for k in ("A", "K", "H1", "E"))
    ldq = -(-H1 // 8) * 8

    def last(ok) -> int:
        T = 4
        while ok(T + 1):
            T += 1
        return T

    return {"fwd_staged": last(lambda T: attn_fwd_smem(T, A, K, H1, E, 4, esize)[1]),
            "fwd": last(lambda T: attn_fwd_smem(T, A, K, H1, E, 4, esize)[0] <= SMEM_LIMIT),
            "bwd": last(lambda T: attn_bwd_smem(T, A, K, E, ldq, H1, 4, esize) <= SMEM_LIMIT)}


def _dims(w):
    d = w["dims"]
    return tuple(d[k] for k in ("P", "E", "H1", "H2", "A", "K"))


def _normalize(e, norm: str):
    """(alignment, s) from masked energies: softmax, or sigmoid over its
    sum (s = sigmoid(e), kept for the backward)."""
    if norm == "softmax":
        a = torch.softmax(e, -1)
        return a, a
    s = torch.sigmoid(e)
    return s / s.sum(-1, keepdim=True).clamp_min(1e-8), s


def _ungate(g, H):
    """Interleaved gates [B, 4H] (unit-major) -> block layout [B, 4H]."""
    return g.view(g.shape[0], H, 4).transpose(1, 2).reshape(g.shape[0], 4 * H)


def _lstm_bwd_local(g, c_prev, c, d_h, d_c):
    """decoder_grad._lstm_bwd_local: backward through the gate nonlinearity
    from the stored pre-activations g [B, 4H] (block layout). Returns
    (d_gates, d_c_prev)."""
    i, f, gg, o = g.chunk(4, dim=-1)
    i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
    tc = torch.tanh(c)
    d_o = d_h * tc
    d_ct = d_c + d_h * o * (1.0 - tc * tc)
    d_g = torch.cat([(d_ct * gg) * i * (1.0 - i), (d_ct * c_prev) * f * (1.0 - f),
                     (d_ct * i) * (1.0 - gg * gg), d_o * o * (1.0 - o)], -1)
    return d_g, d_ct * f


class _Plain:
    """What both plain versions share: float32 views of the layouts and the
    energy recompute."""

    def __init__(self, w: dict, enc, pinp, maskf, norm: str):
        P, E, H1, H2, A, K = _dims(w)
        dt = w["dtype"]
        self.rnd = (lambda x: x.to(BF16).float()) if dt == BF16 else (lambda x: x)
        self.w, self.norm, self.K = w, norm, K
        self.encf = enc.to(dt).float()
        self.pinpf = pinp.to(dt).float()
        self.maskadd = torch.where(maskf > 0.5, 0.0, -1e9).to(F32)
        self.qw = w["q_w"][:, :H1].float()
        self.u_conv = w["u"].float().permute(2, 0, 1)            # [A, 2, K]
        self.pad = (K - 1) // 2

    def energies(self, q, att, cum):
        """(tanh argument's tanh [B, T, A], masked energies [B, T]) of the
        T-rounded query q [B, H1] and alignment state."""
        pq = q @ self.qw.T
        x = pq[:, None, :] + self.pinpf
        if self.w["loc"]:
            ac = self.rnd(torch.stack([att, cum], 1))
            x = x + F.conv1d(F.pad(ac, (self.pad, self.K - 1 - self.pad)),
                             self.u_conv).transpose(1, 2)
        th = torch.tanh(x)
        return th, (th * self.w["v_w"]).sum(-1) + self.w["v_b"] + self.maskadd


def taco2_train_fwd_plain(w: dict, prenet_t, enc, pinp, maskf, m_a=None, m_d=None, *,
                          norm: str = "sigmoid"):
    """The forward scan in plain PyTorch, step by step: the reference the
    kernel is held against. Arguments and outputs as `taco2_train_fwd`."""
    P, E, H1, H2, A, K = _dims(w)
    dt = w["dtype"]
    pl = _Plain(w, enc, pinp, maskf, norm)
    rnd = pl.rnd
    Ts, B, _ = prenet_t.shape
    T = enc.shape[1]
    dev = enc.device
    Wa = w["a_w"][:, :P + E + H1].float()
    Wd = w["d_w"][:, :H1 + E + H2].float()
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    h1, c1, h2, c2, ctx, att, cum = z(B, H1), z(B, H1), z(B, H2), z(B, H2), z(B, E), \
        z(B, T), z(B, T)
    out = {"dech": torch.empty(Ts, B, H2, dtype=dt, device=dev),
           "ctx": torch.empty(Ts, B, E, dtype=dt, device=dev),
           "align": torch.empty(Ts, B, T, device=dev),
           "g_a": torch.empty(Ts, B, 4 * H1, dtype=dt, device=dev),
           "g_d": torch.empty(Ts, B, 4 * H2, dtype=dt, device=dev),
           "c_a": torch.empty(Ts, B, H1, dtype=dt, device=dev),
           "c_d": torch.empty(Ts, B, H2, dtype=dt, device=dev)}

    def lstm(W, b, xs, c):
        g = torch.cat(xs, 1) @ W.T + b                                 # interleaved
        gi = g.view(B, -1, 4)
        cn = torch.sigmoid(gi[..., 1]) * c + torch.sigmoid(gi[..., 0]) * torch.tanh(gi[..., 2])
        return torch.sigmoid(gi[..., 3]) * torch.tanh(cn), cn, _ungate(g, c.shape[1])

    for t in range(Ts):
        h1n, c1n, g_a = lstm(Wa, w["a_b"], [rnd(prenet_t[t].float()), ctx, h1], c1)
        q = rnd(h1n * m_a[t].float() if m_a is not None else h1n)
        _, e = pl.energies(q, att, cum)
        align, _ = _normalize(e, norm)
        ctx = rnd((align[:, :, None] * pl.encf).sum(1))
        h2n, c2n, g_d = lstm(Wd, w["d_b"], [q, ctx, h2], c2)
        out["dech"][t] = h2n * m_d[t].float() if m_d is not None else h2n
        out["ctx"][t], out["align"][t] = ctx, align
        out["g_a"][t], out["g_d"][t] = g_a, g_d
        out["c_a"][t], out["c_d"][t] = c1n, c2n
        h1, c1, h2, c2 = rnd(h1n), rnd(c1n), rnd(h2n), rnd(c2n)
        att, cum = align, cum + align
    return out


def taco2_train_bwd_plain(w: dict, res: dict, d_dech, d_ctx_out, d_align_out, enc, pinp,
                          maskf, m_a=None, m_d=None, *, norm: str = "sigmoid"):
    """The reverse scan in plain PyTorch, step by step. Arguments and
    outputs as `taco2_train_bwd`."""
    P, E, H1, H2, A, K = _dims(w)
    dt = w["dtype"]
    pl = _Plain(w, enc, pinp, maskf, norm)
    rnd = pl.rnd
    Ts, B, _ = d_dech.shape
    T = enc.shape[1]
    dev = enc.device
    WaT = w["a_wT"][:, :4 * H1].float()
    WdT = w["d_wT"][:, :4 * H2].float()
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    dh1, dc1, dh2, dc2, dctx, datt, dcum = z(B, H1), z(B, H1), z(B, H2), z(B, H2), \
        z(B, E), z(B, T), z(B, T)
    out = {"d_g_a": torch.empty(Ts, B, 4 * H1, dtype=dt, device=dev),
           "d_g_d": torch.empty(Ts, B, 4 * H2, dtype=dt, device=dev),
           "d_ctx": torch.empty(Ts, B, E, dtype=dt, device=dev),
           "d_prenet": torch.empty(Ts, B, P, dtype=dt, device=dev),
           "d_e": torch.empty(Ts, B, T, device=dev)}
    f = lambda k, t: res[k][t].float()  # noqa: E731
    for t in reversed(range(Ts)):
        g_a, g_d, c_a, c_d = f("g_a", t), f("g_d", t), f("c_a", t), f("c_d", t)
        q = torch.sigmoid(g_a[:, 3 * H1:]) * torch.tanh(c_a)
        if m_a is not None:
            q = q * m_a[t].float()
        th, e = pl.energies(rnd(q), f("att_prev", t), f("cum_prev", t))
        align, s = _normalize(e, norm)

        d_h_d = dh2 + (d_dech[t].float() * m_d[t].float() if m_d is not None
                       else d_dech[t].float())
        d_g_d, dc2 = _lstm_bwd_local(g_d, f("c_d_prev", t), c_d, d_h_d, dc2)
        d_g_d = rnd(d_g_d)
        dx = d_g_d @ WdT.T
        d_q, d_ctx_dec, dh2 = dx[:, :H1], dx[:, H1:H1 + E], dx[:, H1 + E:]
        d_ctx_total = d_ctx_out[t].float() + d_ctx_dec + dctx
        d_align = (d_align_out[t].float() + (d_ctx_total[:, None, :] * pl.encf).sum(-1)
                   + datt + dcum)
        if norm == "softmax":
            d_e = align * (d_align - (d_align * align).sum(-1, keepdim=True))
        else:
            S = s.sum(-1, keepdim=True).clamp_min(1e-8)
            d_s = (d_align - (d_align * s).sum(-1, keepdim=True) / S) / S
            d_e = d_s * s * (1.0 - s)
        d_tanh = d_e[:, :, None] * w["v_w"] * (1.0 - th * th)         # [B, T, A]
        d_q2 = rnd(d_tanh.sum(1)) @ pl.qw
        if w["loc"]:
            full = F.conv_transpose1d(rnd(d_tanh).transpose(1, 2), pl.u_conv)
            d_prev = full[:, :, pl.pad:pl.pad + T]                      # [B, 2, T]
            datt, dcum = d_prev[:, 0], dcum + d_prev[:, 1]
        else:
            datt = torch.zeros_like(datt)
        d_q_total = d_q + d_q2
        if m_a is not None:
            d_q_total = d_q_total * m_a[t].float()
        d_g_a, dc1 = _lstm_bwd_local(g_a, f("c_a_prev", t), c_a, dh1 + d_q_total, dc1)
        d_g_a = rnd(d_g_a)
        dxa = d_g_a @ WaT.T
        out["d_prenet"][t], dctx, dh1 = dxa[:, :P], dxa[:, P:P + E], dxa[:, P + E:]
        out["d_g_a"][t], out["d_g_d"][t] = d_g_a, d_g_d
        out["d_ctx"][t], out["d_e"][t] = d_ctx_total, d_e
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int


class _FwdScan(ctypes.Structure):
    """csrc/taco2_train.cu `FwdScan`: the forward scan's arguments."""
    _fields_ = ([(k, _I) for k in ("use_bf16", "Ts", "B", "Tn", "P", "E", "H1", "H2", "A",
                                   "K", "loc", "softmax", "ldq", "ld_a", "ld_d", "cluster_lstm",
                                   "cluster_attn", "attn_probe", "lstm_probe", "serial")]
                + [(k, _P) for k in ("a_w", "a_b", "d_w", "d_b", "q_w", "u", "v_w", "v_b",
                                     "prenet", "enc", "pinp", "maskadd", "m_a", "m_d", "dech",
                                     "ctx", "align", "g_a", "g_d", "c_a", "c_d", "h1", "h2", "q",
                                     "cum", "stream")])


class _Scan(ctypes.Structure):
    """csrc/taco2_train.cu `BwdScan`: the reverse scan's arguments."""
    _fields_ = ([(k, _I) for k in ("use_bf16", "Ts", "B", "Tn", "P", "E", "H1", "H2", "A",
                                   "K", "loc", "softmax", "ldq", "ld_a", "ld_d", "cluster_a",
                                   "cluster_d", "cluster_attn", "attn_probe", "serial")]
                + [(k, _P) for k in ("a_wT", "d_wT", "q_w", "u", "v_w", "v_b", "g_a", "g_d",
                                     "c_a", "c_d", "d_dech", "d_ctx_out", "d_align_out",
                                     "enc", "pinp", "maskadd", "m_a", "m_d", "att_prev",
                                     "cum_prev", "d_g_a", "d_g_d", "d_ctx", "d_prenet", "d_e",
                                     "dh1", "dc1", "dh2", "dc2", "dctx", "datt", "dcum", "d_q",
                                     "d_ctx_tot", "stream")])


def _lib():
    lib = cuda_build.load("taco2_train")
    lib.taco2_train_attn_bwd_smem.argtypes = [_I] * 8
    lib.taco2_train_attn_fwd_smem.argtypes = [_I] * 7
    for fn in (lib.taco2_train_attn_bwd_smem, lib.taco2_train_attn_fwd_smem):
        fn.restype = ctypes.c_size_t
    for fn in (lib.taco2_train_fwd_scan, lib.taco2_train_bwd_scan):
        fn.argtypes, fn.restype = [_P], ctypes.c_int
    return lib


def _check_cuda(w: dict, name: str, tensors: dict, shapes: dict):
    dev = next(iter(tensors.values())).device
    if w["dtype"] not in (BF16, F32):
        raise ValueError(f"{name} runs bf16 or float32 weights, got {w['dtype']}")
    for k, v in tensors.items():
        if v is None:
            continue
        if v.device != dev:
            raise ValueError(f"{name}: {k} is on {v.device}, expected {dev}")
        if k in shapes and tuple(v.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} has shape {tuple(v.shape)}, expected {shapes[k]}")
    for k, v in w.items():
        if isinstance(v, torch.Tensor) and v.device != dev:
            raise ValueError(f"{name}: weight {k} is on {v.device}, inputs on {dev}")
    return dev


def _ptr(x):
    return None if x is None else x.data_ptr()


def taco2_train_fwd_cuda(w: dict, prenet_t, enc, pinp, maskf, m_a=None, m_d=None, *,
                         norm: str = "sigmoid"):
    """The forward scan on the CUDA kernels: the attention LSTM of step 0,
    then for each step the attention (a cluster a batch row) and one launch
    of the decoder LSTM of that step beside the attention LSTM of the next
    (2 T_r + 1 launches), all issued on the current stream by one C call as
    programmatic dependent launches, no host synchronization. A launch the
    card refuses (a cluster it cannot place) raises, and so does a text
    longer than the attention's shared memory holds. Up to a T_in that
    falls as the memory width E grows, the attention keeps the encoder's
    columns in shared memory; past it, it reads them from global memory.
    At full width (A 128, K 31, H1 1,024), as `t_in_limits` computes them:

        E       staged up to (bf16 / f32)   runs up to   backward up to
        512     484 / 296                   1,464 / 1,460   708 / 700
        768     368 / 214                   1,464 / 1,460   704 / 696
        1,024   297 / 167                   1,464 / 1,460   700 / 692

    (E = 512 + spk_dim: 768 with 256-wide d-vectors, 1,024 with the
    512-wide speaker table.)"""
    out = _fwd_scan(w, prenet_t, enc, pinp, maskf, m_a, m_d, norm, (0, 0, 0))
    taco2_train_fwd_cuda.launches += 2 * prenet_t.shape[0] + 1
    return out


taco2_train_fwd_cuda.launches = 0

# probe launches of the forward scan (not counted in `launches`), each
# (attention phase to stop after, LSTM phase to stop after, serial): the
# attention or the bf16 LSTM products stopped after the named phase (the
# outputs are then meaningless; for timing only; the LSTM probes run
# serial, so that each launch's device time stands alone); "serial", the
# same launches each starting when the previous one ends (the same outputs)
FWD_PROBES = {"attn_loads": (1, 0, 0), "attn_projection": (2, 0, 0),
              "attn_energies": (3, 0, 0), "attn_norm": (4, 0, 0),
              "lstm_staging": (0, 1, 1), "lstm_products": (0, 2, 1),
              "lstm_exchange": (0, 3, 1), "serial": (0, 0, 1)}


def taco2_train_fwd_probe_cuda(w: dict, prenet_t, enc, pinp, maskf, m_a=None, m_d=None, *,
                               norm: str = "sigmoid", probe: str = "attn_loads"):
    """taco2_train_fwd_cuda run as the probe `probe` names (FWD_PROBES). Not
    counted in `launches`."""
    return _fwd_scan(w, prenet_t, enc, pinp, maskf, m_a, m_d, norm, FWD_PROBES[probe])


def _fwd_scan(w, prenet_t, enc, pinp, maskf, m_a, m_d, norm, probe):
    if prenet_t.device.type != "cuda":
        raise ValueError("taco2_train_fwd_cuda takes CUDA tensors")
    P, E, H1, H2, A, K = _dims(w)
    Ts, B, _ = prenet_t.shape
    T = enc.shape[1]
    dev = _check_cuda(w, "taco2_train_fwd_cuda",
                      {"prenet_t": prenet_t, "enc": enc, "pinp": pinp, "maskf": maskf,
                       "m_a": m_a, "m_d": m_d},
                      {"prenet_t": (Ts, B, P), "enc": (B, T, E), "pinp": (B, T, A),
                       "maskf": (B, T), "m_a": (Ts, B, H1), "m_d": (Ts, B, H2)})
    if norm not in ("sigmoid", "softmax"):
        raise ValueError(f"unknown attention norm {norm!r}")
    dt = w["dtype"]
    bf16 = int(dt == BF16)
    if bf16 and "a_wf" not in w:
        raise ValueError("taco2_train_fwd_cuda: bf16 weights need prepare_train_weights' "
                         "fragment-ordered a_wf / d_wf")
    lib = _lib()
    plan = fwd_plan(w["dims"], B, T)
    smem = lib.taco2_train_attn_fwd_smem(T, A, K, H1, E, plan["attn"]["cluster"], bf16)
    if smem > SMEM_LIMIT:
        raise ValueError(f"taco2_train_fwd_cuda: T_in={T}, A={A}, K={K} needs {smem} bytes "
                         f"of shared memory per block, more than {SMEM_LIMIT}")
    cv = lambda x: None if x is None else x.to(dt).contiguous()  # noqa: E731
    prenet_t, enc, pinp, m_a, m_d = cv(prenet_t), cv(enc), cv(pinp), cv(m_a), cv(m_d)
    maskadd = torch.where(maskf > 0.5, 0.0, -1e9).to(F32).contiguous()
    e = lambda *s, d=dt: torch.empty(*s, dtype=d, device=dev)  # noqa: E731
    out = {"dech": e(Ts, B, H2), "ctx": e(Ts, B, E), "align": e(Ts, B, T, d=F32),
           "g_a": e(Ts, B, 4 * H1), "g_d": e(Ts, B, 4 * H2), "c_a": e(Ts, B, H1),
           "c_d": e(Ts, B, H2)}
    scratch = {"h1": e(2, B, H1), "h2": e(2, B, H2), "q": e(2, B, H1),
               "cum": torch.zeros(B, T, device=dev)}
    ptrs = {"a_w": w["a_wf" if bf16 else "a_w"], "d_w": w["d_wf" if bf16 else "d_w"],
            **{k: w[k] for k in ("a_b", "d_b", "q_w", "u", "v_w", "v_b")},
            "prenet": prenet_t, "enc": enc, "pinp": pinp, "maskadd": maskadd, "m_a": m_a,
            "m_d": m_d, **out, **scratch}
    attn_probe, lstm_probe, serial = probe
    args = _FwdScan(use_bf16=bf16, Ts=Ts, B=B, Tn=T, P=P, E=E, H1=H1, H2=H2, A=A, K=K,
                    loc=int(w["loc"]), softmax=int(norm == "softmax"), ldq=w["q_w"].shape[1],
                    ld_a=w["a_w"].shape[1], ld_d=w["d_w"].shape[1],
                    cluster_lstm=plan["cluster"], cluster_attn=plan["attn"]["cluster"],
                    attn_probe=attn_probe, lstm_probe=lstm_probe, serial=serial,
                    **{k: _ptr(v) for k, v in ptrs.items()})
    with cuda_build.on_device(dev) as stream:
        args.stream = stream
        cuda_build.check(lib.taco2_train_fwd_scan(ctypes.addressof(args)),
                         "taco2_train_fwd_scan")
    return out


def taco2_train_bwd_cuda(w: dict, res: dict, d_dech, d_ctx_out, d_align_out, enc, pinp,
                         maskf, m_a=None, m_d=None, *, norm: str = "sigmoid"):
    """The reverse scan on the CUDA kernels: four launches per step (the
    decoder cell backward, the decoder products with W^T, the attention and
    attention-cell backward, the attention products with W^T), all issued
    on the current stream by one C call, no host synchronization. A launch
    the card refuses (a cluster it cannot place) raises."""
    out = _bwd_scan(w, res, d_dech, d_ctx_out, d_align_out, enc, pinp, maskf, m_a, m_d,
                    norm, 0, False)
    taco2_train_bwd_cuda.launches += 4 * d_dech.shape[0]
    return out


taco2_train_bwd_cuda.launches = 0

# probe launches of the backward scan: the attention backward stops after
# the named phase (its outputs are then meaningless; for timing only), or
# "serial": the whole scan with each launch starting when the previous one
# ends (the same outputs; each launch's device time then stands alone)
BWD_PROBES = {"attn_loads": 1, "attn_projection": 2, "attn_energies": 3, "attn_norm": 4,
              "attn_correlation": 5, "attn_halo": 6, "serial": 0}


def taco2_train_bwd_probe_cuda(w: dict, res: dict, d_dech, d_ctx_out, d_align_out, enc, pinp,
                               maskf, m_a=None, m_d=None, *, norm: str = "sigmoid",
                               probe: str = "attn_loads"):
    """taco2_train_bwd_cuda with its attention backward stopped after the
    phase `probe` names (BWD_PROBES): the scan's time up to that phase; or
    with `probe="serial"`, the whole scan without programmatic dependent
    launches. Not counted in `launches`."""
    return _bwd_scan(w, res, d_dech, d_ctx_out, d_align_out, enc, pinp, maskf, m_a, m_d,
                     norm, BWD_PROBES[probe], probe == "serial")


def _bwd_scan(w, res, d_dech, d_ctx_out, d_align_out, enc, pinp, maskf, m_a, m_d, norm,
              probe, serial):
    if d_dech.device.type != "cuda":
        raise ValueError("taco2_train_bwd_cuda takes CUDA tensors")
    P, E, H1, H2, A, K = _dims(w)
    Ts, B, _ = d_dech.shape
    T = enc.shape[1]
    shapes = {"d_dech": (Ts, B, H2), "d_ctx_out": (Ts, B, E), "d_align_out": (Ts, B, T),
              "enc": (B, T, E), "pinp": (B, T, A), "maskf": (B, T), "m_a": (Ts, B, H1),
              "m_d": (Ts, B, H2), "g_a": (Ts, B, 4 * H1), "g_d": (Ts, B, 4 * H2),
              "c_a": (Ts, B, H1), "c_d": (Ts, B, H2), "att_prev": (Ts, B, T),
              "cum_prev": (Ts, B, T)}
    dev = _check_cuda(w, "taco2_train_bwd_cuda",
                      {"d_dech": d_dech, "d_ctx_out": d_ctx_out, "d_align_out": d_align_out,
                       "enc": enc, "pinp": pinp, "maskf": maskf, "m_a": m_a, "m_d": m_d,
                       **{k: res[k] for k in ("g_a", "g_d", "c_a", "c_d", "att_prev",
                                              "cum_prev")}}, shapes)
    if norm not in ("sigmoid", "softmax"):
        raise ValueError(f"unknown attention norm {norm!r}")
    dt = w["dtype"]
    bf16 = int(dt == BF16)
    if bf16 and "a_wTf" not in w:
        raise ValueError("taco2_train_bwd_cuda: bf16 weights need prepare_train_weights' "
                         "fragment-ordered a_wTf / d_wTf")
    lib = _lib()
    plan = bwd_plan(w["dims"], B, T)
    ld_q = w["q_w"].shape[1]
    smem = lib.taco2_train_attn_bwd_smem(T, A, K, E, ld_q, H1, plan["attn"]["cluster"], bf16)
    if smem > SMEM_LIMIT:
        raise ValueError(f"taco2_train_bwd_cuda: T_in={T}, A={A}, K={K} needs {smem} bytes "
                         f"of shared memory per block, more than {SMEM_LIMIT}")
    cv = lambda x: None if x is None else x.to(dt).contiguous()  # noqa: E731
    c32 = lambda x: x.to(F32).contiguous()  # noqa: E731
    d_dech, d_ctx_out, enc, pinp, m_a, m_d = (cv(x) for x in (d_dech, d_ctx_out, enc, pinp,
                                                              m_a, m_d))
    g_a, g_d, c_a, c_d = (cv(res[k]) for k in ("g_a", "g_d", "c_a", "c_d"))
    att_prev, cum_prev, d_align_out = c32(res["att_prev"]), c32(res["cum_prev"]), \
        c32(d_align_out)
    maskadd = torch.where(maskf > 0.5, 0.0, -1e9).to(F32).contiguous()
    e = lambda *s, d=dt: torch.empty(*s, dtype=d, device=dev)  # noqa: E731
    out = {"d_g_a": e(Ts, B, 4 * H1), "d_g_d": e(Ts, B, 4 * H2), "d_ctx": e(Ts, B, E),
           "d_prenet": e(Ts, B, P), "d_e": e(Ts, B, T, d=F32)}
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    carries = {"dh1": z(B, H1), "dc1": z(B, H1), "dh2": z(B, H2), "dc2": z(B, H2),
               "dctx": z(B, E), "datt": z(B, T), "dcum": z(B, T), "d_q": z(B, H1),
               "d_ctx_tot": z(B, E)}
    ptrs = {"a_wT": w["a_wTf" if bf16 else "a_wT"], "d_wT": w["d_wTf" if bf16 else "d_wT"],
            **{k: w[k] for k in ("q_w", "u", "v_w", "v_b")},
            "g_a": g_a, "g_d": g_d, "c_a": c_a, "c_d": c_d, "d_dech": d_dech,
            "d_ctx_out": d_ctx_out, "d_align_out": d_align_out, "enc": enc, "pinp": pinp,
            "maskadd": maskadd, "m_a": m_a, "m_d": m_d, "att_prev": att_prev,
            "cum_prev": cum_prev, **out, **carries}
    scan = _Scan(use_bf16=bf16, Ts=Ts, B=B, Tn=T, P=P, E=E, H1=H1, H2=H2, A=A, K=K,
                 loc=int(w["loc"]), softmax=int(norm == "softmax"), ldq=ld_q,
                 ld_a=w["a_wT"].shape[1], ld_d=w["d_wT"].shape[1],
                 cluster_a=plan["a"]["cluster"], cluster_d=plan["d"]["cluster"],
                 cluster_attn=plan["attn"]["cluster"], attn_probe=probe, serial=int(serial),
                 **{k: _ptr(v) for k, v in ptrs.items()})
    with cuda_build.on_device(dev) as stream:
        scan.stream = stream
        cuda_build.check(lib.taco2_train_bwd_scan(ctypes.addressof(scan)),
                         "taco2_train_bwd_scan")
    return out


def taco2_train_fwd(w: dict, prenet_t, enc, pinp, maskf, m_a=None, m_d=None, *,
                    norm: str = "sigmoid") -> dict:
    """Teacher-forced decoder forward over all steps. w:
    `prepare_train_weights` output on the inputs' device, in the working
    dtype; prenet_t [T_r, B, P]; enc [B, T_in, E]; pinp [B, T_in, A] = W_k m;
    maskf [B, T_in] float (1 = valid); m_a [T_r, B, H1] / m_d [T_r, B, H2]
    dropout multipliers or None. Returns the stacks dech [T_r, B, H2], ctx
    [T_r, B, E], align [T_r, B, T_in] (float32), g_a [T_r, B, 4 H1], g_d
    [T_r, B, 4 H2], c_a [T_r, B, H1], c_d [T_r, B, H2]. CPU tensors run the
    plain version, CUDA tensors the kernel."""
    fn = taco2_train_fwd_plain if prenet_t.device.type == "cpu" else taco2_train_fwd_cuda
    return fn(w, prenet_t, enc, pinp, maskf, m_a, m_d, norm=norm)


def taco2_train_bwd(w: dict, res: dict, d_dech, d_ctx_out, d_align_out, enc, pinp, maskf,
                    m_a=None, m_d=None, *, norm: str = "sigmoid") -> dict:
    """Reverse scan of the teacher-forced decoder. res: the forward's g_a,
    g_d, c_a, c_d, their shifts c_a_prev / c_d_prev (zero at step 0), and
    att_prev / cum_prev, the alignment and its running sum before each step
    (float32). Cotangents: d_dech [T_r, B, H2], d_ctx_out [T_r, B, E] (both
    working dtype), d_align_out [T_r, B, T_in] float32. Returns d_g_a
    [T_r, B, 4 H1], d_g_d [T_r, B, 4 H2], d_ctx (the total context cotangent)
    [T_r, B, E], d_prenet [T_r, B, P] in the working dtype and d_e
    [T_r, B, T_in] float32, the raw energies' cotangent. CPU tensors run the
    plain version, CUDA tensors the kernel."""
    fn = taco2_train_bwd_plain if d_dech.device.type == "cpu" else taco2_train_bwd_cuda
    return fn(w, res, d_dech, d_ctx_out, d_align_out, enc, pinp, maskf, m_a, m_d, norm=norm)
