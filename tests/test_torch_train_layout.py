"""Host side of the training backward kernel (csrc/taco2_train.cu), on the
CPU: the fragment-ordered W^T that its tensor-core products read
(`prepare_train_weights`' a_wTf / d_wTf) against W^T, its launch plan
(`bwd_plan`: the W^T products' clusters, k-tile slices, row bands, sum
rows and batch slices; the attention backward's cluster and its parts of
the text positions, attention units and H1), and a plain PyTorch emulation
of the attention backward split over the cluster's blocks as the kernel
splits it (partial projections, partial norm sums combined, dpq summed in
rank order, each block's rows of the location correlation read across its
part's edges by their owner's index) against `taco2_train_bwd_plain`. The
kernel itself is held against its plain version in tests/test_torch_cuda.py,
on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from your_voice_tts_torch.ops.taco2_train import (ATTN_CLUSTER, MAT_CLUSTER, MAT_NT, MAT_WARPS,
                                                  _lstm_bwd_local, _Plain, bwd_plan,
                                                  prepare_train_weights,
                                                  taco2_train_bwd_plain, taco2_train_fwd_plain)

torch.set_num_threads(1)

FULL = {"P": 256, "E": 512, "H1": 1024, "H2": 1024, "A": 128, "K": 31}


def weights(widths, K, dtype, location=True, seed=3, scale=0.3):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: (scale * torch.randn(*s, generator=g)).to(dtype)  # noqa: E731
    P, E, H1, H2, A = widths
    return prepare_train_weights((r(4 * H1, P + E), r(4 * H1, H1), r(4 * H1)), r(A, H1),
                                 r(8, 2, K) if location else None,
                                 r(A, 8) if location else None, r(1, A), r(1),
                                 (r(4 * H2, H1 + E), r(4 * H2, H2), r(4 * H2)))


def unfragment(f):
    """[row tiles, k-tiles, 32, 8] -> [R, K] by the PTX ISA's layout of the
    m16n8k16 A operand: lane L = 4g + q holds (row g, cols 2q, 2q + 1),
    (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..)."""
    f = f.float().numpy()
    RT, KTn = f.shape[:2]
    out = np.zeros((RT, 16, KTn, 16), np.float32)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for i, (r, c) in enumerate([(g, 2 * q), (g + 8, 2 * q), (g, 2 * q + 8),
                                    (g + 8, 2 * q + 8)]):
            for j in range(2):
                out[:, r, :, c + j] = f[:, :, lane, 2 * i + j]
    return out.reshape(RT * 16, KTn * 16)


@pytest.mark.parametrize("widths", [(256, 512, 1024, 1024, 128), (24, 32, 48, 40, 24),
                                    (20, 30, 38, 45, 13)])
def test_fragment_ordered_wT_rebuilds_wT(widths):
    """Every element of a_wT / d_wT where the products read it, zeros in the
    padding to 16 rows and 16 columns; float32 weights get no copy."""
    w = weights(widths, 15, torch.bfloat16, scale=1.0)
    P, E, H1, H2, _ = widths
    for key, rows, H in (("a_wT", P + E + H1, H1), ("d_wT", H1 + E + H2, H2)):
        got = unfragment(w[key + "f"])
        assert w[key + "f"].dtype == torch.bfloat16
        assert got.shape == (-(-rows // 16) * 16, -(-4 * H // 16) * 16)
        want = w[key][:, :4 * H].float().numpy()
        assert np.array_equal(got[:rows, :4 * H], want)
        assert not got[rows:].any() and not got[:, 4 * H:].any()
    assert "a_wTf" not in weights((24, 32, 48, 40, 24), 15, torch.float32)


def covers(parts, n):
    """The parts are [lo, hi) ranges in order that cover [0, n) once."""
    edge = 0
    for lo, hi in parts:
        assert lo == edge and hi >= lo
        edge = hi
    return edge == n


@pytest.mark.parametrize("dims,B,T", [
    (FULL, 32, 128), (FULL, 5, 37), (FULL, 70, 3), (FULL, 1, 1),
    ({"P": 24, "E": 32, "H1": 48, "H2": 40, "A": 24, "K": 15}, 11, 13),
    ({"P": 20, "E": 30, "H1": 38, "H2": 45, "A": 13, "K": 1}, 40, 37),
    ({"P": 8, "E": 16, "H1": 12, "H2": 20, "A": 10, "K": 7}, 3, 7)])
def test_bwd_plan_covers_everything_once(dims, B, T):
    plan = bwd_plan(dims, B, T)
    P, E, H1, H2, A = (dims[k] for k in ("P", "E", "H1", "H2", "A"))
    for key, rows, H in (("d", H1 + E + H2, H2), ("a", P + E + H1, H1)):
        m = plan[key]
        cs = m["cluster"]
        assert cs & (cs - 1) == 0 and cs <= min(MAT_CLUSTER, m["k_tiles"])
        assert m["k_tiles"] * 16 >= 4 * H > (m["k_tiles"] - 1) * 16
        assert m["row_tiles"] * 16 >= rows > (m["row_tiles"] - 1) * 16
        # every reduction k-tile in one block's slice, every row tile in one band
        assert len(m["k_slices"]) == cs and covers(m["k_slices"], m["k_tiles"])
        assert m["bands"] * MAT_WARPS >= m["row_tiles"] > (m["bands"] - 1) * MAT_WARPS
        # every row of a band summed over the cluster by one block
        assert len(m["sum_rows"]) == cs and covers(m["sum_rows"], 16 * MAT_WARPS)
        assert covers(m["batch_slices"], B)
        assert all(0 < hi - lo <= 8 * MAT_NT for lo, hi in m["batch_slices"])
    at = plan["attn"]
    cs = at["cluster"]
    assert cs & (cs - 1) == 0 and cs <= min(ATTN_CLUSTER, T)
    assert cs == min(ATTN_CLUSTER, 1 << (T.bit_length() - 1))
    for key, n in (("t", T), ("a", A), ("h1", H1)):
        assert len(at[key]) == cs and covers(at[key], n)
    # every text position in one block's part, none empty
    assert all(hi > lo for lo, hi in at["t"])
    # the location backward's reads: every G row a position's window reads
    # has exactly one owner, found as the kernel finds it
    K = dims["K"]
    pad = (K - 1) // 2
    for tp in range(T):
        for k in range(K):
            t = tp - k + pad
            if 0 <= t < T:
                owners = [r for r, (lo, hi) in enumerate(at["t"]) if lo <= t < hi]
                assert owners == [part_of(t, T, cs)]


def part_of(i, n, cs):
    """csrc/taco2_train.cu `part_of`: which even part of [0, n) holds i."""
    r = cs - 1
    while r * n // cs > i:
        r -= 1
    return r


def attn_bwd_split(pl, w, parts, norm, q, att, cum, d_align_out, d_ctx_tot, d_q, m_a, g_a,
                   c_prev, c_a, dh1, dc1, datt, dcum):
    """One reverse step of the attention backward and the attention cell
    backward as the kernel's cluster computes it: each block its parts,
    the cross-block quantities exchanged as partial sums (in rank order) or
    read from their owner. Returns (d_e, d_g_a, dc1, datt, dcum)."""
    B, T = att.shape
    K, pad, H1 = pl.K, pl.pad, pl.qw.shape[1]
    ts = [slice(lo, hi) for lo, hi in parts["t"]]
    # barrier 1: each block's units of the projection, gathered
    pq = torch.cat([q @ pl.qw[lo:hi].T for lo, hi in parts["a"]], 1)
    x = pq[:, None, :] + pl.pinpf
    if w["loc"]:
        ac = pl.rnd(torch.stack([att, cum], 1))
        x = x + F.conv1d(F.pad(ac, (pad, K - 1 - pad)), pl.u_conv).transpose(1, 2)
    th = torch.tanh(x)
    e = (th * w["v_w"]).sum(-1) + w["v_b"] + pl.maskadd
    dal = d_align_out + (d_ctx_tot[:, None, :] * pl.encf).sum(-1) + datt + dcum
    # barrier 2: each block's partial norm sums, combined by every block
    if norm == "softmax":
        m = [e[:, s].max(-1, keepdim=True).values for s in ts]
        ex = [torch.exp(e[:, s] - mr) for s, mr in zip(ts, m)]
        M = torch.stack(m).max(0).values
        tot = sum(x.sum(-1, keepdim=True) * torch.exp(mr - M) for x, mr in zip(ex, m))
        dot = sum((dal[:, s] * x).sum(-1, keepdim=True) * torch.exp(mr - M)
                  for s, x, mr in zip(ts, ex, m))
        d_e = torch.cat([x * (torch.exp(mr - M) / tot) * (dal[:, s] - dot / tot)
                         for s, x, mr in zip(ts, ex, m)], 1)
    else:
        sg = [torch.sigmoid(e[:, s]) for s in ts]
        S = sum(x.sum(-1, keepdim=True) for x in sg).clamp_min(1e-8)
        inner = sum((dal[:, s] * x).sum(-1, keepdim=True) for s, x in zip(ts, sg)) / S
        d_e = torch.cat([(dal[:, s] - inner) / S * x * (1.0 - x) for s, x in zip(ts, sg)], 1)
    d_tanh = d_e[:, :, None] * w["v_w"] * (1.0 - th * th)
    # barrier 3: dpq from each block's part, in rank order; each block's rows
    # of G, read by the location backward from their owner
    dpq = torch.zeros(B, pl.qw.shape[0])
    for s in ts:
        dpq = dpq + d_tanh[:, s].sum(1)
    dpq = pl.rnd(dpq)
    if w["loc"]:
        u = w["u"].float()                                         # [2, K, A]
        G = [torch.einsum("bta,cka->btck", pl.rnd(d_tanh[:, s]), u) for s in ts]
        d_prev = torch.zeros(B, 2, T)
        for tp in range(T):
            for k in range(K):
                t = tp - k + pad
                if 0 <= t < T:
                    o = part_of(t, T, len(ts))
                    d_prev[:, :, tp] += G[o][:, t - parts["t"][o][0], :, k]
        datt, dcum = d_prev[:, 0], dcum + d_prev[:, 1]
    else:
        datt = torch.zeros_like(datt)
    # each block's H1 units: d_q2 and the cell backward
    d_g_a, dc1_new = torch.empty(B, 4 * H1), torch.empty(B, H1)
    for lo, hi in parts["h1"]:
        cols = torch.cat([torch.arange(g * H1 + lo, g * H1 + hi) for g in range(4)])
        dq = d_q[:, lo:hi] + dpq @ pl.qw[:, lo:hi]
        if m_a is not None:
            dq = dq * m_a[:, lo:hi]
        dg, dc = _lstm_bwd_local(g_a[:, cols], c_prev[:, lo:hi], c_a[:, lo:hi],
                                 dh1[:, lo:hi] + dq, dc1[:, lo:hi])
        d_g_a[:, cols], dc1_new[:, lo:hi] = dg, dc
    return d_e, d_g_a, dc1_new, datt, dcum


def bwd_split(w, res, d_dech, d_ctx_out, d_align_out, enc, pinp, maskf, m_a, m_d, norm):
    """taco2_train_bwd_plain's reverse scan with the attention backward of
    `attn_bwd_split` on the kernel's plan (float32)."""
    P, E, H1, H2 = (w["dims"][k] for k in ("P", "E", "H1", "H2"))
    pl = _Plain(w, enc, pinp, maskf, norm)
    Ts, B, _ = d_dech.shape
    T = enc.shape[1]
    parts = bwd_plan(w["dims"], B, T)["attn"]
    WaT, WdT = w["a_wT"][:, :4 * H1].float(), w["d_wT"][:, :4 * H2].float()
    z = torch.zeros
    dh1, dc1, dh2, dc2, dctx, datt, dcum = z(B, H1), z(B, H1), z(B, H2), z(B, H2), z(B, E), \
        z(B, T), z(B, T)
    out = {k: [None] * Ts for k in ("d_g_a", "d_g_d", "d_ctx", "d_prenet", "d_e")}
    for t in reversed(range(Ts)):
        g_a, c_a = res["g_a"][t].float(), res["c_a"][t].float()
        q = torch.sigmoid(g_a[:, 3 * H1:]) * torch.tanh(c_a)
        if m_a is not None:
            q = q * m_a[t]
        d_h_d = dh2 + (d_dech[t] * m_d[t] if m_d is not None else d_dech[t])
        d_g_d, dc2 = _lstm_bwd_local(res["g_d"][t], res["c_d_prev"][t], res["c_d"][t], d_h_d,
                                     dc2)
        dx = d_g_d @ WdT.T
        d_q, dh2 = dx[:, :H1], dx[:, H1 + E:]
        d_ctx_tot = d_ctx_out[t] + dx[:, H1:H1 + E] + dctx
        d_e, d_g_a, dc1, datt, dcum = attn_bwd_split(
            pl, w, parts, norm, pl.rnd(q), res["att_prev"][t], res["cum_prev"][t],
            d_align_out[t], d_ctx_tot, d_q, None if m_a is None else m_a[t], g_a,
            res["c_a_prev"][t], c_a, dh1, dc1, datt, dcum)
        dxa = d_g_a @ WaT.T
        out["d_prenet"][t], dctx, dh1 = dxa[:, :P], dxa[:, P:P + E], dxa[:, P + E:]
        out["d_g_a"][t], out["d_g_d"][t] = d_g_a, d_g_d
        out["d_ctx"][t], out["d_e"][t] = d_ctx_tot, d_e
    return {k: torch.stack(v) for k, v in out.items()}


# norm, location features, dropout, B, T_in (four parts of 3-4, of 9-10,
# of 3 (T=13: 3, 3, 3, 4), two of 1-2 (T=3), one (T=1)), filter taps
SPLIT_CASES = [("sigmoid", True, True, 3, 13, 15), ("softmax", True, False, 3, 13, 15),
               ("sigmoid", True, False, 2, 37, 31), ("softmax", True, True, 2, 37, 7),
               ("sigmoid", True, True, 3, 3, 15), ("softmax", True, False, 2, 1, 5),
               ("softmax", False, True, 3, 13, 15), ("sigmoid", True, True, 2, 13, 1)]


@pytest.mark.parametrize("norm,location,dropout,B,T,K", SPLIT_CASES)
def test_split_attention_backward_matches_plain(norm, location, dropout, B, T, K):
    """Float32, widths (P, E, H1, H2, A) = (8, 16, 14, 20, 10), 6 steps: the
    split scan gives every output of `taco2_train_bwd_plain` within float32
    rounding (rel L2 2e-6), whatever the parts; the windows of K = 15 and 31
    reach across one or more parts' edges."""
    P, E, H1, H2, A, Ts = 8, 16, 14, 20, 10, 6
    w = weights((P, E, H1, H2, A), K, torch.float32, location)
    rng = np.random.default_rng(11)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    lengths = np.maximum(T - np.arange(B) * max(1, T // 4), 1)
    maskf = torch.from_numpy((np.arange(T)[None] < lengths[:, None]).astype(np.float32))
    masks = [torch.from_numpy(np.where(rng.random((Ts, B, H)) < 0.9, 1 / 0.9, 0.0)
                              .astype(np.float32)) if dropout else None for H in (H1, H2)]
    enc, pinp = torch.tanh(f(B, T, E)), 0.3 * f(B, T, A)
    fwd = taco2_train_fwd_plain(w, torch.relu(f(Ts, B, P)), enc, pinp, maskf, *masks,
                                norm=norm)
    sh = lambda s: torch.cat([torch.zeros_like(s[:1]), s[:-1]])  # noqa: E731
    res = {k: fwd[k] for k in ("g_a", "g_d", "c_a", "c_d")}
    res.update(c_a_prev=sh(fwd["c_a"]), c_d_prev=sh(fwd["c_d"]), att_prev=sh(fwd["align"]),
               cum_prev=sh(torch.cumsum(fwd["align"], 0)))
    args = (w, res, f(Ts, B, H2), f(Ts, B, E), f(Ts, B, T), enc, pinp, maskf, *masks)
    ref = taco2_train_bwd_plain(*args, norm=norm)
    got = bwd_split(*args, norm)
    for k in ref:
        rel = float((got[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-30))
        assert rel <= 2e-6, (k, rel)
