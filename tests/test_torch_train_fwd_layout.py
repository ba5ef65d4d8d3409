"""Host side of the training forward kernel (csrc/taco2_train.cu), on the
CPU: the fragment-ordered interleaved gate rows that its tensor-core LSTM
products read (`prepare_train_weights`' a_wf / d_wf) against a_w / d_w, its
launch plan (`fwd_plan`: the LSTM products' shared cluster, each block's
interleaved k-tiles and those it multiplies after its wait, row bands,
each block's units in the cluster's sum and batch slices; the
attention's cluster and its parts of the text positions, H1 and E), a plain
PyTorch emulation of the cluster-split LSTM product with the cell update
in the block that sums a unit's four gate rows, and one of the attention
forward split over the cluster's blocks as the kernel splits it (partial
query projections summed in rank order, each block's location window read
across its part's edges from the positions' owners, norm partials
combined, the alignments gathered from their owners, the context by
columns of E) against `taco2_train_fwd_plain`. The kernel itself is held
against its plain version in tests/test_torch_cuda.py, on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_train_layout import FULL, covers, part_of, unfragment, weights
from your_voice_tts_torch.ops.taco2_train import (ATTN_CLUSTER, FWD_CLUSTER, MAT_NT, MAT_WARPS,
                                                  _normalize, _Plain, fwd_plan,
                                                  taco2_train_fwd_plain)

torch.set_num_threads(1)


@pytest.mark.parametrize("widths", [(256, 512, 1024, 1024, 128), (24, 32, 48, 40, 24),
                                    (20, 30, 38, 45, 13)])
def test_fragment_ordered_w_rebuilds_interleaved_w(widths):
    """Every element of the interleaved a_w / d_w where the forward's
    products read it, zeros in the padding to 16 rows and 16 columns;
    float32 weights get no copy."""
    w = weights(widths, 15, torch.bfloat16, scale=1.0)
    P, E, H1, H2, _ = widths
    for key, n_in, H in (("a_w", P + E + H1, H1), ("d_w", H1 + E + H2, H2)):
        got = unfragment(w[key + "f"])
        assert w[key + "f"].dtype == torch.bfloat16
        assert got.shape == (-(-4 * H // 16) * 16, -(-n_in // 16) * 16)
        assert np.array_equal(got[:4 * H, :n_in], w[key][:, :n_in].float().numpy())
        assert not got[4 * H:].any() and not got[:, n_in:].any()
    assert "a_wf" not in weights((24, 32, 48, 40, 24), 15, torch.float32)


SMALL = [({"P": 24, "E": 32, "H1": 48, "H2": 40, "A": 24, "K": 15}, 11, 13),
         ({"P": 20, "E": 30, "H1": 38, "H2": 45, "A": 13, "K": 1}, 40, 37),
         ({"P": 8, "E": 16, "H1": 12, "H2": 20, "A": 10, "K": 7}, 3, 7),
         ({"P": 8, "E": 4, "H1": 4, "H2": 4, "A": 3, "K": 5}, 2, 1)]


@pytest.mark.parametrize("dims,B,T", [(FULL, B, T) for B in (5, 32, 70)
                                      for T in (3, 37, 128)] + SMALL)
def test_fwd_plan_covers_everything_once(dims, B, T):
    plan = fwd_plan(dims, B, T)
    P, E, H1, H2 = (dims[k] for k in ("P", "E", "H1", "H2"))
    cs = plan["cluster"]
    k16 = {"a": -(-(P + E + H1) // 16), "d": -(-(H1 + E + H2) // 16)}
    assert cs & (cs - 1) == 0 and cs <= min(FWD_CLUSTER, *k16.values())
    assert 2 * cs > min(FWD_CLUSTER, *k16.values())
    units = 16 * MAT_WARPS // 4
    for key, H in (("a", H1), ("d", H2)):
        m = plan[key]
        assert m["k_tiles"] == k16[key]
        assert m["row_tiles"] * 16 >= 4 * H > (m["row_tiles"] - 1) * 16
        # every input k-tile in one block's set (rank, rank + cs, ...), every
        # row tile in one band
        assert len(m["tiles"]) == cs
        assert sorted(k for ts in m["tiles"] for k in ts) == list(range(m["k_tiles"]))
        assert all(ts == list(range(r, m["k_tiles"], cs)) for r, ts in enumerate(m["tiles"]))
        # after its wait, a block multiplies exactly its tiles over the
        # context (x1): the plan's run of its local indices (the kernel's
        # closed form) against the tiles that hold a context column
        n0, n1 = (P, E) if key == "a" else (H1, E)
        for ts, aw in zip(m["tiles"], m["after_wait"]):
            assert all(j - i == 1 for i, j in zip(aw, aw[1:]))
            assert [ts[kk] for kk in aw] == [k for k in ts
                                             if 16 * k < n0 + n1 and 16 * k + 16 > n0]
        assert m["bands"] * MAT_WARPS >= m["row_tiles"] > (m["bands"] - 1) * MAT_WARPS
        # every unit of a band (its four gate rows) summed and updated by one block
        assert len(m["sum_units"]) == cs and covers(m["sum_units"], units)
        rows = sorted(b * 4 * units + 4 * u + g for b in range(m["bands"])
                      for lo, hi in m["sum_units"] for u in range(lo, hi) for g in range(4))
        assert rows == list(range(m["bands"] * 4 * units))
        assert covers(m["batch_slices"], B)
        assert all(0 < hi - lo <= 8 * MAT_NT for lo, hi in m["batch_slices"])
    at = plan["attn"]
    acs = at["cluster"]
    assert acs == min(ATTN_CLUSTER, 1 << (T.bit_length() - 1))
    for key, n in (("t", T), ("h1", H1), ("e", E)):
        assert len(at[key]) == acs and covers(at[key], n)
    # every text position in one block's part, none empty; H1 and E parts
    # start on 8-element chunks (16-byte loads)
    assert all(hi > lo for lo, hi in at["t"])
    assert all(lo % 8 == 0 for key in ("h1", "e") for lo, _ in at[key])
    # the location window's reads: every position a block's window reads
    # has exactly one owner, found as the kernel finds it
    K = dims["K"]
    pad = (K - 1) // 2
    for lo, hi in at["t"]:
        for t in range(lo - pad, hi + K - 1 - pad):
            if 0 <= t < T:
                owners = [r for r, (a, b) in enumerate(at["t"]) if a <= t < b]
                assert owners == [part_of(t, T, acs)]


def lstm_split(frag, bias, x, c_prev, H, plan):
    """One LSTM step as the forward kernel's cluster computes it: each
    block's partial products over its k-tiles of the fragment-ordered
    interleaved rows (those before its wait, then the context's), the block
    that owns a unit summing its four gate rows over the cluster in rank
    order, adding the biases and updating the cell. Returns (h, c, gates in
    block layout)."""
    Wf = torch.from_numpy(unfragment(frag))
    xp = F.pad(x, (0, Wf.shape[1] - x.shape[1]))

    def product(tiles):
        cols = torch.tensor([16 * k + c for k in tiles for c in range(16)], dtype=torch.long)
        return xp[:, cols] @ Wf[:, cols].T

    parts = [product([k for kk, k in enumerate(ts) if kk not in aw])
             + product([ts[kk] for kk in aw])
             for ts, aw in zip(plan["tiles"], plan["after_wait"])]
    B, units = x.shape[0], 16 * MAT_WARPS // 4
    h, c, gates = torch.full((B, H), torch.nan), torch.full((B, H), torch.nan), \
        torch.full((B, 4 * H), torch.nan)
    for band in range(plan["bands"]):
        for lo, hi in plan["sum_units"]:
            j = torch.arange(band * units + lo, max(band * units + lo, min(H, band * units + hi)))
            if not len(j):
                continue
            pre = torch.zeros(B, len(j), 4)
            for p in parts:
                pre = pre + p[:, 4 * j[:, None] + torch.arange(4)]
            pre = pre + bias[4 * j[:, None] + torch.arange(4)]
            i, f, g, o = pre.unbind(-1)
            c[:, j] = torch.sigmoid(f) * c_prev[:, j] + torch.sigmoid(i) * torch.tanh(g)
            h[:, j] = torch.sigmoid(o) * torch.tanh(c[:, j])
            for gg in range(4):
                gates[:, gg * H + j] = pre[..., gg]
    return h, c, gates


@pytest.mark.parametrize("widths,B", [((24, 32, 48, 40, 24), 11), ((20, 30, 38, 45, 13), 5),
                                      ((256, 512, 1024, 1024, 128), 5)])
def test_split_lstm_matches_plain(widths, B):
    """Both LSTMs of a step, bf16 weights and float32 sums: the cluster
    split with its epilogue's cell update gives the plain step's h, c and
    gates within float32 rounding (rel L2 2e-6)."""
    P, E, H1, H2, _ = widths
    w = weights(widths, 15, torch.bfloat16, scale=0.3)
    plan = fwd_plan(w["dims"], B, 13)
    rng = np.random.default_rng(5)
    for key, n_in, H in (("a", P + E + H1, H1), ("d", H1 + E + H2, H2)):
        x = torch.from_numpy(rng.normal(size=(B, n_in)).astype(np.float32))
        c_prev = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
        got = lstm_split(w[key + "_wf"], w[key + "_b"], x, c_prev, H, plan[key])
        g = x @ w[key + "_w"][:, :n_in].float().T + w[key + "_b"]      # interleaved
        gi = g.view(B, H, 4)
        c = torch.sigmoid(gi[..., 1]) * c_prev + torch.sigmoid(gi[..., 0]) * torch.tanh(gi[..., 2])
        want = (torch.sigmoid(gi[..., 3]) * torch.tanh(c), c,
                gi.transpose(1, 2).reshape(B, 4 * H))
        for name, a, b in zip(("h", "c", "gates"), got, want):
            rel = float((a - b).norm() / b.norm())
            assert rel <= 2e-6, (key, name, rel)


def attn_fwd_split(pl, w, parts, norm, q, att, cum, wrong_halo=False):
    """One step of the attention forward as the kernel's cluster computes
    it. att / cum: each block's own positions of the alignment state, as
    their owners wrote them in the previous step. Returns (alignments,
    context, att, cum) with att / cum again by owner. wrong_halo plants a
    fault: a window position past a block's edges read from the next block
    after its owner."""
    B, H1 = q.shape
    T = sum(hi - lo for lo, hi in parts["t"])
    cs, K, pad = len(parts["t"]), pl.K, pl.pad
    # barrier 1: each block's partial projection over its part of H1,
    # summed in rank order
    pq = torch.zeros(B, pl.qw.shape[0])
    for lo, hi in parts["h1"]:
        pq = pq + q[:, lo:hi] @ pl.qw[:, lo:hi].T
    s_parts, m_parts, sums = [], [], []
    for r, (t0, t1) in enumerate(parts["t"]):
        x = pq[:, None, :] + pl.pinpf[:, t0:t1]
        if w["loc"]:
            win = torch.zeros(B, 2, t1 - t0 + K - 1)
            for i, t in enumerate(range(t0 - pad, t1 + K - 1 - pad)):
                if not 0 <= t < T:
                    continue
                o = part_of(t, T, cs)
                if wrong_halo and not t0 <= t < t1:
                    o = (o + 1) % cs
                lo, hi = parts["t"][o]
                k = min(max(t - lo, 0), hi - lo - 1)
                win[:, 0, i], win[:, 1, i] = att[o][:, k], cum[o][:, k]
            x = x + F.conv1d(pl.rnd(win), pl.u_conv).transpose(1, 2)
        e = (torch.tanh(x) * w["v_w"]).sum(-1) + w["v_b"] + pl.maskadd[:, t0:t1]
        # this block's norm partials
        m = e.max(-1, keepdim=True).values if norm == "softmax" else torch.zeros(B, 1)
        s = torch.exp(e - m) if norm == "softmax" else torch.sigmoid(e)
        s_parts.append(s), m_parts.append(m), sums.append(s.sum(-1, keepdim=True))
    # barrier 2: the partials combined, the alignments gathered from owners
    if norm == "softmax":
        M = torch.stack(m_parts).max(0).values
        sc = [torch.exp(m - M) for m in m_parts]
        tot = sum(s * c for s, c in zip(sums, sc))
        sc = [c / tot for c in sc]
    else:
        sc = [1.0 / sum(sums).clamp_min(1e-8)] * cs
    align = torch.cat([s * c for s, c in zip(s_parts, sc)], 1)
    ctx = torch.cat([pl.rnd(torch.einsum("bt,bte->be", align, pl.encf[:, :, lo:hi]))
                     for lo, hi in parts["e"]], 1)
    att = [align[:, lo:hi] for lo, hi in parts["t"]]
    cum = [c + a for c, a in zip(cum, att)]
    return align, ctx, att, cum


def fwd_split(w, prenet_t, enc, pinp, maskf, m_a, m_d, norm, wrong_halo=False):
    """taco2_train_fwd_plain's scan with the attention of `attn_fwd_split`
    on the kernel's plan (float32)."""
    P, E, H1, H2 = (w["dims"][k] for k in ("P", "E", "H1", "H2"))
    pl = _Plain(w, enc, pinp, maskf, norm)
    Ts, B, _ = prenet_t.shape
    T = enc.shape[1]
    parts = fwd_plan(w["dims"], B, T)["attn"]
    Wa, Wd = w["a_w"][:, :P + E + H1].float(), w["d_w"][:, :H1 + E + H2].float()
    z = torch.zeros
    h1, c1, h2, c2, ctx = z(B, H1), z(B, H1), z(B, H2), z(B, H2), z(B, E)
    att = [z(B, hi - lo) for lo, hi in parts["t"]]
    cum = [z(B, hi - lo) for lo, hi in parts["t"]]
    out = {k: [] for k in ("dech", "ctx", "align", "g_a", "g_d", "c_a", "c_d")}

    def lstm(W, b, xs, c):
        gi = (torch.cat(xs, 1) @ W.T + b).view(B, -1, 4)
        cn = torch.sigmoid(gi[..., 1]) * c + torch.sigmoid(gi[..., 0]) * torch.tanh(gi[..., 2])
        return torch.sigmoid(gi[..., 3]) * torch.tanh(cn), cn, gi.transpose(1, 2).reshape(B, -1)

    for t in range(Ts):
        h1, c1, g_a = lstm(Wa, w["a_b"], [prenet_t[t], ctx, h1], c1)
        q = h1 * m_a[t] if m_a is not None else h1
        align, ctx, att, cum = attn_fwd_split(pl, w, parts, norm, q, att, cum, wrong_halo)
        h2, c2, g_d = lstm(Wd, w["d_b"], [q, ctx, h2], c2)
        for k, v in (("dech", h2 * m_d[t] if m_d is not None else h2), ("ctx", ctx),
                     ("align", align), ("g_a", g_a), ("g_d", g_d), ("c_a", c1), ("c_d", c2)):
            out[k].append(v)
    return {k: torch.stack(v) for k, v in out.items()}


def fwd_case(location, dropout, B, T, K, Ts=6, seed=11):
    """Float32, widths (P, E, H1, H2, A) = (8, 16, 14, 20, 10): seeded
    weights and inputs, lengths stepping down from T."""
    P, E, H1, H2, A = 8, 16, 14, 20, 10
    w = weights((P, E, H1, H2, A), K, torch.float32, location)
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    lengths = np.maximum(T - np.arange(B) * max(1, T // 4), 1)
    maskf = torch.from_numpy((np.arange(T)[None] < lengths[:, None]).astype(np.float32))
    masks = [torch.from_numpy(np.where(rng.random((Ts, B, H)) < 0.9, 1 / 0.9, 0.0)
                              .astype(np.float32)) if dropout else None for H in (H1, H2)]
    return (w, torch.relu(f(Ts, B, P)), torch.tanh(f(B, T, E)), 0.3 * f(B, T, A), maskf,
            *masks)


# norm, location features, dropout, B, T_in (four parts of 3-4, of 9-10, two
# of 1-2 (T=3), one (T=1)), filter taps
SPLIT_CASES = [("sigmoid", True, True, 3, 13, 15), ("softmax", True, False, 3, 13, 15),
               ("sigmoid", True, False, 2, 37, 31), ("softmax", True, True, 2, 37, 31),
               ("sigmoid", True, True, 3, 3, 15), ("softmax", True, False, 2, 1, 15),
               ("softmax", False, True, 3, 13, 15), ("sigmoid", True, True, 2, 13, 1),
               ("softmax", True, False, 3, 37, 1)]


@pytest.mark.parametrize("norm,location,dropout,B,T,K", SPLIT_CASES)
def test_split_attention_forward_matches_plain(norm, location, dropout, B, T, K):
    """6 steps: the split scan gives every output of `taco2_train_fwd_plain`
    within float32 rounding (rel L2 2e-6), whatever the parts; the windows
    of K = 15 and 31 reach across one or more parts' edges."""
    args = fwd_case(location, dropout, B, T, K)
    ref = taco2_train_fwd_plain(*args, norm=norm)
    got = fwd_split(*args, norm)
    for k in ref:
        rel = float((got[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-30))
        assert rel <= 2e-6, (k, rel)


def test_split_attention_forward_catches_a_wrong_halo_read():
    """The emulation sees a fault the kernel could make: window positions
    past a block's edges read from the wrong block move the alignments far
    past the tolerance."""
    args = fwd_case(True, False, 3, 37, 15)
    ref = taco2_train_fwd_plain(*args, norm="sigmoid")
    got = fwd_split(*args, "sigmoid", wrong_halo=True)
    rel = float((got["align"] - ref["align"]).norm() / ref["align"].norm())
    assert rel > 1e-3, rel


def test_plain_normalize_is_the_combined_norm():
    """The norm combined from parts (the kernel's softmax max / sum of exp
    partials, the sigmoid sums) is `_normalize` over the whole row."""
    e = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 37)).astype(np.float32))
    parts = [(0, 9), (9, 18), (18, 27), (27, 37)]
    m = [e[:, lo:hi].max(-1, keepdim=True).values for lo, hi in parts]
    M = torch.stack(m).max(0).values
    tot = sum(torch.exp(e[:, lo:hi] - mr).sum(-1, keepdim=True) * torch.exp(mr - M)
              for (lo, hi), mr in zip(parts, m))
    soft = torch.cat([torch.exp(e[:, lo:hi] - mr) * torch.exp(mr - M) / tot
                      for (lo, hi), mr in zip(parts, m)], 1)
    assert torch.allclose(soft, _normalize(e, "softmax")[0], rtol=1e-6, atol=1e-7)
    s = torch.sigmoid(e)
    sig = s / sum(s[:, lo:hi].sum(-1, keepdim=True) for lo, hi in parts).clamp_min(1e-8)
    assert torch.allclose(sig, _normalize(e, "sigmoid")[0], rtol=1e-6, atol=1e-7)
