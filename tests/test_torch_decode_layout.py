"""Host side of the persistent Tacotron2 decode kernel, on the CPU: its
weight layout (`pack_weights`: every input segment of a matrix zero-padded
to a multiple of 16 columns, rows to a multiple of 16, each matrix in the
register order of mma.sync.m16n8k16's A operand) checked against
`prepare_weights`, and its launch plan (`launch_plan`: row tiles a block,
k-tile slices an item, batch tiles, attention pairs and context chunks a
block, shared-memory bytes) and the batch slices of a batch too large for
one launch (`batch_slices`). The kernel itself is held against its plain
version in tests/test_torch_cuda.py, on the card."""

import numpy as np
import pytest
import torch

from your_voice_tts_torch.config import ModelConfig
from your_voice_tts_torch.models.common import sequence_mask
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.ops.taco2_decode import (BARRIERS, PRODUCTS, ROUND_PRODUCTS, TILE,
                                                   WARPS, batch_slices, fragment_order,
                                                   launch_plan,
                                                   pack_weights, tacotron2_decode_cuda,
                                                   tacotron2_decode_plain)

FULL = {"n_in": 80, "P": 256, "H1": 1024, "H2": 1024, "E": 512, "A": 128, "K": 31,
        "OW": 560}
# smoke widths, and odd ones where no segment starts on 8 columns
WIDTHS = [dict(prenet_dim=24, encoder_dim=32, attention_rnn_dim=48, decoder_rnn_dim=48,
               attention_dim=24, n_mels=20),
          dict(prenet_dim=20, encoder_dim=30, attention_rnn_dim=44, decoder_rnn_dim=36,
               attention_dim=13, n_mels=13)]


def small_weights(widths, seed=0):
    kw = dict(widths)
    n_mels = kw.pop("n_mels")
    cfg = ModelConfig(r=2, embedding_dim=kw["encoder_dim"], postnet_dim=16,
                      attention_location_filters=8, attention_location_kernel_size=15, **kw)
    model = Tacotron2(30, cfg, n_mels=n_mels, r_init=3, device="cpu", seed=seed)
    return model, model.decoder.decode_weights(torch.bfloat16)


def r16(n):
    return -(-n // 16) * 16


def unfragment(f):
    """[row tiles, k-tiles, 32, 8] fragment order -> the [R, K] matrix, by
    the PTX ISA's layout of the m16n8k16 A operand: lane L = 4g + q holds
    (row g, cols 2q, 2q + 1), (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..)."""
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


def segments(m, widths):
    """Cut a matrix's columns into its padded segments, after checking each
    segment's pad columns are zero."""
    out, c = [], 0
    for n in widths:
        seg = m[:, c:c + r16(n)]
        assert not seg[:, n:].any()
        out.append(seg[:, :n])
        c += r16(n)
    assert c == m.shape[1]
    return out


@pytest.mark.parametrize("widths", WIDTHS)
def test_packed_matrices_rebuild_every_weight(widths):
    _, w = small_weights(widths)
    d = w["dims"]
    NM, P, H1, H2, E, A, OW = (d[k] for k in ("n_in", "P", "H1", "H2", "E", "A", "OW"))
    pk = pack_weights(w)
    full = {k: w[k].float().numpy() for k in ("p1_w", "p2_w", "a_w", "q_w", "d_w", "o_w")}
    cases = [("p1", "p1_w", [NM], P), ("p2", "p2_w", [P], P), ("a", "a_w", [P, E, H1], 4 * H1),
             ("q", "q_w", [H1], A), ("d", "d_w", [H1, E, H2], 4 * H2),
             ("o", "o_w", [H2, E], OW + 1)]
    for key, src, widths_, rows in cases:
        f = pk[key]
        assert f.dtype == torch.bfloat16 and f.is_contiguous()
        assert tuple(f.shape) == (r16(rows) // 16, sum(r16(n) for n in widths_) // 16, 32, 8)
        m = unfragment(f)
        assert not m[rows:].any()
        got = np.concatenate(segments(m[:rows], widths_), 1)
        np.testing.assert_array_equal(got, full[src][:, :sum(widths_)])
    for key, n in (("p1_b", P), ("p2_b", P), ("o_b", OW + 1), ("a_b", 4 * H1),
                   ("d_b", 4 * H2)):
        b = pk[key]
        assert b.dtype == torch.float32 and b.shape[0] % 16 == 0 and not b[n:].any()
        np.testing.assert_array_equal(b[:n].numpy(), w[key].numpy())
    for key in ("v_w", "u"):
        assert torch.equal(pk[key], w[key])
    assert pack_weights(w) is pk                    # packed once, kept in w


@pytest.mark.parametrize("widths", WIDTHS)
def test_round_products_sum_to_the_lstm_gates(widths):
    """The kernel's split of each LSTM product over its rounds (a_w: x in
    R2, h1 in R4 and ctx in R6 of the step before; d_w: h1 in R3, ctx in
    R6, h2 in R7 of the step before) on padded inputs adds up to the plain
    version's product over [x | ctx | h]."""
    _, w = small_weights(widths)
    d = w["dims"]
    P, H1, H2, E = (d[k] for k in ("P", "H1", "H2", "E"))
    pk = pack_weights(w)
    g = torch.Generator().manual_seed(1)
    B = 5
    x, ctx, h1, h2 = (torch.randn(B, n, generator=g) for n in (P, E, H1, H2))
    pad = lambda t: torch.nn.functional.pad(t, (0, r16(t.shape[1]) - t.shape[1]))  # noqa: E731
    a = torch.from_numpy(unfragment(pk["a"]))[:4 * H1]
    c1, c2 = r16(P), r16(P) + r16(E)
    parts = pad(x) @ a[:, :c1].T + pad(h1) @ a[:, c2:].T + pad(ctx) @ a[:, c1:c2].T
    ref = torch.cat([x, ctx, h1], 1) @ w["a_w"].float()[:, :P + E + H1].T
    torch.testing.assert_close(parts, ref, rtol=1e-5, atol=1e-5)
    dm = torch.from_numpy(unfragment(pk["d"]))[:4 * H2]
    c1, c2 = r16(H1), r16(H1) + r16(E)
    parts = pad(h2) @ dm[:, c2:].T + pad(h1) @ dm[:, :c1].T + pad(ctx) @ dm[:, c1:c2].T
    ref = torch.cat([h1, ctx, h2], 1) @ w["d_w"].float()[:, :H1 + E + H2].T
    torch.testing.assert_close(parts, ref, rtol=1e-5, atol=1e-5)


def test_fragment_order_is_the_mma_a_operand():
    """A 32 x 48 matrix of distinct values: lane 4g + q of tile (1, 2) holds
    rows 16 + g, 16 + g + 8 at columns 32 + 2q (+1) and 32 + 2q + 8 (+1)."""
    m = torch.arange(32 * 48, dtype=torch.float32).reshape(32, 48)
    f = fragment_order(m)
    assert tuple(f.shape) == (2, 3, 32, 8)
    for lane in (0, 5, 31):
        g, q = divmod(lane, 4)
        want = [m[16 + r, 32 + c + j] for r, c in ((g, 2 * q), (g + 8, 2 * q), (g, 2 * q + 8),
                                                  (g + 8, 2 * q + 8)) for j in (0, 1)]
        assert f[1, 2, lane].tolist() == [float(v) for v in want]


def product_shapes(d, plan):
    """(16-row tiles, 16-column k-tiles) of each product, in PRODUCTS order."""
    P, H1, H2, A, OW = (d[k] for k in ("P", "H1", "H2", "A", "OW"))
    tp, ta, tq, td, to = (r16(n) // 16 for n in (P, 4 * H1, A, 4 * H2, OW + 1))
    NM, P_, E, H1_, H2_ = (plan[k] // 16 for k in ("NM16", "P16", "E16", "H116", "H216"))
    return [(tp, NM), (tp, P_), (ta, P_), (tq, H1_), (td, H1_), (ta, H1_), (td, E), (to, E),
            (ta, E), (to, H2_), (td, H2_)]


@pytest.mark.parametrize("B", [1, 3, 8, 11, 40])
@pytest.mark.parametrize("sms,T", [(132, 152), (132, 13), (114, 29)])
def test_launch_plan_covers_every_row_and_column(B, sms, T):
    d = FULL
    plan = launch_plan(d, B, T, sms)
    G = plan["blocks"]
    assert G == sms and plan["threads"] == 32 * WARPS and plan["barriers_per_step"] == BARRIERS
    assert plan["tiles"] == -(-B // TILE)
    for (tiles, nkt), ks, name in zip(product_shapes(d, plan), plan["ks"], PRODUCTS):
        owned = [len(range(b, tiles, G)) for b in range(G)]
        if name == "R1 p1 frame":          # every tile, on each block of layer 2
            owned = [tiles if n else 0 for n in owned]
        assert sum(owned) >= tiles and max(owned) == plan["tiles_per_block"][name]
        # the k-tile slices of an item cover every k-tile once
        per = -(-nkt // ks)
        covered = sorted(v for kk in range(ks)
                         for v in range(kk * per, min(nkt, kk * per + per)))
        assert covered == list(range(nkt))
        assert ks == 1 or max(owned) * ks <= WARPS
    tpb = plan["tiles_per_block"]
    items = [tpb[name] * ks for name, ks in zip(PRODUCTS, plan["ks"])]
    rounds = ROUND_PRODUCTS
    assert [[PRODUCTS[i][:2] for i in r] for r in rounds] == [
        ["R1"] * 2, ["R2"], ["R3"] * 2, ["R4"], ["R6"] * 3, ["R7"] * 2]
    # R1's two products run one after the other, the others side by side
    assert plan["SLOTS"] == max([max(items[0], items[1])]
                                + [sum(items[i] for i in r) for r in rounds[1:]])
    # the rounds whose weights are prefetched fit the buffer, the largest
    # of them sizes it; the others read from L2
    ktiles = [tpb[name] * n for name, (_, n) in zip(PRODUCTS, product_shapes(d, plan))]
    need = [sum(ktiles[i] for i in r) for r in rounds]
    fetched = [n for i, n in enumerate(need) if plan["WB_ROUNDS"] >> i & 1]
    assert plan["WBUF"] == max(fetched, default=0)
    assert all(n > plan["WBUF"] for i, n in enumerate(need) if not plan["WB_ROUNDS"] >> i & 1)
    assert (plan["GA"], plan["GD"], plan["GO"]) == (tpb["R2 a x"], tpb["R6 d ctx"],
                                                    tpb["R7 o h2"])
    assert (plan["GP"], plan["GQ"]) == (tpb["R1 p2 x1"], tpb["R3 q h1"])
    assert tpb["R1 p1 frame"] == -(-d["P"] // 16) and plan["X2LD"] == plan["P16"] + 8
    staged = [plan["NM16"], plan["P16"], plan["H116"], plan["E16"], plan["H216"],
              plan["E16"] + plan["H116"]]          # the last: the prologue's [ctx | h1]
    # the tile's row stride is 8 bf16 past a multiple of 16 (16-byte rows;
    # the 8 rows of a B-fragment load fall in distinct banks)
    assert plan["XLD"] == max(staged) + 8 and (plan["XLD"] // 2) % 8 == 4
    assert plan["PPB"] * G >= B * T and (plan["PPB"] - 1) * G < B * T
    CE = plan["E16"] // 8
    rows = []
    for b in range(G):                     # rows a block's context chunks touch
        i0, i1 = b * plan["CPB"], min(B * CE, (b + 1) * plan["CPB"])
        if i0 < i1:
            rows.append((i1 - 1) // CE - i0 // CE + 1)
    assert plan["CPB"] * G >= B * CE and max(rows) <= plan["ALN"] <= B
    assert plan["smem_bytes"] <= 227 * 1024


def test_launch_plan_at_full_width():
    """B=8: one batch tile, two row tiles (8 units) of each LSTM a block;
    200,704 bytes of shared memory, of them 98,304 the weight buffer (R3's
    and R7's 192 k-tiles) and 24 KB the items' slots (48 items in R6);
    up to 410 KB of weights a block a step (the 37.9 MB over 132 blocks,
    the tiles rounded up, and the prenet's first layer whole on 16 of
    them)."""
    plan = launch_plan(FULL, 8, 152, 132)
    assert (plan["tiles"], plan["GA"], plan["GD"], plan["GO"], plan["GP"], plan["GQ"]) == \
        (1, 2, 2, 1, 1, 1)
    assert plan["ks"] == [1, 16, 8, 16, 8, 8, 8, 16, 8, 16, 8]
    assert plan["smem_bytes"] == 200704 and plan["XLD"] == 1544 and plan["SLOTS"] == 48
    assert plan["WBUF"] == 192 and plan["WB_ROUNDS"] == 0b111111 and plan["PRE_SMEM"] == 1
    assert plan["weight_bytes_per_block"] == 409600


def test_launch_plan_places_pre_by_room_and_refuses_what_does_not_fit():
    """The pairs' W_k m + location sit in shared memory while they fit (B=32
    at T=152), in global memory past that (B=40); the accumulators grow with
    the batch tiles, so larger batches prefetch fewer rounds' weights
    (B=128, T=300) and past the limit of shared memory the plan raises
    (B=312 at T=152: 38 batch tiles fit, 39 do not)."""
    assert launch_plan(FULL, 32, 152, 132)["PRE_SMEM"] == 1
    big = launch_plan(FULL, 40, 152, 132)
    assert big["PRE_SMEM"] == 0 and big["smem_bytes"] <= 232448
    bigger = launch_plan(FULL, 128, 300, 132)
    assert bigger["WB_ROUNDS"] != 0b111111 and bigger["smem_bytes"] <= 232448
    assert launch_plan(FULL, 304, 152, 132)["smem_bytes"] <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(FULL, 312, 152, 132)


@pytest.mark.parametrize("B,T,want", [(8, 152, [(0, 8)]), (304, 152, [(0, 304)]),
                                      (312, 152, [(0, 160), (160, 312)]),
                                      (512, 152, [(0, 256), (256, 512)]),
                                      (300, 300, [(0, 152), (152, 300)]),
                                      (700, 152, [(0, 240), (240, 480), (480, 700)])])
def test_batch_slices_cut_what_one_launch_cannot_hold(B, T, want):
    """Any batch decodes: one launch where its plan fits, else the fewest
    slices of whole batch tiles that fit, as even as the tiles allow."""
    got = batch_slices(FULL, B, T, 132)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == B
    assert all(b1 == a0 for (_, b1), (a0, _) in zip(got, got[1:]))
    assert all(b0 % TILE == 0 for b0, _ in got)
    for b0, b1 in got:
        launch_plan(FULL, b1 - b0, T, 132)           # each fits
    if len(got) > 1:
        with pytest.raises(ValueError):             # one slice fewer would not
            launch_plan(FULL, -(-B // (len(got) - 1)), T, 132)


def test_batch_slices_refuse_what_one_tile_cannot_hold(monkeypatch):
    from your_voice_tts_torch.ops import taco2_decode as dec

    monkeypatch.setattr(dec, "SMEM_LIMIT", 64 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        batch_slices(FULL, 8, 152, 132)


@pytest.mark.parametrize("K", [31, 33, 65, 129])
def test_launch_plan_takes_any_location_filter(K):
    """A warp stages a pair's filter window 32 taps a pass: the windows take
    16 warps x 2 x K rounded up to 32 floats, and the folded filter 2 K A
    floats; what they leave decides the weight buffer."""
    plan = launch_plan(dict(FULL, K=K), 8, 152, 132)
    base = launch_plan(FULL, 8, 152, 132)
    windows = lambda k: WARPS * 2 * -(-k // 32) * 32 * 4  # noqa: E731
    filt = lambda k: -(-2 * k * 128 * 4 // 16) * 16  # noqa: E731
    pre = lambda p: -(-p["PPB"] * 128 * 4 // 16) * 16 * p["PRE_SMEM"]  # noqa: E731
    fixed = lambda p: p["smem_bytes"] - p["WBUF"] * 512 - pre(p)  # noqa: E731
    assert fixed(plan) - fixed(base) == windows(K) - windows(31) + filt(K) - filt(31)
    assert plan["smem_bytes"] <= 232448


def test_packing_leaves_the_plain_decode_alone():
    """The packed layout lives in w["packed"]; the plain version reads only
    prepare_weights' own tensors, bit-for-bit as before."""
    model, w = small_weights(WIDTHS[0])
    g = torch.Generator().manual_seed(2)
    B, T = 3, 9
    enc = 0.5 * torch.randn(B, T, 32, generator=g)
    pinp = model.decoder.attention.preprocess_inputs(enc).detach()
    mask = sequence_mask(torch.tensor([9, 7, 4]), T)
    kw = dict(r=2, max_steps=6, seed=3, chunk=4)
    fresh = {k: v for k, v in w.items() if k != "packed"}
    before = tacotron2_decode_plain(fresh, enc, pinp, mask, **kw)
    pack_weights(w)
    after = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_kernel_wrapper_takes_cuda_tensors_only():
    model, w = small_weights(WIDTHS[0])
    enc = torch.zeros(2, 5, 32)
    pinp = model.decoder.attention.preprocess_inputs(enc).detach()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tacotron2_decode_cuda(w, enc, pinp, torch.ones(2, 5, dtype=torch.bool), r=2,
                              max_steps=4)
