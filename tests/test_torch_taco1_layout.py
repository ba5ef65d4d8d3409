"""Host side of the persistent Tacotron(1) decode kernel, on the CPU: its
resident weight layout (`pack_weights`: every block's row tiles of every
matrix in one contiguous region, a GRU's rows in unit groups of three gate
tiles, each tile in the register order of mma.sync.m16n8k16's A operand)
checked against `prepare_weights`, its launch plan (`owned_tiles`,
`launch_plan`: unit groups a block, k-tile slices an item, batch tiles,
attention pairs and context chunks a block, shared-memory bytes) and the
batch slices of a batch too large for one launch. The kernel itself is held
against its plain version in tests/test_torch_cuda.py, on the card."""

import pytest
import torch

from your_voice_tts_torch.config import ModelConfig
from your_voice_tts_torch.models.common import sequence_mask
from your_voice_tts_torch.models.tacotron import Tacotron
from your_voice_tts_torch.ops.taco1_decode import (BARRIERS, MATRICES, OWNERS, PRODUCTS,
                                                   ROUNDS, SMEM_LIMIT, TILE, WARPS, launch_plan,
                                                   owned_tiles, pack_weights,
                                                   tacotron1_decode_cuda,
                                                   tacotron1_decode_plain)
from your_voice_tts_torch.ops.taco2_decode import batch_slices, fragment_order

FULL = {"NQ": 400, "NM": 80, "P1": 256, "P2": 128, "H": 256, "E": 256, "A": 128, "K": 31,
        "D": 256, "OW": 560}


def small_weights(width=32, n_mels=20, attention_dim=24, seed=0):
    cfg = ModelConfig(model="Tacotron", r=2, memory_size=5, tacotron_width=width,
                      attention_dim=attention_dim, attention_location_filters=8,
                      attention_location_kernel_size=15)
    dec = Tacotron(30, cfg, n_mels=n_mels, num_freq=129, r_init=5, device="cpu",
                   seed=seed).decoder
    return dec, dec.decode_weights(torch.bfloat16)


def r16(n):
    return -(-n // 16) * 16


def unfragment(f):
    """[row tiles, k-tiles, 32, 8] in `fragment_order` -> the [R, K] matrix
    (fragment_order itself is checked against the PTX layout in
    tests/test_torch_decode_layout.py)."""
    RT, KTn = f.shape[:2]
    n = RT * 16 * KTn * 16
    where = fragment_order(torch.arange(n, dtype=torch.float64).reshape(RT * 16, KTn * 16))
    out = torch.zeros(n)
    out[where.flatten().long()] = f.float().flatten()
    return out.reshape(RT * 16, KTn * 16)


def widths_of(d):
    return dict(d, **{"OW+1": d["OW"] + 1})


def ungate(m, H):
    """Unit groups of three gate tiles (row 48 (n // 16) + 16 g + n % 16)
    -> prepare_weights' interleaved rows 3 n + g."""
    n = torch.arange(H)
    out = torch.zeros((3 * H,) + tuple(m.shape[1:]))
    for g in range(3):
        out[3 * n + g] = m[48 * (n // 16) + 16 * g + n % 16]
    return out


def rebuild(w, G):
    """Each matrix [rows, k-tiles * 16] and bias from the blocks' resident
    regions alone, and the k-tiles and bias floats each block's region uses."""
    d = w["dims"]
    pk = pack_weights(w, G)
    own = owned_tiles(d, G)
    mats, bias, used_w, used_b = {}, {}, [0] * G, [0] * G
    for name, (wk, _, segs, _, _) in MATRICES.items():
        nkt = sum(r16(d[k]) for k in segs) // 16
        tiles = max(t for blocks in own[name] for t in blocks) + 1
        frag = torch.zeros(tiles, nkt, 32, 8, dtype=torch.bfloat16)
        b = torch.zeros(tiles * 16)
        for blk in range(G):
            for t in own[name][blk]:
                frag[t] = pk["w"][blk, used_w[blk]:used_w[blk] + nkt]
                b[16 * t:16 * t + 16] = pk["b"][blk, used_b[blk]:used_b[blk] + 16]
                used_w[blk] += nkt
                used_b[blk] += 16
        mats[name], bias[name] = unfragment(frag), b
    return pk, mats, bias, used_w, used_b


def cut(m, widths):
    """A padded matrix's segments, after checking each one's pad columns are
    zero, joined again."""
    out, c = [], 0
    for n in widths:
        seg = m[:, c:c + r16(n)]
        assert not seg[:, n:].any()
        out.append(seg[:, :n])
        c += r16(n)
    assert c == m.shape[1]
    return torch.cat(out, 1)


@pytest.mark.parametrize("width,n_mels,attention_dim,G", [(32, 20, 24, 132), (32, 20, 24, 5),
                                                         (40, 13, 13, 7), (24, 11, 20, 3)])
def test_resident_tiles_rebuild_every_weight(width, n_mels, attention_dim, G):
    """Every matrix and bias of prepare_weights comes back from the blocks'
    regions (GRU gate tiles ungrouped to rows 3 n + g); the pad rows and
    columns are zero, and so is each region past what its block holds."""
    _, w = small_weights(width, n_mels, attention_dim)
    d = w["dims"]
    dw = widths_of(d)
    pk, mats, bias, used_w, used_b = rebuild(w, G)
    plan = launch_plan(d, 8, 13, G)
    assert tuple(pk["w"].shape) == (G, plan["RES"], 32, 8) and pk["w"].dtype == torch.bfloat16
    assert tuple(pk["b"].shape) == (G, plan["BRES"]) and pk["b"].dtype == torch.float32
    assert max(used_w) == plan["RES"] and max(used_b) == plan["BRES"]
    for blk in range(G):
        assert not pk["w"][blk, used_w[blk]:].any() and not pk["b"][blk, used_b[blk]:].any()
    for name, (wk, bk, segs, rows, gru) in MATRICES.items():
        n = dw[rows]
        m, b = mats[name], bias[name]
        if gru:
            assert m.shape[0] == 3 * r16(n)
            m, b = ungate(m, n), ungate(b, n)
            pad = torch.ones(3 * r16(n), dtype=torch.bool)
            for g in range(3):
                pad[48 * (torch.arange(n) // 16) + 16 * g + torch.arange(n) % 16] = False
            assert not mats[name][pad].any() and not bias[name][pad].any()
        else:
            assert not m[n:].any() and not b[n:].any()
            m, b = m[:n], b[:n]
        widths = [d[k] for k in segs]
        torch.testing.assert_close(cut(m, widths), w[wk][:, :sum(widths)].float(), rtol=0,
                                   atol=0)
        ref_b = w[bk] if bk else torch.zeros(n)
        torch.testing.assert_close(b, ref_b, rtol=0, atol=0)
    assert pack_weights(w, G) is pk                  # packed once per grid, kept in w


def test_gru_gates_from_resident_tiles():
    """The kernel's GRU split (the input matrix over x in R3 and over ctx in
    R7 of the step before, the hidden matrix over h in R4 of the step
    before; each gate a tile of its unit group; biases in the epilogue)
    gives the plain version's cell update."""
    _, w = small_weights(40, 13, 13)
    d = w["dims"]
    P2, E, H = d["P2"], d["E"], d["H"]
    _, mats, bias, _, _ = rebuild(w, 7)
    g = torch.Generator().manual_seed(3)
    B = 5
    x, ctx, h = (torch.randn(B, n, generator=g) for n in (P2, E, H))
    pad = lambda t: torch.nn.functional.pad(t, (0, r16(t.shape[1]) - t.shape[1]))  # noqa: E731
    ax, ah = mats["ax"], mats["ah"]
    gx = pad(x) @ ax[:, :r16(P2)].T + pad(ctx) @ ax[:, r16(P2):].T + bias["ax"]
    gh = pad(h) @ ah.T + bias["ah"]
    unit = torch.arange(H)
    rows = lambda gate: 48 * (unit // 16) + 16 * gate + unit % 16  # noqa: E731
    r = torch.sigmoid(gx[:, rows(0)] + gh[:, rows(0)])
    z = torch.sigmoid(gx[:, rows(1)] + gh[:, rows(1)])
    n = torch.tanh(gx[:, rows(2)] + r * gh[:, rows(2)])
    got = (1 - z) * n + z * h
    wx, wh = w["a_wx"].float(), w["a_wh"].float()
    rgx = (torch.cat([x, ctx], 1) @ wx[:, :P2 + E].T + w["a_bx"]).view(B, H, 3)
    rgh = (h @ wh[:, :H].T + w["a_bh"]).view(B, H, 3)
    rr = torch.sigmoid(rgx[..., 0] + rgh[..., 0])
    rz = torch.sigmoid(rgx[..., 1] + rgh[..., 1])
    rn = torch.tanh(rgx[..., 2] + rr * rgh[..., 2])
    torch.testing.assert_close(got, (1 - rz) * rn + rz * h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", [1, 8, 11, 40])
@pytest.mark.parametrize("G,T", [(132, 160), (132, 13), (66, 160), (48, 29)])
def test_launch_plan_covers_every_tile_pair_and_chunk(B, G, T):
    """Every row tile of every matrix lies on exactly one block, a unit
    group whole on one block, a GRU's two matrices on the same blocks; the
    k-tile slices of an item cover every k-tile once; the (row, t) pairs
    and the context chunks are covered; shared memory fits at full width."""
    check_plan(FULL, B, T, G)


def check_plan(d, B, T, G):
    """The checks of `test_launch_plan_covers_every_tile_pair_and_chunk`
    on the plan at dims d; returns the plan."""
    plan = launch_plan(d, B, T, G)
    own = owned_tiles(d, G)
    assert plan["blocks"] == G and plan["threads"] == 32 * WARPS
    assert plan["barriers_per_step"] == BARRIERS == len(ROUNDS)
    assert plan["tiles"] == -(-B // TILE)
    for name, (tiles, grp, nkt, base) in plan["matrices"].items():
        held = sorted(t for blk in own[name] for t in blk)
        assert held == list(range(tiles))
        for blk in own[name]:
            assert len(blk) % grp == 0
            for i in range(0, len(blk), grp):       # a group's tiles together
                assert blk[i:i + grp] == list(range(blk[i], blk[i] + grp))
                assert blk[i] % grp == 0
        first = own[name][base]
        assert first[:grp] == list(range(grp))       # group 0 on the base block
        assert plan["tiles_per_block"][name] == max(len(blk) for blk in own[name])
    for names in OWNERS:
        assert all(own[n] == own[names[0]] for n in names[1:])
    for (rnd, m, seg, _), ks in zip(PRODUCTS, plan["ks"]):
        nk = r16(widths_of(d)[MATRICES[m][2][seg]]) // 16
        per = -(-nk // ks)
        covered = sorted(v for kk in range(ks) for v in range(kk * per, min(nk, kk * per + per)))
        assert covered == list(range(nk))
        assert ks == 1 or plan["tiles_per_block"][m] * ks <= WARPS
    assert plan["PPB"] * G >= B * T and (plan["PPB"] - 1) * G < B * T
    CE = plan["E16"] // 8
    rows = []
    for blk in range(G):                   # rows a block's context chunks touch
        i0, i1 = blk * plan["CPB"], min(B * CE, (blk + 1) * plan["CPB"])
        if i0 < i1:
            rows.append((i1 - 1) // CE - i0 // CE + 1)
    assert plan["CPB"] * G >= B * CE and max(rows) <= plan["ALN"] <= B
    # the widest staged input: R1's queue, ..., R9's and R10's [xd | h]
    assert plan["XLD"] == max([r16(d[k]) for k in ("NQ", "P1", "P2", "H", "E")]
                              + [2 * r16(d["D"])]) + 8
    assert (plan["XLD"] // 2) % 8 == 4
    assert plan["smem_bytes"] <= SMEM_LIMIT
    return plan


def test_launch_plan_at_full_width():
    """On 132 blocks every block holds exactly one unit group: the 16 unit
    groups of each of the three GRUs (an input and a hidden matrix each),
    the prenet's 16 + 8 row tiles, the query's 8, the projection's 16 and
    the mel projection's 36 (560 rows and the stop row). The largest region
    is an attention-GRU group's: 3 tiles x (24 + 16) k-tiles, 61,440
    bytes. 3.44 MB of bf16 weights in all, ~26 KB a block."""
    plan = launch_plan(FULL, 8, 160, 132)
    own = owned_tiles(FULL, 132)
    groups = [sum(len(own[n][blk]) // plan["matrices"][n][1] for n in
                  ("ax", "d1x", "d2x", "p1", "p2", "q", "pj", "m")) for blk in range(132)]
    assert groups == [1] * 132
    assert plan["RES"] == 120 and plan["BRES"] == 96 and plan["ACC"] == 6
    assert plan["HU"] == 16 and plan["SLOTS"] == 16 and plan["XLD"] == 520
    assert plan["smem_bytes"] == 131616
    total = sum(t * k for t, _, k, _ in plan["matrices"].values()) * 512
    assert total == 3448832


def test_launch_plan_refuses_what_does_not_fit():
    """The accumulators, states and pairs grow with the batch: the pairs'
    W_k m sit in shared memory while they fit (B=64 at T=160), are read from
    global memory past that (B=72), and at full width and T=160 one launch
    holds 96 rows on 132 blocks, not 104."""
    assert launch_plan(FULL, 64, 160, 132)["PIN_SMEM"] == 1
    assert launch_plan(FULL, 72, 160, 132)["PIN_SMEM"] == 0
    assert launch_plan(FULL, 96, 160, 132)["smem_bytes"] <= SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(FULL, 104, 160, 132)


@pytest.mark.parametrize("B,T,want", [(8, 160, [(0, 8)]), (96, 160, [(0, 96)]),
                                      (104, 160, [(0, 56), (56, 104)]),
                                      (300, 160, [(0, 80), (80, 160), (160, 240), (240, 300)])])
def test_batch_slices_cut_what_one_launch_cannot_hold(B, T, want):
    got = batch_slices(FULL, B, T, 132, plan=launch_plan)
    assert got == want
    for b0, b1 in got:
        launch_plan(FULL, b1 - b0, T, 132)           # each fits
        assert b0 % TILE == 0


def test_batch_slices_refuse_what_one_tile_cannot_hold(monkeypatch):
    from your_voice_tts_torch.ops import taco1_decode as dec

    monkeypatch.setattr(dec, "SMEM_LIMIT", 64 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        batch_slices(FULL, 8, 160, 132, plan=launch_plan)


@pytest.mark.parametrize("K", [15, 31, 35, 65])
def test_launch_plan_takes_any_location_filter(K):
    """A warp stages a pair's filter window 32 taps a pass: the windows take
    16 warps x 2 x K rounded up to 32 floats, and the folded filter 2 K A
    floats."""
    plan = launch_plan(dict(FULL, K=K), 8, 160, 132)
    base = launch_plan(FULL, 8, 160, 132)
    windows = lambda k: WARPS * 2 * -(-k // 32) * 32 * 4  # noqa: E731
    filt = lambda k: -(-2 * k * 128 * 4 // 16) * 16  # noqa: E731
    assert plan["PIN_SMEM"] == base["PIN_SMEM"] == 1
    assert plan["smem_bytes"] - base["smem_bytes"] == windows(K) - windows(31) + filt(K) - filt(31)


def test_packing_leaves_the_plain_decode_alone():
    """The resident layout lives in w["resident"]; the plain version reads
    only prepare_weights' own tensors, bit-for-bit as before."""
    dec, w = small_weights()
    g = torch.Generator().manual_seed(2)
    B, T = 3, 9
    enc = 0.5 * torch.randn(B, T, w["dims"]["E"], generator=g)
    pinp = dec.attention.preprocess_inputs(enc).detach()
    mask = sequence_mask(torch.tensor([9, 7, 4]), T)
    kw = dict(r=2, max_steps=6, seed=3, chunk=4)
    fresh = {k: v for k, v in w.items() if k != "resident"}
    before = tacotron1_decode_plain(fresh, enc, pinp, mask, **kw)
    pack_weights(w, 132)
    pack_weights(w, 5)
    assert set(w["resident"]) == {132, 5}
    after = tacotron1_decode_plain(w, enc, pinp, mask, **kw)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_kernel_wrapper_takes_cuda_tensors_only():
    dec, w = small_weights()
    enc = torch.zeros(2, 5, w["dims"]["E"])
    pinp = dec.attention.preprocess_inputs(enc).detach()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tacotron1_decode_cuda(w, enc, pinp, torch.ones(2, 5, dtype=torch.bool), r=2,
                              max_steps=4)
