"""The host side of the packed Griffin-Lim loop on the card (kernels 2 and 3,
csrc/griffin_lim.cu `gl_fgla`), on the CPU: the launch plan, the launch
schedule, the ctypes mirror of the loop's arguments, and a PyTorch
emulation of the products' register epilogues in the wgmma accumulator
layout against one step of the plain loop.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from your_voice_tts_torch.ops.filters import hann_window
from your_voice_tts_torch.ops.griffin_lim import (GEMM_BK, GEMM_BM, _fgla_plain, _Fgla, _Rows,
                                                  _rounding, banded_ola, fgla_plan,
                                                  fgla_schedule, pack_init, packed_constants)

CSRC = Path(__file__).resolve().parents[1] / "your_voice_tts_torch" / "csrc" / "griffin_lim.cu"
SMEM_LIMIT = 232_448                 # the H100's shared memory a block


def fragment_coords(bn: int):
    """Where the wgmma accumulator of a 64 x bn warpgroup tile lives (PTX
    ISA, wgmma m64nNk16 f32 accumulator layout): (row, column) [128
    threads, bn/2 registers]. Register 4 g + 2 i + j of thread t holds row
    16 (t // 32) + (t % 32) // 4 + 8 i, column 8 g + 2 (t % 4) + j, as
    `fgla_gemm_kernel`'s epilogues read it."""
    t = torch.arange(128)[:, None]
    r = torch.arange(bn // 2)[None, :]
    g, i, j = r // 4, (r // 2) % 2, r % 2
    return (16 * (t // 32) + (t % 32) // 4 + 8 * i).expand(-1, bn // 2), 8 * g + 2 * (t % 4) + j


def c_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text()).group(1))


def covered(launch: dict, tasks: int, width: int, M: int) -> torch.Tensor:
    """How often each of a row's tasks * width outputs is written by an
    element-wise launch: thread c of a row takes tasks c, c + tpr, ..., each
    `width` neighbouring outputs (the OLA's, emit's and unpack's loops), on
    every row the blocks reach."""
    tpr, rows, threads, blocks = (launch[k] for k in ("tpr", "rows", "threads", "blocks"))
    assert tpr * rows <= threads and threads % 32 == 0 and blocks * rows >= M > (blocks - 1) * rows
    count = torch.zeros(tasks * width, dtype=torch.int64)
    for c in range(tpr):
        for task in range(c, tasks, tpr):
            count[task * width:(task + 1) * width] += 1
    return count


@pytest.mark.parametrize("n_fft", [*range(128, 2049, 128), 2176, 4096, 8192])
def test_fgla_plan_covers_every_output_once(n_fft):
    """Tiles of 256 columns where n_fft % 256 == 0, else 128; the kernel's
    stages and threads under the card's shared memory; the synthesis tiles
    cover every column once, the analysis tiles every real and imaginary
    part once; the row tiles cover every frame; the OLA, emit and unpack
    launches every sample and bin of every frame, within their threads'
    limits (256, 256, 512) at any n_fft the kernels take."""
    half = n_fft // 2
    for M in (2, 129, 4000):
        p = fgla_plan(n_fft, min(n_fft // 4, 1024), M)
        bn = p["bn"]
        assert bn == (256 if n_fft % 256 == 0 else 128) and n_fft % bn == 0
        assert p["stages"] == c_constant("kStages") and p["threads"] == c_constant("kGThreads")
        assert p["stages"] * (GEMM_BM + bn) * GEMM_BK * 2 < p["smem"] < SMEM_LIMIT
        cols, rows_tiles = p["grid"]
        assert cols == n_fft // bn and rows_tiles * GEMM_BM == p["rows_pad"]
        assert M <= p["rows_pad"] < M + GEMM_BM
        synth = torch.zeros(n_fft, dtype=torch.int64)
        analysis = torch.zeros(n_fft, dtype=torch.int64)
        for x in range(cols):
            synth[x * bn:(x + 1) * bn] += 1
            j0 = x * bn // 2                      # the two TMA boxes of Mf's rows
            analysis[j0:j0 + bn // 2] += 1
            analysis[half + j0:half + j0 + bn // 2] += 1
        assert bool((synth == 1).all()) and bool((analysis == 1).all())
        ola, unpack = p["ola"], p["unpack"]
        assert ola["tpr"] % 16 == 0 and ola["threads"] <= 256 and unpack["threads"] <= 512
        assert bool((covered(ola, n_fft // 8, 8, M) == 1).all())
        assert bool((covered(unpack, half // 2, 2, M) == 1).all())
    for hop in {1, 3, 275, min(n_fft // 2, 1024)}:      # any hop the kernels take
        if 2 * hop <= n_fft:
            emit = fgla_plan(n_fft, hop, 7)["emit"]
            # 4 neighbouring samples a task where hop % 4 == 0, else one
            tasks, width = (hop // 4, 4) if hop % 4 == 0 else (hop, 1)
            assert emit["threads"] <= 256
            assert bool((covered(emit, tasks, width, 7) == 1).all())


@pytest.mark.parametrize("n_iters", [0, 1, 24])
def test_fgla_schedule_counts_3n_plus_2_and_3n_plus_1(n_iters):
    wave, full = fgla_schedule(n_iters, "wave"), fgla_schedule(n_iters, "full")
    assert len(wave) == 3 * n_iters + 2 and len(full) == 3 * n_iters + 1
    assert wave[:3 * n_iters] == full[:3 * n_iters] == ["synth", "ola", "analysis"] * n_iters
    assert wave[3 * n_iters:] == ["synth", "emit"] and full[3 * n_iters:] == ["unpack"]


def test_ctypes_mirror_matches_the_c_struct():
    """`_Fgla` lists `Fgla`'s fields in its order with its types."""
    kinds = {"c_int": "int", "c_float": "float", "c_void_p": "ptr", "_Rows": "Rows"}
    for struct, mirror in (("Rows", _Rows), ("Fgla", _Fgla)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", CSRC.read_text(), re.S).group(1)
        fields = []
        for decl in filter(None, (d.strip() for d in body.split(";"))):
            kind = "ptr" if "*" in decl else decl.split()[0]
            names = re.sub(r"^(const\s+)?(int|float|void|Rows)\s*", "", decl)
            fields += [(n.replace("*", "").strip(), kind) for n in names.split(",")]
        assert [(n, kinds[t.__name__]) for n, t in mirror._fields_] == fields


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k_major_constants_are_the_transposes(dtype):
    """Each DFT matrix is stored once, K-major (MwT, Mf); Mw and MfT are
    views of that storage."""
    c = packed_constants(256, 64, hann_window(256, 256), dtype)
    assert torch.equal(c["MwT"], c["Mw"].T) and torch.equal(c["Mf"], c["MfT"].T)
    assert c["MwT"].is_contiguous() and c["Mf"].is_contiguous()
    assert c["Mw"].data_ptr() == c["MwT"].data_ptr() and c["MfT"].data_ptr() == c["Mf"].data_ptr()


def fragments(product, row0, col_of, bn):
    """The accumulators of a product's tile at rows row0 .. row0 + 127 in
    the wgmma layout: [(tile rows, tile columns, values)] a warpgroup, each
    [128 threads, bn/2 registers]; tile column c reads product column
    col_of(c)."""
    R, C = fragment_coords(bn)
    return [(64 * wg + R, C, product[row0 + 64 * wg + R, col_of(C)]) for wg in range(2)]


def synth_epilogue(acc_tiles, row0, col0, bn, M, frN, altw, xw, written):
    """`fgla_gemm_kernel`'s synthesis epilogue: each thread's accumulators
    into the ring's f32 tile (row stride bn + 8), then thread t adds
    frN (x) altw to float4 chunk t % (bn / 4) of rows t // (bn / 4) + k
    (256 // (bn / 4)) and stores it."""
    Cs = torch.full((128, bn + 8), float("nan"))
    for rl, C, acc in acc_tiles:
        Cs[rl, C] = acc
    chunks, step = bn // 4, 256 // (bn // 4)
    for t in range(256):
        c = 4 * (t % chunks) + torch.arange(4)
        for r in range(t // chunks, 128, step):
            if row0 + r >= M:
                break
            xw[row0 + r, col0 + c] = Cs[r, c] + frN[row0 + r] * altw[col0 + c]
            written[row0 + r, col0 + c] += 1


def analysis_epilogue(planes, row0, j0, half, bn, M, P, pP, written):
    """Its analysis epilogue's stores: four staged bf16 planes (P and pP,
    real and imaginary), 16-byte chunk e % (bn / 16) of row (e // (bn / 16))
    % 128 of plane e // (128 bn / 16) for e = t, t + 256, ...; `written`
    counts P's and pP's stores apart."""
    chunks = bn // 16
    for e in range(4 * 128 * chunks):
        cc, r, plane = e % chunks, (e // chunks) % 128, e // (128 * chunks)
        if row0 + r >= M:
            continue
        cols = (plane & 1) * half + j0 + 8 * cc + torch.arange(8)
        (P if plane < 2 else pP)[row0 + r, cols] = planes[plane, r, 8 * cc + torch.arange(8)]
        written[plane // 2, row0 + r, cols] += 1


@pytest.mark.parametrize("n_fft,B,T", [(128, 3, 43), (256, 2, 5), (384, 1, 7), (1024, 2, 70)])
def test_register_epilogues_reproduce_one_fgla_step(n_fft, B, T):
    """One FGLA step built the card's way: the synthesis tiles' accumulators
    staged and stored with the Nyquist column, the banded OLA, the Nyquist
    projection summed as the OLA kernel sums it (8 samples a thread, 16-lane
    trees, a row's partials in order), and the analysis tiles' FGLA update
    from the registers each thread holds (its real column c pairs with its
    imaginary column c + bn/2 in the same thread and row), staged and
    stored. The plane, the previous projection and the Nyquist channel
    agree with `_fgla_plain` to 1e-6, and every sample and bin of every
    frame is written once."""
    rng = np.random.default_rng(n_fft + B * T)
    half, Kf, hop, mom = n_fft // 2, n_fft // 2 + 1, n_fft // 4, 0.95
    consts = packed_constants(n_fft, hop, hann_window(n_fft, n_fft), torch.bfloat16)
    mag = torch.from_numpy(np.abs(rng.standard_normal((B, T, Kf))).astype(np.float32) + 0.1)
    phase = torch.from_numpy((rng.random((B, T, Kf)) * 2 * np.pi).astype(np.float32))
    rnd = _rounding(torch.bfloat16)
    M = B * T
    plan = fgla_plan(n_fft, hop, M)
    bn, (cols, row_tiles), pad = plan["bn"], plan["grid"], plan["rows_pad"]
    p0, n0 = pack_init(mag, phase, n_fft)
    P = torch.zeros(pad, n_fft)
    P[:M] = rnd(p0).reshape(M, n_fft)
    frN = n0.reshape(M)

    # synthesis (the products as the plain loop forms them, [B, T, N] @ [N, N])
    prod = torch.zeros(pad, n_fft)
    prod[:M] = (rnd(p0) @ consts["Mw"].float()).reshape(M, n_fft)
    xw = torch.full((M, n_fft), float("nan"))
    written = torch.zeros(M, n_fft, dtype=torch.int64)
    for y in range(row_tiles):
        for x in range(cols):
            tiles = fragments(prod, y * GEMM_BM, lambda c: x * bn + c, bn)  # noqa: B023
            synth_epilogue(tiles, y * GEMM_BM, x * bn, bn, M, frN, consts["altw"], xw, written)
    assert bool((written == 1).all())
    acc_ola = banded_ola(xw.reshape(B, T, n_fft), n_fft, hop).reshape(M, n_fft)
    g = rnd(acc_ola)
    parts = (acc_ola * consts["nyq"]).reshape(M, n_fft // 8, 8).sum(-1)
    lanes = parts.reshape(M, -1, 16)
    for o in (8, 4, 2, 1):                        # __shfl_xor_sync butterflies
        lanes = lanes + lanes[..., torch.arange(16) ^ o]
    gn = torch.zeros(M)
    for i in range(lanes.shape[1]):              # one thread a row, partials in order
        gn = gn + lanes[:, i, 0]
    tn = gn + mom * (gn - frN)
    frN_new = mag.reshape(M, Kf)[:, half] * tn * torch.rsqrt(torch.clamp(tn * tn, min=1e-30))

    # analysis: G = g @ MfT, real parts of bins j0 .. in the tile's first
    # half, their imaginary parts in the second
    G = torch.zeros(pad, n_fft)
    G[:M] = (g.reshape(B, T, n_fft) @ consts["MfT"].float()).reshape(M, n_fft)
    m = mag.reshape(M, Kf)
    P_new, pP_new = torch.full((M, n_fft), float("nan")), torch.full((M, n_fft), float("nan"))
    written = torch.zeros(2, M, n_fft, dtype=torch.int64)          # P, pP
    real = torch.tensor([r for r in range(bn // 2) if r // 4 < bn // 16])
    imag = real + bn // 4                        # register 4 (g + bn/16) + 2 i + j
    for y in range(row_tiles):
        for x in range(cols):
            row0, j0 = y * GEMM_BM, x * bn // 2
            col_of = lambda c: torch.where(c < bn // 2, j0 + c, half + j0 + c - bn // 2)  # noqa: B023,E731
            planes = torch.full((4, 128, bn // 2 + 8), float("nan"))
            for rl, C, acc in fragments(G, row0, col_of, bn):
                assert torch.equal(rl[:, real], rl[:, imag])
                assert torch.equal(C[:, imag], C[:, real] + bn // 2)
                r, c = rl[:, real], C[:, real]
                keep = row0 + r < M
                r, c = r[keep], c[keep]
                rows, bins = row0 + r, j0 + c
                gr, gi = acc[:, real][keep], acc[:, imag][keep]
                tr = gr + mom * (gr - P[rows, bins])          # pP = P before the first step
                ti = gi + mom * (gi - P[rows, half + bins])
                inv = torch.rsqrt(torch.clamp(tr * tr + ti * ti, min=1e-30))
                planes[0, r, c], planes[1, r, c] = rnd(m[rows, bins] * tr * inv), \
                    rnd(m[rows, bins] * ti * inv)
                planes[2, r, c], planes[3, r, c] = rnd(gr), rnd(gi)
            analysis_epilogue(planes, row0, j0, half, bn, M, P_new, pP_new, written)
    assert bool((written == 1).all())
    P_ref, frN_ref = _fgla_plain(mag, phase, consts, 1, mom)
    assert float((P_new - P_ref.reshape(M, n_fft)).abs().max()) <= 1e-6
    assert float((frN_new - frN_ref.reshape(M)).abs().max()) <= 1e-6
    assert torch.equal(pP_new, rnd(G[:M]))
