"""The host side of kernel 4, the per-iteration Griffin-Lim loop on the card
(csrc/griffin_lim.cu `gl_plain`), on the CPU: its K-major constants and
Nyquist vectors, its launch plan, its launch schedule, the ctypes mirror of
its arguments, and a PyTorch emulation of its launches (wgmma accumulator
fragments, the register epilogues and their stores, the OLA's reduction
order, the Nyquist bin on the side) against `gl_iteration_plain`.
"""

import re

import numpy as np
import pytest
import torch
from test_torch_gl_layout import CSRC, SMEM_LIMIT, c_constant, covered, fragments

from your_voice_tts_torch.ops.filters import hann_window
from your_voice_tts_torch.ops.griffin_lim import (GEMM_BK, GEMM_BM, _Gli, _Rows, _rounding,
                                                  banded_ola, dft_matrices, fgla_plan,
                                                  gl_iteration_plain,
                                                  gl_iteration_plan, gl_iteration_schedule,
                                                  pack_spectrum, unpacked_constants)

BF16 = torch.bfloat16


@pytest.mark.parametrize("n_fft", [128, 256, 384, 1024, 2048])
def test_k_major_constants_are_the_reference_entries(n_fft):
    """synT and anaT are bf16 of the reference's DFT entries over bins
    0 .. N/2 - 1, rearranged (no scale folded in), bit for bit, and the
    same bits as the padded `syn` / `ana` the plain version reads; the
    Nyquist vectors are the reference's bf16 entries iC[N/2] and C[:, N/2]:
    exactly (-1)^n / N (where N is a power of two) and (-1)^n."""
    half = n_fft // 2
    c = unpacked_constants(n_fft, n_fft // 4, hann_window(n_fft, n_fft), BF16)
    C, S, iC, iS = (torch.from_numpy(a) for a in dft_matrices(n_fft))
    assert c["synT"].dtype == c["anaT"].dtype == BF16
    assert c["synT"].is_contiguous() and c["anaT"].is_contiguous()
    assert torch.equal(c["synT"], torch.cat([iC[:half], -iS[:half]], 0).T.to(BF16))
    assert torch.equal(c["anaT"], torch.cat([C[:, :half], -S[:, :half]], 1).T.to(BF16))
    Kp = c["Kp"]
    assert torch.equal(c["synT"].T, torch.cat([c["syn"][:half], c["syn"][Kp:Kp + half]], 0))
    assert torch.equal(c["anaT"].T, torch.cat([c["ana"][:, :half], c["ana"][:, Kp:Kp + half]], 1))
    alt = 1.0 - 2.0 * (torch.arange(n_fft) % 2)
    assert torch.equal(c["nyq_syn"], iC[half].to(BF16).float())
    assert torch.equal(c["nyq_ana"], alt) and torch.equal(C[:, half], alt)
    if n_fft & (n_fft - 1) == 0:
        assert torch.equal(c["nyq_syn"], alt / n_fft)
    assert c["nyq_syn"].dtype == c["nyq_ana"].dtype == torch.float32
    # what the card drops: the Nyquist bin's imaginary parts
    assert float(S[:, half].abs().max()) < 1e-11 and float(iS[half].abs().max()) < 1e-14


@pytest.mark.parametrize("n_fft", [256, 1024, 2048])
@pytest.mark.parametrize("B,T", [(8, 1760), (1, 1760), (3, 37), (1, 5), (2, 129)])
@pytest.mark.parametrize("sms", [132, 16])
def test_gl_iteration_plan_covers_every_output_once(n_fft, B, T, sms):
    """The kernel's stages and threads under the card's shared memory; the
    synthesis tiles cover every column once; the analysis tiles every real
    and imaginary part of bins 0 .. N/2 - 1 once, column tile 0 the Nyquist
    bin of the last iteration's spectrum, so each of its Kf bins is
    written once; the row tiles cover every frame; the OLA every sample of
    every frame within its threads' limit."""
    M, half = B * T, n_fft // 2
    p = gl_iteration_plan(n_fft, n_fft // 4, M, sms)
    bn = p["bn"]
    assert bn in (128, 256) and n_fft % bn == 0
    assert p["stages"] == c_constant("kStages") and p["threads"] == c_constant("kGThreads")
    assert p["stages"] * (GEMM_BM + bn) * GEMM_BK * 2 < p["smem"] < SMEM_LIMIT
    cols, rows_tiles = p["grid"]
    assert cols == n_fft // bn and rows_tiles * GEMM_BM == p["rows_pad"]
    assert M <= p["rows_pad"] < M + GEMM_BM
    synth = torch.zeros(n_fft, dtype=torch.int64)
    plane = torch.zeros(n_fft, dtype=torch.int64)
    spectrum = torch.zeros(2, half + 1, dtype=torch.int64)           # Fr', Fi' of the last
    for x in range(cols):
        synth[x * bn:(x + 1) * bn] += 1
        j0 = x * bn // 2                          # the two TMA boxes of anaT's rows
        plane[j0:j0 + bn // 2] += 1
        plane[half + j0:half + j0 + bn // 2] += 1
        spectrum[:, j0:j0 + bn // 2] += 1
        if x == 0:
            spectrum[:, half] += 1
    assert bool((synth == 1).all()) and bool((plane == 1).all())
    assert bool((spectrum == 1).all())
    ola = p["ola"]
    assert ola["tpr"] % 16 == 0 and ola["threads"] <= 256
    assert bool((covered(ola, n_fft // 8, 8, M) == 1).all())


@pytest.mark.parametrize("B,T,sms,bn", [(1, 1760, 132, 128), (2, 1760, 132, 256),
                                        (8, 1760, 132, 256), (1, 1760, 16, 256),
                                        (3, 37, 132, 128)])
def test_gl_iteration_plan_takes_narrow_tiles_where_sms_idle(B, T, sms, bn):
    """Tiles of 128 columns where tiles of 256 would take longer in waves of
    one block an SM, a 256-column tile costing 1.5 of 128 (B=1, T=1,760: 56
    blocks of 256 on 132 SMs, 112 of 128); 256 at the Tacotron(1) path's
    batch of 8, or where the SMs are few; kernels 2 and 3 keep theirs."""
    assert gl_iteration_plan(1024, 256, B * T, sms)["bn"] == bn
    assert fgla_plan(1024, 256, B * T)["bn"] == 256
    assert gl_iteration_plan(384, 96, B * T, sms)["bn"] == 128


@pytest.mark.parametrize("n_iters", [0, 1, 24])
def test_gl_iteration_schedule_counts_3n(n_iters):
    s = gl_iteration_schedule(n_iters)
    assert s == ["synth", "ola", "analysis"] * n_iters and len(s) == 3 * n_iters


def test_gl_iteration_ctypes_mirror_matches_the_c_struct():
    """`_Gli` lists `Gli`'s fields in its order with its types."""
    kinds = {"c_int": "int", "c_float": "float", "c_void_p": "ptr", "_Rows": "Rows"}
    for struct, mirror in (("Rows", _Rows), ("Gli", _Gli)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", CSRC.read_text(), re.S).group(1)
        fields = []
        for decl in filter(None, (d.strip() for d in body.split(";"))):
            kind = "ptr" if "*" in decl else decl.split()[0]
            names = re.sub(r"^(const\s+)?(int|float|void|Rows)\s*", "", decl)
            fields += [(n.replace("*", "").strip(), kind) for n in names.split(",")]
        assert [(n, kinds[t.__name__]) for n, t in mirror._fields_] == fields


def synth_epilogue(acc_tiles, row0, col0, bn, M, frN, nyq_syn, win, xw, written, rnd):
    """`fgla_gemm_kernel`'s synthesis epilogue with kPlain: each thread's
    accumulators into the ring's f32 tile (row stride bn + 8), then thread t
    takes float4 chunk t % (bn / 4) of rows t // (bn / 4) + k (256 // (bn /
    4)): xw = (tile + bf16(frN) (x) nyq_syn) * win."""
    Cs = torch.full((128, bn + 8), float("nan"))
    for rl, C, acc in acc_tiles:
        Cs[rl, C] = acc
    chunks, step = bn // 4, 256 // (bn // 4)
    t = torch.arange(256)[:, None, None]
    r = t // chunks + step * torch.arange(128 // step)[None, :, None]   # thread t's rows
    c = (4 * (t % chunks) + torch.arange(4)).expand(r.shape[0], r.shape[1], 4)
    r = r.expand_as(c)
    keep = row0 + r < M
    r, c = r[keep], c[keep]
    rows, cols = row0 + r, col0 + c
    xw[rows, cols] = (Cs[r, c] + rnd(frN)[rows] * nyq_syn[cols]) * win[cols]
    written.index_put_((rows, cols), torch.ones_like(rows), accumulate=True)


def ola_nyquist(g, m_nyq, nyq_ana):
    """The OLA launch's Nyquist channel: each thread's 8 samples of the
    rounded g times C[:, N/2], 16-lane butterflies, one thread a row adding
    its row's partials in order; frN = mag_N gn rsqrt(max(gn^2, 1e-30))."""
    M, N = g.shape
    lanes = (g * nyq_ana).reshape(M, N // 8, 8).sum(-1).reshape(M, -1, 16)
    for o in (8, 4, 2, 1):                        # __shfl_xor_sync butterflies
        lanes = lanes + lanes[..., torch.arange(16) ^ o]
    gn = torch.zeros(M)
    for i in range(lanes.shape[1]):
        gn = gn + lanes[:, i, 0]
    return m_nyq * gn * torch.rsqrt(torch.clamp(gn * gn, min=1e-30))


def card_synthesis(P, frN, consts, plan, M):
    """A synthesis launch: the tiles' accumulators (the wgmma sums of the
    packed plane times synT, one sum over N) in the fragment layout, then
    the staged epilogue with the Nyquist row and the window; every sample
    written once. -> xw [M, N]."""
    n_fft, bn, (cols, row_tiles) = consts["n_fft"], plan["bn"], plan["grid"]
    prod = P @ consts["synT"].float().T
    xw = torch.full((M, n_fft), float("nan"))
    written = torch.zeros(M, n_fft, dtype=torch.int64)
    for y in range(row_tiles):
        for x in range(cols):
            tiles = fragments(prod, y * GEMM_BM, lambda c: x * bn + c, bn)  # noqa: B023
            synth_epilogue(tiles, y * GEMM_BM, x * bn, bn, M, frN, consts["nyq_syn"],
                           consts["win"], xw, written, _rounding(consts["dtype"]))
    assert bool((written == 1).all())
    return xw


def card_ola(xw, mag, consts, B, T):
    """An OLA launch: g = bf16(acc * wsi * win) and the Nyquist channel over
    the rounded g. -> (g [M, N], frN [M])."""
    n_fft, hop = consts["n_fft"], consts["hop"]
    M, rnd = B * T, _rounding(consts["dtype"])
    acc = banded_ola(xw.reshape(B, T, n_fft), n_fft, hop).reshape(M, n_fft)
    g = rnd(acc * consts["wsi"] * consts["win"])
    return g, ola_nyquist(g, mag.reshape(M, -1)[:, n_fft // 2], consts["nyq_ana"])


def card_analysis(g, mag, frN, consts, plan, last):
    """An analysis launch: the plain projection from each thread's
    registers (its real column c pairs with its imaginary column c + bn/2
    in the same row); bf16 P staged as two planes and stored as 16-byte
    chunks, or on the last iteration (`last`) the f32 spectrum stored from
    the registers and the Nyquist bin (frN, 0) from column tile 0; every
    output written once. The tiles' sums are the analysis products as the
    plain version forms them (g @ C, -(g @ S) over the same K = N; anaT
    holds the same bf16 entries, test above). -> P [M_pad, N], or
    (Fr', Fi') [M, Kf]."""
    M, n_fft = g.shape
    half, Kf, Kp = n_fft // 2, n_fft // 2 + 1, consts["Kp"]
    bn, (cols, row_tiles), pad = plan["bn"], plan["grid"], plan["rows_pad"]
    rnd = _rounding(consts["dtype"])
    ana = consts["ana"].float()
    G = torch.zeros(pad, n_fft)
    G[:M] = torch.cat([(g @ ana[:, :Kf])[:, :half], (-(g @ -ana[:, Kp:Kp + Kf]))[:, :half]], -1)
    m = mag.reshape(M, Kf)
    real = torch.tensor([r for r in range(bn // 2) if r // 4 < bn // 16])
    imag = real + bn // 4                         # register 4 (g + bn/16) + 2 i + j
    if last:
        out = torch.full((2, M, Kf), float("nan"))
        written = torch.zeros(2, M, Kf, dtype=torch.int64)
    else:
        out = torch.zeros(pad, n_fft)
        written = torch.zeros(M, n_fft, dtype=torch.int64)
    for y in range(row_tiles):
        for x in range(cols):
            row0, j0 = y * GEMM_BM, x * bn // 2
            col_of = lambda c: torch.where(c < bn // 2, j0 + c, half + j0 + c - bn // 2)  # noqa: B023,E731
            planes = torch.full((2, 128, bn // 2 + 8), float("nan"))
            for rl, C, acc in fragments(G, row0, col_of, bn):
                assert torch.equal(rl[:, real], rl[:, imag])
                assert torch.equal(C[:, imag], C[:, real] + bn // 2)
                r, c = rl[:, real], C[:, real]
                keep = row0 + r < M
                r, c = r[keep], c[keep]
                rows, bins = row0 + r, j0 + c
                gr, gi = acc[:, real][keep], acc[:, imag][keep]
                inv = torch.rsqrt(torch.clamp(gr * gr + gi * gi, min=1e-30))
                vr, vi = m[rows, bins] * gr * inv, m[rows, bins] * gi * inv
                if last:                          # f32 straight from the registers
                    out[0, rows, bins], out[1, rows, bins] = vr, vi
                    written[:, rows, bins] += 1
                else:
                    planes[0, r, c], planes[1, r, c] = rnd(vr), rnd(vi)
            if last:
                if x == 0:                        # the Nyquist bin: (frN, 0)
                    rows = torch.arange(row0, min(row0 + GEMM_BM, M))
                    out[0, rows, half], out[1, rows, half] = frN[rows], 0.0
                    written[:, rows, half] += 1
                continue
            chunks = bn // 16                     # two planes, 16-byte chunk e a thread
            e = torch.arange(2 * 128 * chunks)
            cc, r, pl = e % chunks, (e // chunks) % 128, e // (128 * chunks)
            keep = row0 + r < M
            cc, r, pl = cc[keep, None], r[keep, None], pl[keep, None]
            k = 8 * cc + torch.arange(8)
            rows, cs = (row0 + r).expand_as(k), pl * half + j0 + k
            out[rows, cs] = planes[pl.expand_as(k), r.expand_as(k), k]
            written.index_put_((rows, cs), torch.ones_like(rows), accumulate=True)
    assert bool((written == 1).all())
    return (out[0], out[1]) if last else out


def card_state(Fr, Fi, consts, pad):
    """The loop state the wrapper hands `gl_plain`: the packed plane
    rounded to the loop dtype, zero rows to M_pad, and the Nyquist channel."""
    n_fft = consts["n_fft"]
    p0, n0 = pack_spectrum(Fr, Fi, n_fft)
    P = torch.zeros(pad, n_fft)
    P[:n0.numel()] = _rounding(consts["dtype"])(p0).reshape(-1, n_fft)
    return P, n0.reshape(-1)


def card_iterations(Fr, Fi, mag, consts, n_iters):
    """`gl_plain`'s 3 n_iters launches built the card's way, free-running.
    -> (Fr', Fi') [B, T, Kf]."""
    B, T, Kf = mag.shape
    plan = gl_iteration_plan(consts["n_fft"], consts["hop"], B * T)
    P, frN = card_state(Fr, Fi, consts, plan["rows_pad"])
    for it in range(n_iters):
        g, frN = card_ola(card_synthesis(P, frN, consts, plan, B * T), mag, consts, B, T)
        P = card_analysis(g, mag, frN, consts, plan, it + 1 == n_iters)
    return P[0].reshape(B, T, Kf), P[1].reshape(B, T, Kf)


def plain_step(Fr, Fi, mag, consts):
    """One iteration of `gl_iteration_plain`'s loop with its intermediates:
    (xw, g, Fr', Fi'), the same ops in the same order."""
    n_fft, hop, Kp = consts["n_fft"], consts["hop"], consts["Kp"]
    Kf, rnd = n_fft // 2 + 1, _rounding(consts["dtype"])
    syn, ana = consts["syn"].float(), consts["ana"].float()
    iC, iS = syn[:Kf], -syn[Kp:Kp + Kf]
    C, S = ana[:, :Kf], -ana[:, Kp:Kp + Kf]
    xw = (rnd(Fr) @ iC - rnd(Fi) @ iS) * consts["win"]
    g = rnd(banded_ola(xw, n_fft, hop) * consts["wsi"] * consts["win"])
    gr, gi = g @ C, -(g @ S)
    inv = torch.rsqrt(torch.clamp(gr * gr + gi * gi, min=1e-30))
    return xw, g, mag * gr * inv, mag * gi * inv


def gl_case(n_fft, B, T):
    rng = np.random.default_rng(n_fft + B * T)
    Kf = n_fft // 2 + 1
    consts = unpacked_constants(n_fft, n_fft // 4, hann_window(n_fft, n_fft), BF16)
    mag = torch.from_numpy(np.abs(rng.standard_normal((B, T, Kf))).astype(np.float32) + 0.1)
    phase = torch.from_numpy((rng.random((B, T, Kf)) * 2 * np.pi).astype(np.float32))
    return mag * torch.cos(phase), mag * torch.sin(phase), mag, consts


CASES = [(128, 3, 43), (256, 2, 5), (384, 1, 7), (1024, 2, 70)]


@pytest.mark.parametrize("n_fft,B,T", CASES)
@pytest.mark.parametrize("n_iters", [1, 3])
def test_card_launches_match_plain_where_they_round_alike(n_fft, B, T, n_iters):
    """Each launch built the card's way from the plain loop's own state at
    that iteration, so both sides round the same values at the same points
    (the spectrum into the synthesis, g, all else f32): the synthesis' xw
    to 1e-6 (f32 sum order: one sum over the packed plane, the Nyquist row
    added after); fed the same xw, the OLA's g bit for bit and its Nyquist
    channel to 1e-6; fed the same g, the analysis' f32 spectrum (the last
    iteration's store) and its bf16 plane to 1e-6. `plain_step` iterated is
    `gl_iteration_plain` bit for bit."""
    Fr, Fi, mag, consts = gl_case(n_fft, B, T)
    M, Kf, half = B * T, n_fft // 2 + 1, n_fft // 2
    plan = gl_iteration_plan(n_fft, consts["hop"], M)
    rnd = _rounding(BF16)
    fr, fi = Fr, Fi
    for _ in range(n_iters):
        xw_p, g_p, fr2, fi2 = plain_step(fr, fi, mag, consts)
        P, frN = card_state(fr, fi, consts, plan["rows_pad"])
        xw = card_synthesis(P, frN, consts, plan, M)
        assert float((xw - xw_p.reshape(M, n_fft)).abs().max()) <= 1e-6
        g, frN = card_ola(xw_p.reshape(M, n_fft), mag, consts, B, T)
        assert torch.equal(g, g_p.reshape(M, n_fft))
        assert float((frN - fr2.reshape(M, Kf)[:, half]).abs().max()) <= 1e-6
        out_r, out_i = card_analysis(g, mag, frN, consts, plan, True)
        P_next = card_analysis(g, mag, frN, consts, plan, False)
        for a, b in ((out_r, fr2), (out_i, fi2)):
            assert float((a - b.reshape(M, Kf)).abs().max()) <= 1e-6
        assert float((P_next[:M] - rnd(pack_spectrum(fr2, fi2, n_fft)[0]).reshape(M, n_fft))
                     .abs().max()) <= 1e-6
        fr, fi = fr2, fi2
    ref = gl_iteration_plain(Fr, Fi, mag, consts, n_iters=n_iters)
    assert torch.equal(fr, ref[0]) and torch.equal(fi, ref[1])


@pytest.mark.parametrize("n_fft,B,T", CASES)
@pytest.mark.parametrize("n_iters,tol", [(1, 1e-4), (3, 2e-3)])
def test_card_launches_run_the_plain_loop(n_fft, B, T, n_iters, tol):
    """The card's launches free-running from the same spectrum: one and
    three iterations against `gl_iteration_plain`. Where the synthesis' f32
    sum order moves xw across a bf16 boundary, g rounds one ulp apart on
    that sample, and the rows it touches move (here at most 18 of 140 rows
    at n_fft 1024 after one iteration); later iterations carry that on. So
    rel L2 1e-4 after one iteration and 2e-3 after three: a wrong layout,
    plane or Nyquist bin moves it by 1e-2 or more."""
    Fr, Fi, mag, consts = gl_case(n_fft, B, T)
    got = card_iterations(Fr, Fi, mag, consts, n_iters)
    ref = gl_iteration_plain(Fr, Fi, mag, consts, n_iters=n_iters)
    for a, b in zip(got, ref):
        assert a.shape == b.shape == mag.shape
    err = torch.cat([(a - b).flatten() for a, b in zip(got, ref)]).norm()
    assert float(err / torch.cat([b.flatten() for b in ref]).norm()) <= tol
