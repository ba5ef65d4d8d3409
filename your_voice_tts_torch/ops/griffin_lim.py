"""Batched Griffin-Lim: the CUDA kernels (csrc/griffin_lim.cu), their plain
PyTorch versions, their host helpers, and the router that picks among them.

Counterparts of the JAX package's ops/pallas/griffin_lim.py with an
injected initial phase (the serving path's batch-invariant shared phase),
and of the route `ops/dsp.py griffin_lim_batch` takes between them for a
batch (`griffin_lim_batch` here):
- `griffin_lim_wave` (`griffin_lim_pallas_wave`): the FGLA loop with the
  final inverse STFT fused, magnitudes [B, T, n_fft/2 + 1] -> waveforms
  [B, hop * (T - 1)];
- `griffin_lim_full` (`griffin_lim_pallas_full`): the same FGLA loop,
  returning the complex spectrum [B, T, n_fft/2 + 1]; the caller runs the
  istft;
- `gl_iteration` (`gl_iteration_pallas`, driven by
  `griffin_lim_pallas_batch`): PLAIN Griffin-Lim iterations on the unpacked
  [T, n_fft/2 + 1] layout, momentum ignored.

The FGLA loop runs on the PACKED layout of the JAX kernel: the complex
spectrogram's first n_fft/2 bins as one [T, n_fft] real plane (real parts,
then imaginary parts) plus the real Nyquist bin as one column; window, OLA
normalization and DFT scales are folded into two [n_fft, n_fft] matrices
Mw (synthesis) and Mf (analysis), so one FGLA iteration is two square
matrix products around a banded overlap-add inside each utterance. The
loop state is rounded to `dtype` (bf16 by default, like the TPU kernel);
magnitudes, the Nyquist channel and accumulation stay f32. On the card one
C call issues the whole loop as dependent launches (`fgla_plan` is its
launch plan, `fgla_schedule` its launches in order).

The per-iteration route (kernel 4) keeps the reference's rounding points,
so no scale is folded into its matrices; on the card it runs on the same
engine and the same packed state (the plane and the Nyquist channel), its
B operands the reference's bf16 DFT entries rearranged over the first
n_fft/2 bins, one C call a call (`gl_iteration_plan`,
`gl_iteration_schedule`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

F32 = torch.float32
BF16 = torch.bfloat16


def ola_wsum_inv(window: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Interior overlap-add window-square normalization (reciprocal)."""
    K = -(-n_fft // hop) - 1
    wsum = np.zeros((n_fft,), np.float64)
    w = np.asarray(window, np.float64)
    for k in range(-K, K + 1):
        s = k * hop
        if s > 0:
            wsum[s:] += w[: n_fft - s] ** 2
        elif s < 0:
            wsum[: n_fft + s] += w[-s:] ** 2
        else:
            wsum += w ** 2
    return (1.0 / np.maximum(wsum, 1e-11)).astype(np.float32)


def packed_constants(n_fft: int, hop: int, window, dtype=BF16,
                     device="cpu") -> dict:
    """Fold window, OLA normalization and DFT scales into the packed
    synthesis matrix Mw [N, N] and analysis matrix Mf, plus the Nyquist
    analysis row `nyq`, its synthesis column `altw` and the emitted columns'
    normalization `wsic`. Each matrix is stored once, K-major (a row per
    output column) as the card's products read their B operand: `MwT` and
    `Mf`; `Mw` and `MfT` (xw = P @ Mw, G = g @ MfT) are their transposed
    views."""
    if n_fft % 2:
        raise ValueError("the packed Griffin-Lim loop needs an even n_fft")
    half = n_fft // 2
    _, _, iC, iS = dft_matrices(n_fft)
    M = np.concatenate([iC[:half], -iS[:half]], 0)
    win = np.asarray(window, np.float32)
    wsi = ola_wsum_inv(win, n_fft, hop)
    wsiwin = wsi * win
    w_k = np.full((half,), 2.0, np.float32)
    w_k[0] = 1.0
    sc2 = np.concatenate([n_fft / w_k, n_fft / w_k]).astype(np.float32)
    alt = (1.0 - 2.0 * (np.arange(n_fft) % 2)).astype(np.float32)
    c0 = half - hop
    t = lambda a, dt=F32: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    MwT, Mf = t((M * win[None, :]).T, dtype), t(M * wsiwin[None, :] * sc2[:, None], dtype)
    return {
        "n_fft": n_fft, "hop": hop, "dtype": dtype, "window": win, "wsi": wsi,
        "MwT": MwT, "Mf": Mf, "Mw": MwT.T, "MfT": Mf.T,
        "nyq": t(wsiwin * alt), "altw": t(win * alt / n_fft),
        "wsic": t(wsi[c0:c0 + hop]),
    }


def dft_matrices(n_fft: int):
    """Real DFT matrices (numpy f32; the JAX package's ops/dsp.py
    `_dft_matrices`): C [N, K], S [N, K], iC [K, N], iS [K, N] with
    rfft(x) = x@C - i x@S and irfft(Fr, Fi) = Fr@iC - Fi@iS."""
    K = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(K)[None, :] / n_fft
    C, S = np.cos(ang), np.sin(ang)
    w = np.full((K,), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(C), f32(S), f32(w[:, None] * C.T / n_fft), f32(w[:, None] * S.T / n_fft)


def unpacked_constants(n_fft: int, hop: int, window, dtype=BF16, device="cpu") -> dict:
    """The plain iteration's DFT matrices in `dtype`, with the Kf = n_fft/2
    + 1 bins padded to Kp (a multiple of 64) by zero rows and columns:
    `syn` [2 Kp, N] = [iC ; -iS] (xw = [Fr | Fi] @ syn) and `ana` [N, 2 Kp]
    = [C | -S] ([gr | gi] = g @ ana), plus the window and the interior OLA
    normalization, f32. For an even n_fft also the card's operands over the
    packed state (the first n_fft/2 bins' real parts, then their imaginary
    parts; `pack_spectrum`), each stored once, K-major (a row per output
    column), with no scale folded in: `synT` [N, N] = [iC[:N/2] ; -iS[:N/2]]
    transposed, `anaT` [N, N] = [C[:, :N/2] | -S[:, :N/2]] transposed, and
    the Nyquist bin's synthesis row `nyq_syn` = iC[N/2] rounded to `dtype`
    as the reference rounds it ((-1)^n / N, exact in bf16 where N is a power
    of two) and analysis column `nyq_ana` = C[:, N/2] = (-1)^n, held in
    f32."""
    Kf = n_fft // 2 + 1
    Kp = -(-Kf // 64) * 64
    C, S, iC, iS = dft_matrices(n_fft)
    syn = np.zeros((2 * Kp, n_fft), np.float32)
    syn[:Kf], syn[Kp:Kp + Kf] = iC, -iS
    ana = np.zeros((n_fft, 2 * Kp), np.float32)
    ana[:, :Kf], ana[:, Kp:Kp + Kf] = C, -S
    win = np.asarray(window, np.float32)
    t = lambda a, dt=F32: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    out = {"n_fft": n_fft, "hop": hop, "dtype": dtype, "Kp": Kp, "window": win,
           "syn": t(syn, dtype), "ana": t(ana, dtype), "win": t(win),
           "wsi": t(ola_wsum_inv(win, n_fft, hop))}
    if n_fft % 2 == 0:
        half = n_fft // 2
        out.update(synT=t(np.concatenate([iC[:half], -iS[:half]], 0).T, dtype),
                   anaT=t(np.concatenate([C[:, :half], -S[:, :half]], 1).T, dtype),
                   nyq_syn=t(iC[half], dtype).float(), nyq_ana=t(C[:, half]))
    return out


def gl_constants(n_fft: int, hop: int, window, dtype=BF16, device="cpu") -> dict:
    """Both layouts' constants, built once: what `griffin_lim_batch` takes."""
    return {"packed": packed_constants(n_fft, hop, window, dtype, device),
            "unpacked": unpacked_constants(n_fft, hop, window, dtype, device)}


def istft_edge_correction(T: int, n_fft: int, hop: int, window: np.ndarray,
                          wsi: np.ndarray) -> np.ndarray:
    """Exact istft normalization against the interior wsi: a length
    hop * (T - 1) factor, 1 except the first and last n_fft - hop samples,
    where frames before 0 / after T - 1 are missing from the window-square
    sum."""
    w2 = np.asarray(window, np.float64) ** 2
    pad = n_fft // 2
    c0 = pad - hop
    L = hop * (T - 1)
    wsum = np.zeros((n_fft + L,), np.float64)
    for t in range(T):
        wsum[t * hop: t * hop + n_fft] += w2
    raw = wsum[pad: pad + L]
    int_w = 1.0 / wsi.astype(np.float64)[c0 + (np.arange(L) % hop)]
    corr = np.where(raw > 1e-11, int_w / np.maximum(raw, 1e-11), int_w)
    return corr.astype(np.float32)


def pack_init(mag, init_phase, n_fft: int):
    """Magnitudes [B, T, Kf] and initial phase ([T, Kf] shared by every row,
    or [B, T, Kf]) -> packed initial plane [B, T, N] and Nyquist [B, T]."""
    half = n_fft // 2
    ph = init_phase.to(F32)
    m = mag[..., :half]
    p0 = torch.cat([m * torch.cos(ph[..., :half]), m * torch.sin(ph[..., :half])], -1)
    n0 = mag[..., half] * torch.cos(ph[..., half])
    return p0, n0.expand(mag.shape[:-1])


def pack_spectrum(Fr, Fi, n_fft: int):
    """Spectrum (Fr, Fi) [..., n_fft/2 + 1] -> the packed plane [..., N]
    (the real parts of bins 0 .. N/2 - 1, then their imaginary parts) and
    the Nyquist bin's real part [...]; its imaginary part is dropped (the
    reference's iS[N/2] is ~1e-16)."""
    half = n_fft // 2
    return torch.cat([Fr[..., :half], Fi[..., :half]], -1), Fr[..., half]


def banded_ola(xw, n_fft: int, hop: int):
    """acc[t, n] = overlap-added signal at sample t*hop + n of each
    utterance: K = ceil(n_fft/hop) - 1 shifted adds along the frame axis."""
    T = xw.shape[-2]
    acc = xw
    for k in range(1, -(-n_fft // hop)):
        if k >= T:
            break
        s = k * hop
        fwd = F.pad(xw[..., k:, : n_fft - s], (s, 0, 0, k))
        bwd = F.pad(xw[..., :-k, s:], (0, s, k, 0))
        acc = acc + fwd + bwd
    return acc


def _check(mag, consts):
    n_fft, hop = consts["n_fft"], consts["hop"]
    B, T, Kf = mag.shape
    if Kf != n_fft // 2 + 1 or T < 2 or n_fft < 2 * hop:
        raise ValueError(f"magnitudes {tuple(mag.shape)} do not fit n_fft "
                         f"{n_fft} / hop {hop} (need T >= 2, n_fft >= 2 hop)")
    return n_fft, hop, B, T


def _rounding(dtype):
    return (lambda x: x.to(BF16).float()) if dtype == BF16 else (lambda x: x)


def _fgla_plain(mag, init_phase, consts: dict, n_iters: int, momentum: float):
    """The packed FGLA loop in plain PyTorch ops: (P [B, T, N] rounded to the
    loop dtype, held in f32; Nyquist channel [B, T])."""
    n_fft, hop = consts["n_fft"], consts["hop"]
    half = n_fft // 2
    rnd = _rounding(consts["dtype"])
    Mw, MfT = consts["Mw"].float(), consts["MfT"].float()
    nyq, altw = consts["nyq"], consts["altw"]
    m = mag.to(F32)
    m2 = torch.cat([m[..., :half], m[..., :half]], -1)
    mn = m[..., half]
    p0, n0 = pack_init(m, init_phase, n_fft)
    P, frN = rnd(p0), n0
    pP, pN = P, frN
    for _ in range(n_iters):
        acc = banded_ola(P @ Mw + frN[..., None] * altw, n_fft, hop)
        G = rnd(acc) @ MfT
        gn = (acc * nyq).sum(-1)
        Tt = G + momentum * (G - pP)
        tN = gn + momentum * (gn - pN)
        inv = torch.rsqrt(torch.clamp(Tt[..., :half] ** 2 + Tt[..., half:] ** 2, min=1e-30))
        P = rnd(m2 * Tt * torch.cat([inv, inv], -1))
        frN = mn * tN * torch.rsqrt(torch.clamp(tN * tN, min=1e-30))
        pP, pN = rnd(G), gn
    return P, frN


def griffin_lim_wave_plain(mag, init_phase, consts: dict, *, n_iters: int,
                           momentum: float = 0.0):
    """The wave route in plain PyTorch ops, on any device: the reference the
    kernel is held against. Arguments as `griffin_lim_wave`."""
    n_fft, hop, B, T = _check(mag, consts)
    c0 = n_fft // 2 - hop
    P, frN = _fgla_plain(mag, init_phase, consts, n_iters, momentum)
    acc = banded_ola(P @ consts["Mw"].float() + frN[..., None] * consts["altw"], n_fft, hop)
    y = (acc[..., c0:c0 + hop] * consts["wsic"]).reshape(B, T * hop)[:, hop:]
    corr = istft_edge_correction(T, n_fft, hop, consts["window"], consts["wsi"])
    return y * torch.from_numpy(corr).to(y.device)


def griffin_lim_full_plain(mag, init_phase, consts: dict, *, n_iters: int,
                           momentum: float = 0.0):
    """The full route in plain PyTorch ops, on any device. Arguments as
    `griffin_lim_full`."""
    n_fft, _, _, _ = _check(mag, consts)
    half = n_fft // 2
    P, frN = _fgla_plain(mag, init_phase, consts, n_iters, momentum)
    return torch.complex(torch.cat([P[..., :half], frN[..., None]], -1),
                         torch.cat([P[..., half:], torch.zeros_like(frN)[..., None]], -1))


# --- the packed loop on the card (csrc/griffin_lim.cu `gl_fgla`) -------------------

# the product kernel's compile-time shape (csrc kGM, kGK, kGThreads, kStages)
GEMM_BM, GEMM_BK, GEMM_THREADS, GEMM_STAGES = 128, 64, 288, 4


def _row_launch(work: int, cap: int, M: int, align: int = 1) -> dict:
    """An element-wise launch over M rows of `work` thread-tasks each:
    `tpr` threads a row (a multiple of `align`, at most `cap`; each thread
    takes tasks c, c + tpr, ...), `rows` rows a block of up to 256 threads
    (one row past 256 threads a row), `threads` a block in whole warps,
    `blocks`."""
    passes = -(-work // cap)
    tpr = -(-work // (passes * align)) * align
    rows = max(1, 256 // tpr)
    return {"tpr": tpr, "rows": rows, "threads": -(-rows * tpr // 32) * 32, "blocks": -(-M // rows)}


def product_plan(n_fft: int, M: int, bn: int) -> dict:
    """The product launches of a loop over M = B * T frames: tiles of
    GEMM_BM rows x `bn` columns, `grid` = (column tiles, row tiles) over the
    rows padded to `rows_pad`, `threads` a block, a ring of `stages`
    k-slices of GEMM_BK in `smem` bytes."""
    stage = (GEMM_BM + bn) * GEMM_BK * 2
    rows_pad = -(-M // GEMM_BM) * GEMM_BM
    return {"bn": bn, "stages": GEMM_STAGES, "smem": 1024 + GEMM_STAGES * stage + 16 * GEMM_STAGES,
            "threads": GEMM_THREADS, "rows_pad": rows_pad,
            "grid": (n_fft // bn, rows_pad // GEMM_BM)}


def fgla_plan(n_fft: int, hop: int, M: int) -> dict:
    """The card's launch plan of the packed loop for M = B * T frames, which
    `gl_fgla` launches as given: the products' `product_plan` with `bn` =
    256 where n_fft % 256 == 0, else 128 (every tile whole); the OLA (8
    samples a task, up to 256 threads a row, a multiple of 16), emit (4
    samples a task) and unpack (2 bins a task, up to 512 threads a row)
    launches' `_row_launch`."""
    return {**product_plan(n_fft, M, 256 if n_fft % 256 == 0 else 128),
            "ola": _row_launch(n_fft // 8, 256, M, 16), "emit": _row_launch(-(-hop // 4), 256, M),
            "unpack": _row_launch(n_fft // 4, 512, M)}


def fgla_schedule(n_iters: int, route: str) -> list[str]:
    """The launches of one call of the packed loop, in order: synthesis,
    OLA and analysis an iteration, then a synthesis and the emit ("wave",
    3n + 2) or the unpack ("full", 3n + 1)."""
    tail = ["synth", "emit"] if route == "wave" else ["unpack"]
    return ["synth", "ola", "analysis"] * max(n_iters, 0) + tail


# a product tile of 256 columns against one of 128, time on an SM of its
# own (18.5 against 12.3 us on an H100 at B=1, T=1,760, n_fft 1024;
# wavernn_ab.py --mode gl --bn, PERF.md)
WIDE_TILE_COST = 1.5


def gl_iteration_plan(n_fft: int, hop: int, M: int, sms: int = 132) -> dict:
    """Kernel 4's launch plan for M = B * T frames on `sms` SMs, which
    `gl_plain` launches as given: the products' `product_plan` and the
    OLA's `_row_launch`, as `fgla_plan` has them, except that the products
    take tiles of 128 columns where tiles of 256 would take longer in waves
    of one block an SM (WIDE_TILE_COST waves of 128-column tiles each): a
    few rows leave most SMs idle under 256-column tiles (B=1, T=1,760: 56
    blocks on 132 SMs)."""
    p = fgla_plan(n_fft, hop, M)
    if p["bn"] == 256:
        waves = lambda bn: -(-(n_fft // bn) * p["grid"][1] // sms)  # noqa: E731
        if WIDE_TILE_COST * waves(256) > waves(128):
            p.update(product_plan(n_fft, M, 128))
    return {k: p[k] for k in ("bn", "stages", "smem", "threads", "rows_pad", "grid", "ola")}


def gl_iteration_schedule(n_iters: int) -> list[str]:
    """Kernel 4's launches of one call, in order: synthesis, OLA and
    analysis an iteration (3n; none at n = 0)."""
    return ["synth", "ola", "analysis"] * max(n_iters, 0)


class _Rows(ctypes.Structure):
    """ctypes mirror of csrc/griffin_lim.cu `Rows`."""
    _fields_ = [(n, ctypes.c_int) for n in ("tpr", "rows", "threads", "blocks")]


class _Fgla(ctypes.Structure):
    """ctypes mirror of csrc/griffin_lim.cu `Fgla`."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "M", "M_pad", "T", "N", "hop", "K", "Kf", "n_iters", "wave", "serial", "bn", "grid_x",
        "grid_y", "threads", "smem")]
        + [(n, _Rows) for n in ("ola", "emit", "unpack")]
        + [("mom", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in (
            "P", "pP", "frN", "pN", "xw", "g", "mag", "MwT", "Mf", "nyq", "altw", "wsic", "out",
            "stream")]
        + [("launches", ctypes.c_int)])


class _Gli(ctypes.Structure):
    """ctypes mirror of csrc/griffin_lim.cu `Gli`."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "M", "M_pad", "T", "N", "hop", "K", "Kf", "n_iters", "serial", "bn", "grid_x", "grid_y",
        "threads", "smem")]
        + [("ola", _Rows)]
        + [(n, ctypes.c_void_p) for n in (
            "P", "frN", "xw", "g", "mag", "synT", "anaT", "nyq_syn", "nyq_ana", "win", "wsi", "Fr",
            "Fi", "stream")]
        + [("launches", ctypes.c_int)])


_ARGTYPES = {"gl_fgla": [ctypes.c_void_p], "gl_plain": [ctypes.c_void_p]}


def _lib():
    lib = cuda_build.load("griffin_lim")
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def _check_cuda(mag, consts: dict, what: str):
    if mag.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
    if consts["dtype"] != BF16 or any(v.device != mag.device for v in consts.values()
                                      if isinstance(v, torch.Tensor)):
        raise ValueError(f"{what} takes bf16 constants on the magnitudes' device")
    n_fft, hop = consts["n_fft"], consts["hop"]
    if n_fft % 128 or hop > 1024:
        raise ValueError(f"the Griffin-Lim kernels need n_fft % 128 == 0 and "
                         f"hop <= 1024 (got {n_fft}, {hop})")


def _fgla_cuda(mag, init_phase, consts: dict, n_iters: int, momentum: float, route: str,
               what: str, serial: bool = False):
    """The packed loop and its last launch on the card, one ctypes call:
    (the waveforms [B, hop * (T - 1)] ("wave") or the complex spectrum
    [B, T, Kf] ("full"), the launches `gl_fgla` issued). `serial` issues
    the same launches without the programmatic dependence."""
    n_fft, hop, B, T = _check(mag, consts)
    _check_cuda(mag, consts, what)
    lib, dev = _lib(), mag.device
    M, Kf = B * T, n_fft // 2 + 1
    plan = fgla_plan(n_fft, hop, M)
    m = mag.to(F32).contiguous()
    p0, n0 = pack_init(m, init_phase.to(dev), n_fft)
    P = torch.zeros(plan["rows_pad"], n_fft, device=dev, dtype=BF16)
    P[:M] = p0.reshape(M, n_fft)
    pP = P.clone()
    g = torch.zeros_like(P)
    frN = n0.reshape(M).contiguous()
    pN = frN.clone()
    xw = torch.empty(M, n_fft, device=dev)
    out = (torch.empty(M, hop, device=dev) if route == "wave"
           else torch.empty(M, Kf, device=dev, dtype=torch.complex64))
    c = consts
    f = _Fgla(M=M, M_pad=plan["rows_pad"], T=T, N=n_fft, hop=hop, K=-(-n_fft // hop) - 1, Kf=Kf,
              n_iters=n_iters, wave=route == "wave", serial=serial, bn=plan["bn"],
              grid_x=plan["grid"][0], grid_y=plan["grid"][1], threads=plan["threads"],
              smem=plan["smem"], ola=_Rows(**plan["ola"]), emit=_Rows(**plan["emit"]),
              unpack=_Rows(**plan["unpack"]), mom=float(momentum), P=P.data_ptr(), pP=pP.data_ptr(), frN=frN.data_ptr(),
              pN=pN.data_ptr(), xw=xw.data_ptr(), g=g.data_ptr(), mag=m.data_ptr(),
              MwT=c["MwT"].data_ptr(), Mf=c["Mf"].data_ptr(), nyq=c["nyq"].data_ptr(),
              altw=c["altw"].data_ptr(), wsic=c["wsic"].data_ptr(), out=out.data_ptr())
    with cuda_build.on_device(dev) as stream:
        f.stream = stream
        cuda_build.check(lib.gl_fgla(ctypes.addressof(f)), "gl_fgla")
    if route == "full":
        return out.reshape(mag.shape), f.launches
    corr = _edge_correction(T, n_fft, hop, consts["window"].tobytes(), dev)
    return out.reshape(B, T * hop)[:, hop:] * corr, f.launches


@functools.lru_cache(maxsize=32)
def _edge_correction(T: int, n_fft: int, hop: int, window: bytes, device) -> torch.Tensor:
    """`istft_edge_correction` on `device`, made once per frame count: its
    loop over the frames and the copy to the card stay off the call."""
    win = np.frombuffer(window, np.float32)
    corr = istft_edge_correction(T, n_fft, hop, win, ola_wsum_inv(win, n_fft, hop))
    return torch.from_numpy(corr).to(device)


def griffin_lim_wave_cuda(mag, init_phase, consts: dict, *, n_iters: int,
                          momentum: float = 0.0):
    """The wave route on the CUDA kernels: the FGLA loop, then one more
    synthesis and the waveform columns, in one ctypes call."""
    y, launches = _fgla_cuda(mag, init_phase, consts, n_iters, momentum, "wave",
                             "griffin_lim_wave_cuda")
    griffin_lim_wave_cuda.launches += launches
    return y


griffin_lim_wave_cuda.launches = 0


def griffin_lim_full_cuda(mag, init_phase, consts: dict, *, n_iters: int,
                          momentum: float = 0.0):
    """The full route on the CUDA kernels: the FGLA loop, then one launch
    that unpacks the plane and the Nyquist channel into the complex
    spectrum, in one ctypes call."""
    out, launches = _fgla_cuda(mag, init_phase, consts, n_iters, momentum, "full",
                               "griffin_lim_full_cuda")
    griffin_lim_full_cuda.launches += launches
    return out


griffin_lim_full_cuda.launches = 0


def fgla_serial_cuda(mag, init_phase, consts: dict, *, n_iters: int, momentum: float = 0.0,
                     route: str = "wave"):
    """`griffin_lim_wave_cuda` ("wave") or `griffin_lim_full_cuda` ("full")
    with every launch waiting for the previous one to end: a probe (the
    card tests hold it to the same bits; per-launch device times come from
    it). Not counted as launches."""
    return _fgla_cuda(mag, init_phase, consts, n_iters, momentum, route, "fgla_serial_cuda",
                      serial=True)[0]


def griffin_lim_wave(mag, init_phase, consts: dict, *, n_iters: int,
                     momentum: float = 0.0):
    """Batched FGLA magnitudes [B, T, n_fft/2 + 1] -> waveforms
    [B, hop * (T - 1)] from an injected initial phase ([T, Kf] shared by
    every row, or [B, T, Kf]); `consts` from `packed_constants` on the
    magnitudes' device. CPU tensors run the plain version, CUDA tensors the
    kernel."""
    fn = griffin_lim_wave_plain if mag.device.type == "cpu" else griffin_lim_wave_cuda
    return fn(mag, init_phase, consts, n_iters=n_iters, momentum=momentum)


def griffin_lim_full(mag, init_phase, consts: dict, *, n_iters: int,
                     momentum: float = 0.0):
    """Batched FGLA magnitudes [B, T, n_fft/2 + 1] -> the complex spectrum
    S_mag * unit phase [B, T, n_fft/2 + 1] (complex64) of the last
    projection, for the caller's istft. Arguments as `griffin_lim_wave`."""
    fn = griffin_lim_full_plain if mag.device.type == "cpu" else griffin_lim_full_cuda
    return fn(mag, init_phase, consts, n_iters=n_iters, momentum=momentum)


# --- plain Griffin-Lim on the unpacked layout (the per-iteration route) -------

def _check_unpacked(Fr, Fi, mag, consts: dict):
    n_fft = consts["n_fft"]
    if Fr.shape != mag.shape or Fi.shape != mag.shape or mag.dim() != 3 \
            or mag.shape[-1] != n_fft // 2 + 1:
        raise ValueError(f"spectra {tuple(Fr.shape)}, {tuple(Fi.shape)} and magnitudes "
                         f"{tuple(mag.shape)} must be [B, T, {n_fft // 2 + 1}]")
    return mag.shape


def gl_iteration_plain(Fr, Fi, mag, consts: dict, *, n_iters: int = 1):
    """`n_iters` plain Griffin-Lim iterations in plain PyTorch ops, on any
    device: the reference the kernel is held against. Arguments as
    `gl_iteration`."""
    _check_unpacked(Fr, Fi, mag, consts)
    n_fft, hop, Kp = consts["n_fft"], consts["hop"], consts["Kp"]
    Kf = n_fft // 2 + 1
    rnd = _rounding(consts["dtype"])
    syn, ana = consts["syn"].float(), consts["ana"].float()
    iC, iS = syn[:Kf], -syn[Kp:Kp + Kf]
    C, S = ana[:, :Kf], -ana[:, Kp:Kp + Kf]
    win, wsi = consts["win"], consts["wsi"]
    m = mag.to(F32)
    Fr, Fi = Fr.to(F32), Fi.to(F32)
    for _ in range(n_iters):
        xw = (rnd(Fr) @ iC - rnd(Fi) @ iS) * win
        g = rnd(banded_ola(xw, n_fft, hop) * wsi * win)
        gr, gi = g @ C, -(g @ S)
        inv = torch.rsqrt(torch.clamp(gr * gr + gi * gi, min=1e-30))
        Fr, Fi = m * gr * inv, m * gi * inv
    return Fr, Fi


def _gli_cuda(Fr, Fi, mag, consts: dict, n_iters: int, what: str, serial: bool = False):
    """Kernel 4's loop on the card, one ctypes call: ((Fr', Fi') [B, T, Kf]
    f32, the launches `gl_plain` issued). `serial` issues the same launches
    without the programmatic dependence."""
    B, T, Kf = _check_unpacked(Fr, Fi, mag, consts)
    _check_cuda(mag, consts, what)
    lib, dev = _lib(), mag.device
    n_fft, hop = consts["n_fft"], consts["hop"]
    M = B * T
    plan = gl_iteration_plan(n_fft, hop, M,
                             torch.cuda.get_device_properties(dev).multi_processor_count)
    m = mag.to(F32).reshape(M, Kf).contiguous()
    p0, n0 = pack_spectrum(Fr.to(dev, F32), Fi.to(dev, F32), n_fft)
    # the products read whole row tiles: rows past M are zeros
    P, g = (torch.empty(plan["rows_pad"], n_fft, device=dev, dtype=BF16) for _ in range(2))
    P[:M] = p0.reshape(M, n_fft)
    P[M:] = 0
    g[M:] = 0
    frN = n0.reshape(M).contiguous()
    xw = torch.empty(M, n_fft, device=dev)
    out_r, out_i = torch.empty(M, Kf, device=dev), torch.empty(M, Kf, device=dev)
    c = consts
    f = _Gli(M=M, M_pad=plan["rows_pad"], T=T, N=n_fft, hop=hop, K=-(-n_fft // hop) - 1, Kf=Kf,
             n_iters=n_iters, serial=serial, bn=plan["bn"], grid_x=plan["grid"][0],
             grid_y=plan["grid"][1], threads=plan["threads"], smem=plan["smem"],
             ola=_Rows(**plan["ola"]), P=P.data_ptr(), frN=frN.data_ptr(), xw=xw.data_ptr(),
             g=g.data_ptr(), mag=m.data_ptr(), synT=c["synT"].data_ptr(),
             anaT=c["anaT"].data_ptr(), nyq_syn=c["nyq_syn"].data_ptr(),
             nyq_ana=c["nyq_ana"].data_ptr(), win=c["win"].data_ptr(), wsi=c["wsi"].data_ptr(),
             Fr=out_r.data_ptr(), Fi=out_i.data_ptr())
    with cuda_build.on_device(dev) as stream:
        f.stream = stream
        cuda_build.check(lib.gl_plain(ctypes.addressof(f)), "gl_plain")
    if n_iters == 0:
        return (Fr.to(F32).contiguous(), Fi.to(F32).contiguous()), f.launches
    return (out_r.reshape(B, T, Kf), out_i.reshape(B, T, Kf)), f.launches


def gl_iteration_cuda(Fr, Fi, mag, consts: dict, *, n_iters: int = 1):
    """`n_iters` plain Griffin-Lim iterations on the CUDA kernels in one
    ctypes call: synthesis, OLA and analysis an iteration, issued from C as
    dependent launches on the packed state (plane and Nyquist channel)."""
    out, launches = _gli_cuda(Fr, Fi, mag, consts, n_iters, "gl_iteration_cuda")
    gl_iteration_cuda.launches += launches
    return out


gl_iteration_cuda.launches = 0


def gl_iteration_serial_cuda(Fr, Fi, mag, consts: dict, *, n_iters: int = 1):
    """`gl_iteration_cuda` with every launch waiting for the previous one to
    end: a probe (the card tests hold it to the same bits; per-launch device
    times come from it). Returns ((Fr', Fi'), the launches `gl_plain`
    issued); not counted as launches."""
    return _gli_cuda(Fr, Fi, mag, consts, n_iters, "gl_iteration_serial_cuda", serial=True)


def gl_iteration(Fr, Fi, mag, consts: dict, *, n_iters: int = 1):
    """`n_iters` plain Griffin-Lim iterations (no momentum) on the unpacked
    layout: spectrum (Fr, Fi) and magnitudes [B, T, n_fft/2 + 1] f32, each
    row one utterance -> the re-magnituded projection (Fr', Fi'). `consts`
    from `unpacked_constants` on the magnitudes' device. CPU tensors run the
    plain version, CUDA tensors the kernels."""
    fn = gl_iteration_plain if mag.device.type == "cpu" else gl_iteration_cuda
    return fn(Fr, Fi, mag, consts, n_iters=n_iters)


# --- the router -----------------------------------------------------------------

# Frames of the longest utterance the whole-loop routes take: the
# hardware-validated cap of the JAX package's `capacity.gl_max_tile`, which
# is what it returns on v5e for n_fft <= 2048. Longer batches take the
# per-iteration route, as in the reference.
GL_MAX_TILE = 1024


def gl_route(T: int, n_fft: int, hop: int) -> str:
    """The route `griffin_lim_batch` takes for T frames (the padded frame
    bucket): "wave" (whole loop, istft fused) when the waveform columns sit
    on 128-sample boundaries, "full" (whole loop, then an istft) otherwise,
    "iteration" (plain Griffin-Lim, one launch sequence an iteration) past
    GL_MAX_TILE frames."""
    if T > GL_MAX_TILE:
        return "iteration"
    c0 = n_fft // 2 - hop
    if T >= 2 and c0 >= 0 and c0 % 128 == 0 and hop % 128 == 0:
        return "wave"
    return "full"


def griffin_lim_batch(mag, init_phase, consts: dict, *, n_iters: int,
                      momentum: float = 0.0):
    """Batched Griffin-Lim, the reference's `dsp.griffin_lim_batch` in its
    batch-invariant serving mode: magnitudes [B, T, n_fft/2 + 1] and one
    initial phase [T, n_fft/2 + 1] shared by every row -> waveforms
    [B, hop * (T - 1)]. The route follows `gl_route` for every B, one row
    included, so a row's audio does not depend on its batchmates. The
    per-iteration route runs plain Griffin-Lim: it ignores the momentum, as
    the reference's does. `consts` from `gl_constants`."""
    from .dsp import istft

    p = consts["packed"]
    n_fft, hop = p["n_fft"], p["hop"]
    window = torch.from_numpy(p["window"]).to(mag.device)
    route = gl_route(mag.shape[1], n_fft, hop)
    if route == "wave":
        return griffin_lim_wave(mag, init_phase, p, n_iters=n_iters, momentum=momentum)
    if route == "full":
        F_ = griffin_lim_full(mag, init_phase, p, n_iters=n_iters, momentum=momentum)
        return istft(F_, n_fft, hop, window)
    m = mag.to(F32)
    ph = init_phase.to(m.device, F32).expand(m.shape)
    Fr, Fi = gl_iteration(m * torch.cos(ph), m * torch.sin(ph), m, consts["unpacked"],
                          n_iters=n_iters)
    ang = torch.complex(Fr, Fi) / torch.clamp(m, min=1e-16)
    return istft(m * ang, n_fft, hop, window)
