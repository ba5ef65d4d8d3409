"""Griffin-Lim with the final inverse STFT: the CUDA kernel
(csrc/griffin_lim.cu), its plain PyTorch version, and their host helpers.

Counterpart of the JAX package's ops/pallas/griffin_lim.py
`griffin_lim_pallas_wave` with an injected initial phase (the serving
path's batch-invariant shared phase). Magnitudes [B, T, n_fft/2 + 1] ->
waveforms [B, hop * (T - 1)].

The loop runs on the PACKED layout of the JAX kernel: the complex
spectrogram's first n_fft/2 bins as one [T, n_fft] real plane (real parts,
then imaginary parts) plus the real Nyquist bin as one column; window, OLA
normalization and DFT scales are folded into two [n_fft, n_fft] matrices
Mw (synthesis) and Mf (analysis), so one FGLA iteration is two square
matrix products around a banded overlap-add inside each utterance. The
loop state is rounded to `dtype` (bf16 by default, like the TPU kernel);
magnitudes, the Nyquist channel and accumulation stay f32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

F32 = torch.float32
BF16 = torch.bfloat16


def inverse_dft_matrices(n_fft: int):
    """Real inverse-DFT matrices (iC [K, N], iS [K, N]) with
    irfft(Fr, Fi) = Fr@iC - Fi@iS (numpy f32; the JAX package's
    ops/dsp.py `_dft_matrices`, inverse half)."""
    K = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(K)[:, None] * np.arange(n_fft)[None, :] / n_fft
    w = np.full((K, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    return ((w * np.cos(ang)) / n_fft).astype(np.float32), \
        ((w * np.sin(ang)) / n_fft).astype(np.float32)


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
    synthesis matrix Mw [N, N] and analysis matrix Mf (stored transposed,
    MfT [N, N], so G = g @ MfT), plus the Nyquist analysis row `nyq`, its
    synthesis column `altw` and the emitted columns' normalization `wsic`."""
    if n_fft % 2:
        raise ValueError("the packed Griffin-Lim loop needs an even n_fft")
    half = n_fft // 2
    iC, iS = inverse_dft_matrices(n_fft)
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
    return {
        "n_fft": n_fft, "hop": hop, "dtype": dtype, "window": win, "wsi": wsi,
        "Mw": t(M * win[None, :], dtype),
        "MfT": t((M * wsiwin[None, :] * sc2[:, None]).T, dtype),
        "nyq": t(wsiwin * alt), "altw": t(win * alt / n_fft),
        "wsic": t(wsi[c0:c0 + hop]),
    }


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


def griffin_lim_wave_plain(mag, init_phase, consts: dict, *, n_iters: int,
                           momentum: float = 0.0):
    """The loop in plain PyTorch ops, on any device: the reference the
    kernel is held against. Arguments as `griffin_lim_wave`."""
    n_fft, hop, B, T = _check(mag, consts)
    half, c0 = n_fft // 2, n_fft // 2 - hop
    rnd = (lambda x: x.to(BF16).float()) if consts["dtype"] == BF16 else (lambda x: x)
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
    acc = banded_ola(P @ Mw + frN[..., None] * altw, n_fft, hop)
    y = (acc[..., c0:c0 + hop] * consts["wsic"]).reshape(B, T * hop)[:, hop:]
    corr = istft_edge_correction(T, n_fft, hop, consts["window"], consts["wsi"])
    return y * torch.from_numpy(corr).to(y.device)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "gl_synth": [_P, _P, _P, _P, _P, _I, _I, _P],
    "gl_analysis": [_P, _P, _P, _I, _P, _P, _I, _I, _F, _P],
    "gl_ola": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "gl_emit": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _lib():
    lib = cuda_build.load("griffin_lim")
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def griffin_lim_wave_cuda(mag, init_phase, consts: dict, *, n_iters: int,
                          momentum: float = 0.0):
    """The loop on the CUDA kernels: per iteration a synthesis product, the
    banded OLA and an analysis product with the FGLA update fused; then one
    more synthesis and the waveform columns."""
    n_fft, hop, B, T = _check(mag, consts)
    if mag.device.type != "cuda":
        raise ValueError("griffin_lim_wave_cuda takes CUDA tensors")
    if consts["dtype"] != BF16 or consts["Mw"].device != mag.device:
        raise ValueError("the Griffin-Lim kernel takes bf16 constants on the "
                         "magnitudes' device")
    if n_fft % 128 or hop > 1024:
        raise ValueError(f"the Griffin-Lim kernel needs n_fft % 128 == 0 and "
                         f"hop <= 1024 (got {n_fft}, {hop})")
    lib = _lib()
    dev = mag.device
    M, N, Kf = B * T, n_fft, n_fft // 2 + 1
    K, c0 = -(-n_fft // hop) - 1, n_fft // 2 - hop
    m = mag.to(F32).contiguous()
    p0, n0 = pack_init(m, init_phase.to(dev), n_fft)
    P = p0.reshape(M, N).to(BF16).contiguous()
    pP = P.clone()
    frN = n0.reshape(M).contiguous()
    pN = frN.clone()
    xw = torch.empty(M, N, device=dev)
    g = torch.empty(M, N, device=dev, dtype=BF16)
    y = torch.empty(M, hop, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    Mw, MfT = consts["Mw"].data_ptr(), consts["MfT"].data_ptr()
    altw, nyq = consts["altw"].data_ptr(), consts["nyq"].data_ptr()
    mom = float(momentum)

    def synth():
        cuda_build.check(lib.gl_synth(P.data_ptr(), Mw, frN.data_ptr(), altw,
                                      xw.data_ptr(), M, N, stream), "gl_synth")

    for _ in range(n_iters):
        synth()
        cuda_build.check(lib.gl_ola(xw.data_ptr(), nyq, m.data_ptr(), Kf,
                                    g.data_ptr(), frN.data_ptr(), pN.data_ptr(),
                                    M, T, N, hop, K, mom, stream), "gl_ola")
        cuda_build.check(lib.gl_analysis(g.data_ptr(), MfT, m.data_ptr(), Kf,
                                         P.data_ptr(), pP.data_ptr(), M, N, mom,
                                         stream), "gl_analysis")
    synth()
    cuda_build.check(lib.gl_emit(xw.data_ptr(), consts["wsic"].data_ptr(),
                                 y.data_ptr(), M, T, N, hop, K, c0, stream), "gl_emit")
    griffin_lim_wave_cuda.launches += 3 * n_iters + 2
    corr = istft_edge_correction(T, n_fft, hop, consts["window"], consts["wsi"])
    return y.reshape(B, T * hop)[:, hop:] * torch.from_numpy(corr).to(dev)


griffin_lim_wave_cuda.launches = 0


def griffin_lim_wave(mag, init_phase, consts: dict, *, n_iters: int,
                     momentum: float = 0.0):
    """Batched FGLA magnitudes [B, T, n_fft/2 + 1] -> waveforms
    [B, hop * (T - 1)] from an injected initial phase ([T, Kf] shared by
    every row, or [B, T, Kf]); `consts` from `packed_constants` on the
    magnitudes' device. CPU tensors run the plain version, CUDA tensors the
    kernel."""
    fn = griffin_lim_wave_plain if mag.device.type == "cpu" else griffin_lim_wave_cuda
    return fn(mag, init_phase, consts, n_iters=n_iters, momentum=momentum)
