"""Objective speech-quality metrics (a copy of the JAX package's
utils/quality.py, numpy only):

- `mel_cepstral_distortion`: MCD (dB) between a free-running mel and the
  ground-truth mel, DTW-aligned (the lengths differ), on mel cepstra from a
  DCT-II of the denormalized dB mel (Kubichek's formulation, c1..cK,
  10 / ln 10 * sqrt(2 sum dc^2));
- `stop_token_scores` and `prf`: precision / recall / F1 of the stop
  token's first firing against the target length;
- `speaker_similarity`: the cosine between a cloned utterance's
  re-embedded d-vector and the target speaker's.

They run on the host, on numpy arrays.
"""

from __future__ import annotations

import numpy as np

_LN10 = float(np.log(10.0))
MCD_CONST = 10.0 / _LN10 * float(np.sqrt(2.0))


def denormalize_mel(mel_norm: np.ndarray, cfg, stats=None) -> np.ndarray:
    """Invert the normalization back to dB (mirror of
    ops/dsp.denormalize_spec for host numpy; cfg: AudioConfig).

    stats: (mean, std) per-bin arrays when the model was trained with
    cfg.stats_path mean/std scaling — without them a z-scored mel would be
    run through the range-norm inverse and every dB is garbage."""
    S = np.asarray(mel_norm, np.float64)
    if not cfg.signal_norm:
        return S
    if stats is not None:
        mean, std = (np.asarray(a, np.float64) for a in stats)
        return S * std + mean + cfg.ref_level_db
    if cfg.symmetric_norm:
        if cfg.clip_norm:
            S = np.clip(S, -cfg.max_norm, cfg.max_norm)
        S = (S + cfg.max_norm) / (2.0 * cfg.max_norm)
    else:
        if cfg.clip_norm:
            S = np.clip(S, 0.0, cfg.max_norm)
        S = S / cfg.max_norm
    return S * (-cfg.min_level_db) + cfg.min_level_db + cfg.ref_level_db


def _dct2(x: np.ndarray, n_coef: int) -> np.ndarray:
    """Orthonormal DCT-II over the last axis, first n_coef coefficients."""
    M = x.shape[-1]
    k = np.arange(n_coef)[:, None]
    n = np.arange(M)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * M))  # [n_coef, M]
    scale = np.full((n_coef, 1), np.sqrt(2.0 / M))
    scale[0] = np.sqrt(1.0 / M)
    return x @ (basis * scale).T


def _dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Classic DTW over a [T1, T2] frame-distance matrix; returns the
    aligned index pair arrays. O(T1*T2) host work — fine for eval clips."""
    T1, T2 = cost.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, T1 + 1):
        row_prev = acc[i - 1]
        row = acc[i]
        crow = cost[i - 1]
        for j in range(1, T2 + 1):
            row[j] = crow[j - 1] + min(row_prev[j - 1], row_prev[j],
                                       row[j - 1])
    i, j = T1, T2
    pi, pj = [], []
    while i > 0 and j > 0:
        pi.append(i - 1)
        pj.append(j - 1)
        moves = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        m = int(np.argmin(moves))
        if m == 0:
            i, j = i - 1, j - 1
        elif m == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(pi[::-1]), np.asarray(pj[::-1])


def mel_cepstral_distortion(mel_pred: np.ndarray, mel_ref: np.ndarray,
                            cfg=None, n_coef: int = 13,
                            use_dtw: bool = True, stats=None) -> float:
    """MCD (dB) between two [T, n_mels] mels (normalized if cfg given —
    they are denormalized to dB first; pass `stats` (mean, std) for
    models trained with cfg.stats_path scaling). Coefficient 0 (energy)
    excluded."""
    if cfg is not None:
        mel_pred = denormalize_mel(mel_pred, cfg, stats=stats)
        mel_ref = denormalize_mel(mel_ref, cfg, stats=stats)
    # dB -> ln-amplitude cepstra (MCD convention): c = DCT(ln |S|)
    c_pred = _dct2(np.asarray(mel_pred, np.float64) * _LN10 / 20.0, n_coef)
    c_ref = _dct2(np.asarray(mel_ref, np.float64) * _LN10 / 20.0, n_coef)
    c_pred, c_ref = c_pred[:, 1:], c_ref[:, 1:]  # drop energy
    if use_dtw:
        d = ((c_pred[:, None, :] - c_ref[None, :, :]) ** 2).sum(-1) ** 0.5
        pi, pj = _dtw_path(d)
        diff = c_pred[pi] - c_ref[pj]
    else:
        T = min(c_pred.shape[0], c_ref.shape[0])
        diff = c_pred[:T] - c_ref[:T]
    frame_mcd = MCD_CONST * np.sqrt((diff ** 2).sum(axis=-1))
    return float(frame_mcd.mean())


def stop_token_scores(stop_probs: np.ndarray, target_length: int,
                      thresh: float = 0.6, tol: int = 2) -> dict:
    """Per-utterance stop-token timing scores.

    stop_probs: [T_steps] free-run stop probabilities (r-group steps);
    target_length: ground-truth length in the SAME units. An utterance's
    stop is a true positive when the first firing lands within `tol` steps
    of the target end; firing early counts as a false positive, never
    firing (within the decoded budget) as a false negative."""
    fired = np.nonzero(np.asarray(stop_probs) > thresh)[0]
    if len(fired) == 0:
        return {"tp": 0, "fp": 0, "fn": 1}
    first = int(fired[0])
    if abs(first - (target_length - 1)) <= tol:
        return {"tp": 1, "fp": 0, "fn": 0}
    if first < target_length - 1 - tol:
        return {"tp": 0, "fp": 1, "fn": 0}
    return {"tp": 0, "fp": 0, "fn": 1}  # fired late = missed the end


def prf(counts: list[dict]) -> dict:
    """Aggregate {tp, fp, fn} counts -> precision/recall/F1."""
    tp = sum(c["tp"] for c in counts)
    fp = sum(c["fp"] for c in counts)
    fn = sum(c["fn"] for c in counts)
    p = tp / max(tp + fp, 1)
    r = tp / max(tp + fn, 1)
    f1 = 2 * p * r / max(p + r, 1e-9)
    return {"precision": round(p, 4), "recall": round(r, 4),
            "f1": round(f1, 4)}


def speaker_similarity(embed_a: np.ndarray, embed_b: np.ndarray) -> float:
    """Cosine similarity between two (already L2-normalized or not)
    d-vectors."""
    a = np.asarray(embed_a, np.float64).ravel()
    b = np.asarray(embed_b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))
