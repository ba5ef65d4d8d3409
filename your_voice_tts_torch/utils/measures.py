"""Alignment measure the trainer's evaluation reports (the JAX package's
utils/measures.py)."""

from __future__ import annotations

import numpy as np


def alignment_diagonal_score(alignments: np.ndarray, binary: bool = False) -> float:
    """Mean over decoder steps of the step's largest attention weight: how
    confident (diagonal) the alignment is. alignments [B, T_dec, T_in] or
    [T_dec, T_in]."""
    a = np.asarray(alignments)
    if a.ndim == 2:
        a = a[None]
    m = a.max(axis=-1)
    if binary:
        m = (m > 0.5).astype(np.float64)
    return float(m.mean())
