"""Diagnostic plots (the JAX package's utils/visual.py): the alignment
heatmap and the spectrogram the trainer logs for its test sentences.
matplotlib is optional: it is imported, with the Agg backend, when a plot
is drawn, so the package imports without it."""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_alignment(alignment, title: str | None = None):
    """alignment [T_dec, T_in] -> a figure, decoder steps on x."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(np.asarray(alignment).T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep")
    ax.set_ylabel("Encoder timestep")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_spectrogram(spectrogram, title: str | None = None, time_major: bool | None = None):
    """spectrogram [T, F] or [F, T] -> a figure, time on x. time_major:
    True for [T, F], False for [F, T]; without it the longer axis is taken
    for time, which misreads clips with fewer frames than channels."""
    plt = _pyplot()
    s = np.asarray(spectrogram)
    transpose = (not time_major) if time_major is not None else s.shape[0] < s.shape[1]
    if transpose:
        s = s.T
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(s.T, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Frames")
    ax.set_ylabel("Channels")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return fig
