"""GE2E loss (Wan et al. 2018; the JAX package's speaker_encoder/losses.py).

Embeddings come grouped [N speakers, M utterances, D]. An utterance's
similarity to its own speaker's centroid uses the centroid of the other
M - 1 utterances (leave-one-out); the softmax variant contrasts it with
every other speaker's full centroid."""

from __future__ import annotations

import torch


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)


def ge2e_similarity(embeddings, w, b):
    """[N, M, D] -> the scaled cosine similarity matrix [N, M, N],
    w * cos + b."""
    N, M, _ = embeddings.shape
    sums = embeddings.sum(1, keepdim=True)                           # [N, 1, D]
    e = _unit(embeddings)
    c = _unit(embeddings.mean(1))                                    # [N, D]
    loo = _unit((sums - embeddings) / max(M - 1, 1))                 # [N, M, D]
    sim = torch.einsum("nmd,kd->nmk", e, c)
    own = (e * loo).sum(-1)                                          # [N, M]
    eye = torch.eye(N, dtype=sim.dtype, device=sim.device)[:, None, :]
    sim = sim * (1 - eye) + own[..., None] * eye
    return w * sim + b


def ge2e_loss(embeddings, w, b):
    """Softmax GE2E: the mean over utterances of -log softmax over the
    centroids of the own speaker's entry."""
    N, M, _ = embeddings.shape
    logp = torch.log_softmax(ge2e_similarity(embeddings, w, b), dim=-1)
    idx = torch.arange(N, device=logp.device)
    return -logp[idx, :, idx].mean()


def init_ge2e_params(device=None) -> dict:
    """The learnable (w, b), (10, -5) as in the paper and the reference."""
    return {"w": torch.tensor(10.0, device=device), "b": torch.tensor(-5.0, device=device)}
