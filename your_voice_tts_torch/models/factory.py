"""Model factory (the JAX package's models/factory.py): Tacotron2 and
Tacotron(1)."""

from __future__ import annotations

from ..config import Config


def setup_model(num_chars: int, cfg: Config, device=None, seed: int = 0):
    """Build the model named by cfg.model.model on `device` (CUDA unless
    given) with seeded random weights. r_init is the largest r of the
    gradual-training schedule, so the projection and stopnet keep their
    shape across it."""
    if cfg.model.model not in ("Tacotron2", "Tacotron"):
        raise NotImplementedError(
            f"model {cfg.model.model!r} arrives with a later slice of the port")
    if cfg.speakers.use_speaker_embedding or cfg.speakers.use_gst:
        raise NotImplementedError(
            "speaker and style conditioning arrive with a later slice of the port")
    r_init = cfg.model.r
    if cfg.training.gradual_training:
        r_init = max(r_init, max(row[1] for row in cfg.training.gradual_training))
    if cfg.model.model == "Tacotron":
        from .tacotron import Tacotron

        return Tacotron(num_chars, cfg.model, n_mels=cfg.audio.num_mels,
                        num_freq=cfg.audio.num_freq, r_init=r_init, device=device, seed=seed)
    from .tacotron2 import Tacotron2

    return Tacotron2(num_chars, cfg.model, n_mels=cfg.audio.num_mels,
                     r_init=r_init, device=device, seed=seed)
