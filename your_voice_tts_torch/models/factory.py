"""Model factory (the JAX package's models/factory.py): Tacotron2,
Tacotron(1) and ParallelTTS, each conditioned on speakers and on Global
Style Tokens where asked."""

from __future__ import annotations

from ..config import Config


def setup_model(num_chars: int, cfg: Config, device=None, seed: int = 0,
                num_speakers: int = 0, speaker_embedding_dim: int = 0):
    """Build the model named by cfg.model.model on `device` (CUDA unless
    given) with seeded random weights. r_init is the largest r of the
    gradual-training schedule, so the projection and stopnet keep their
    shape across it. num_speakers > 0 conditions the model on speakers:
    d-vectors of width speaker_embedding_dim, or with 0 its own table.
    cfg.speakers.use_gst adds Global Style Tokens (cfg.speakers.gst). A
    ParallelTTS takes the reference's arguments: num_speakers > 1 without
    a speaker_embedding_dim gives it a speaker table, and it keeps r = 1."""
    if cfg.model.model == "ParallelTTS":
        from .parallel_tts import ParallelTTS

        return ParallelTTS(num_chars, cfg.model, n_mels=cfg.audio.num_mels,
                           num_speakers=num_speakers,
                           speaker_embedding_dim=speaker_embedding_dim,
                           use_gst=cfg.speakers.use_gst, gst_cfg=cfg.speakers.gst,
                           device=device, seed=seed)
    if cfg.model.model not in ("Tacotron2", "Tacotron"):
        raise ValueError(f"unknown model {cfg.model.model!r}")
    r_init = cfg.model.r
    if cfg.training.gradual_training:
        r_init = max(r_init, max(row[1] for row in cfg.training.gradual_training))
    kw = dict(n_mels=cfg.audio.num_mels, r_init=r_init, device=device, seed=seed,
              num_speakers=num_speakers, speaker_embedding_dim=speaker_embedding_dim,
              use_gst=cfg.speakers.use_gst, gst_cfg=cfg.speakers.gst)
    if cfg.model.model == "Tacotron":
        from .tacotron import Tacotron

        return Tacotron(num_chars, cfg.model, num_freq=cfg.audio.num_freq, **kw)
    from .tacotron2 import Tacotron2

    return Tacotron2(num_chars, cfg.model, **kw)
