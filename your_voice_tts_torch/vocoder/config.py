"""Vocoder configs (the JAX package's vocoder/config.py, copied whole).

The discriminator and training fields load so that every vocoder JSON of
the JAX package loads; the port serves the generators only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..config import AudioConfig, _build, _strip_json_comments


@dataclass(frozen=True)
class MelganConfig:
    upsample_factors: tuple[int, ...] = (8, 8, 2, 2)   # product == hop_length
    num_res_blocks: int = 3
    base_channels: int = 512
    kernel_size: int = 7
    num_scales: int = 3                                 # discriminator scales
    disc_base_channels: int = 16


@dataclass(frozen=True)
class PWGANConfig:
    upsample_factors: tuple[int, ...] = (4, 4, 4, 4)   # product == hop_length
    num_layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    kernel_size: int = 3
    aux_context_window: int = 0   # reference conv_in context frames/side
    disc_layers: int = 10
    disc_channels: int = 64


@dataclass(frozen=True)
class WaveRNNConfig:
    mode: str = "mulaw"          # "mulaw" (categorical) | "mol" | "gauss"
    bits: int = 10               # mu-law quantization bits
    num_mixtures: int = 10       # MoL components (mode == "mol")
    rnn_dims: int = 512
    fc_dims: int = 512
    compute_dims: int = 128
    res_out_dims: int = 128
    num_res_blocks: int = 10
    pad: int = 2                 # conditioning context frames each side
    upsample_factors: tuple[int, ...] = (4, 8, 8)  # product == hop_length
    # batched folding (reference "batched sequence folding"): one utterance
    # is cut into overlapping folds of `target` samples plus `overlap` on
    # each side, decoded as the rows of one batch and crossfaded back. The
    # defaults are the JAX package's; the port has not swept them.
    batched: bool = True
    target: int = 5_500          # samples decoded per fold
    overlap: int = 550           # crossfade overlap between folds


@dataclass(frozen=True)
class VocoderTrainingConfig:
    batch_size: int = 32
    seq_len: int = 8192          # audio samples per training segment
    epochs: int = 10_000
    lr_gen: float = 1e-4
    lr_disc: float = 1e-4
    grad_clip: float = 10.0
    steps_to_start_discriminator: int = 200_000
    use_stft_loss: bool = True
    use_feat_match_loss: bool = True
    stft_loss_weight: float = 0.5
    feat_match_loss_weight: float = 2.5
    print_step: int = 25
    save_step: int = 10_000
    mixed_precision: bool = True
    gan_mixed_precision: bool = False


@dataclass(frozen=True)
class VocoderConfig:
    model: str = "melgan"        # "melgan" | "pwgan" | "wavernn"
    audio: AudioConfig = field(default_factory=AudioConfig)
    melgan: MelganConfig = field(default_factory=MelganConfig)
    pwgan: PWGANConfig = field(default_factory=PWGANConfig)
    wavernn: WaveRNNConfig = field(default_factory=WaveRNNConfig)
    training: VocoderTrainingConfig = field(default_factory=VocoderTrainingConfig)


def load_vocoder_config(path_or_cfg) -> VocoderConfig:
    if isinstance(path_or_cfg, VocoderConfig):
        return path_or_cfg
    with open(path_or_cfg, encoding="utf-8") as f:
        raw = json.loads(_strip_json_comments(f.read()))
    groups = {}
    groups["audio"] = _build(AudioConfig, raw.get("audio", {}), "audio")
    groups["melgan"] = _build(MelganConfig, raw.get("melgan", {}), "melgan")
    groups["pwgan"] = _build(PWGANConfig, raw.get("pwgan", {}), "pwgan")
    groups["wavernn"] = _build(WaveRNNConfig, raw.get("wavernn", {}), "wavernn")
    groups["training"] = _build(VocoderTrainingConfig, raw.get("training", {}), "training")
    return VocoderConfig(model=raw.get("model", "melgan"), **groups)
