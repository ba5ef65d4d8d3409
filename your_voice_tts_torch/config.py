"""Typed configuration system (the JAX package's config.py, kept as the
port's own copy so the port never imports the JAX package).

Reference field-name parity:

The reference drives everything from one flat ``config.json`` parsed into an
attribute-dict (``utils/io.py::load_config`` + ``utils/generic_utils.py::
check_config`` upstream; SURVEY.md SS5 "Config / flag system", ~90 fields).
Here the same JSON (including ``//`` comment lines, which the reference's
loader strips) loads into typed, frozen dataclasses; unknown fields warn
instead of failing so reference configs load unchanged.

Groups mirror the reference's field groups: ``audio.*`` nested, everything
else flat at the top level.
"""

from __future__ import annotations

import dataclasses
import json
import re
import warnings
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class AudioConfig:
    """Parity with the reference AudioProcessor kwargs (SURVEY.md SS2.1 AudioProcessor)."""

    sample_rate: int = 22050
    num_mels: int = 80
    fft_size: int = 1024            # upstream also calls this num_freq-era `fft_size`/`n_fft`
    hop_length: int = 256
    win_length: int = 1024
    frame_shift_ms: float | None = None   # alternative spec for hop/win, like upstream
    frame_length_ms: float | None = None
    preemphasis: float = 0.98
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    power: float = 1.5
    # accelerated Griffin-Lim (FGLA, Perraudin 2013): momentum 0.95 at 24
    # iterations measures BETTER spectral convergence than the reference's
    # plain 60 at 40% of the cost (iteration sweep on speech-like signals,
    # |STFT(GL(S))| rel err: plain@60 0.349, FGLA@18 0.346, @22 0.339,
    # @24 ~0.338, @30 0.335 — and 0.134 vs 0.159 on the verify signal at
    # 30); set momentum 0 + iters 60 for the literal reference behavior
    griffin_lim_iters: int = 24
    griffin_lim_momentum: float = 0.95
    signal_norm: bool = True
    symmetric_norm: bool = True
    max_norm: float = 4.0
    clip_norm: bool = True
    mel_fmin: float = 0.0
    mel_fmax: float | None = 8000.0
    spec_gain: float = 20.0          # dB conversion gain; upstream `spec_gain` (20 => 20*log10)
    do_trim_silence: bool = True
    trim_db: float = 60.0
    do_sound_norm: bool = False
    stats_path: str | None = None    # mean/std normalization stats (`scale_stats.npy` upstream)

    @property
    def num_freq(self) -> int:
        return self.fft_size // 2 + 1

    def resolved_hop_win(self) -> tuple[int, int]:
        """hop/win in samples; ms fields take precedence when set (upstream behavior)."""
        hop, win = self.hop_length, self.win_length
        if self.frame_shift_ms is not None:
            hop = int(self.frame_shift_ms / 1000.0 * self.sample_rate)
        if self.frame_length_ms is not None:
            win = int(self.frame_length_ms / 1000.0 * self.sample_rate)
        return hop, win


@dataclass(frozen=True)
class GSTConfig:
    """Global style tokens (reference layers/gst_layers.py; SURVEY.md SS2.1 GST)."""

    gst_embedding_dim: int = 256
    gst_num_heads: int = 4
    gst_style_tokens: int = 10
    gst_use_speaker_embedding: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Tacotron/Tacotron2 architecture knobs (reference config.json model group)."""

    model: str = "Tacotron2"         # "Tacotron" | "Tacotron2"
    r: int = 2                       # reduction factor: decoder emits r frames/step
    memory_size: int = 5             # Tacotron1 decoder memory queue
    tacotron_width: int = 256        # Tacotron1 base width (reference: 256 hard-coded)
    attention_type: str = "original" # "original" (location-sensitive) | "graves"
    attention_heads: int = 4         # graves GMM components
    attention_norm: str = "sigmoid"  # "sigmoid" | "softmax"
    windowing: bool = False          # inference-time attention windowing
    win_back: int = 1                # windowing span behind the attention peak
    win_front: int = 3               # windowing span ahead of the attention peak
    use_forward_attn: bool = False
    forward_attn_mask: bool = False
    transition_agent: bool = False
    location_attn: bool = True
    prenet_type: str = "original"    # "original" | "bn"
    prenet_dropout: bool = True
    stopnet: bool = True
    separate_stopnet: bool = True
    bidirectional_decoder: bool = False
    # dims (upstream hard-codes these inside layers; exposed here as config)
    embedding_dim: int = 512
    encoder_dim: int = 512           # taco2 conv/BiLSTM width
    decoder_rnn_dim: int = 1024
    attention_rnn_dim: int = 1024
    attention_dim: int = 128
    attention_location_filters: int = 32
    attention_location_kernel_size: int = 31
    prenet_dim: int = 256
    postnet_dim: int = 512
    max_decoder_steps: int = 500
    stop_threshold: float = 0.6      # sigmoid(stop) > thresh ends inference
    # ParallelTTS (non-autoregressive family, models/parallel_tts.py)
    parallel_decoder_blocks: int = 6
    duration_predictor_dim: int = 256
    # FastSpeech2-style energy variance adaptor (round-5): predicts a
    # per-frame energy track, teacher-forced in training, model-predicted
    # (and user-scalable via inference energy_scale) at synthesis
    parallel_energy_predictor: bool = False
    # text encoder for the parallel family: "shared" = the Tacotron2
    # conv+BiLSTM (default, checkpoint-compatible with round-4 assets);
    # "conv" = residual dilated ConvLN stack with NO scan anywhere in the
    # model — the BiLSTM's 2*T_text serial chain is the family's remaining
    # MFU bound (round-5 roofline, STATUS.md)
    parallel_encoder: str = "shared"
    # serving fast path: "bfloat16" runs inference matmuls at MXU-native
    # precision (alignments/outputs stay f32; see models/tacotron2.py).
    # Training precision is unaffected.
    inference_compute_dtype: str = "float32"  # "float32" | "bfloat16"


@dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 32
    eval_batch_size: int = 16
    epochs: int = 1000
    lr: float = 1e-4
    wd: float = 1e-6
    warmup_steps: int = 4000
    noam_schedule: bool = True
    grad_clip: float = 1.0
    gradual_training: list[list[int]] | None = None  # [[step, r, batch_size], ...]
    loss_masking: bool = True
    seq_len_norm: bool = False
    ga_alpha: float = 10.0            # guided-attention loss weight
    ga_sigma: float = 0.4
    ga_decay_steps: int = 10000       # steps over which ga weight decays
    stopnet_pos_weight: float = 10.0
    decoder_loss_alpha: float = 0.25
    postnet_loss_alpha: float = 0.25
    run_eval: bool = True
    test_delay_epochs: int = 0
    mixed_precision: bool = True      # bfloat16 matmuls on TPU
    # high-batch training (round-4): batch_size is the OPTIMIZER batch; when
    # grad_accum_steps > 1 each step runs that many sequential micro-batches
    # of batch_size // grad_accum_steps rows and applies ONE averaged
    # update — the memory fallback for B=256/512 configs on smaller chips.
    # Identical numerics to the monolithic batch up to loss-mean
    # re-weighting across micro-batches of equal size.
    grad_accum_steps: int = 1


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "ljspeech"
    path: str = ""
    meta_file_train: str | None = None
    meta_file_val: str | None = None


@dataclass(frozen=True)
class DataConfig:
    datasets: tuple[DatasetConfig, ...] = ()
    min_seq_len: int = 6
    max_seq_len: int = 150
    num_loader_workers: int = 4
    num_val_loader_workers: int = 4
    batch_group_size: int = 0
    # Token-based batching (round-4): when set, training batches are formed
    # so that B_shape * T_mel_bucket <= tokens_per_batch, with B quantized
    # to multiples of 8 (bounded compile count, device-divisible shapes)
    # and capped at training.batch_size rows. Short buckets get MORE rows —
    # near-constant step cost and memory, far less pad waste than fixed-B
    # on length-skewed corpora. None = reference fixed-B batching.
    tokens_per_batch: int | None = None
    use_phonemes: bool = False
    phoneme_language: str = "en-us"
    # pin the G2P backend class name ("EspeakBackend"/"CMUDictBackend"/
    # "RuleG2PBackend"); None = auto (espeak -> cmudict -> rule). Set from
    # checkpoint meta at load time so a host with different tooling cannot
    # silently swap the phoneme stream under a trained model.
    g2p_backend: str | None = None
    phoneme_cache_path: str | None = None
    # offline dictionary G2P (no espeak). None -> the bundled
    # assets/cmudict_core.txt lexicon (text.bundled_cmudict_path)
    cmudict_path: str | None = None
    enable_eos_bos_chars: bool = False
    text_cleaner: str = "english_cleaners"
    compute_input_seq_cache: bool = False
    # TPU-native addition: static-shape length buckets (text_len, mel_len) pairs.
    # None -> derived automatically from min/max_seq_len.
    length_buckets: tuple[tuple[int, int], ...] | None = None


@dataclass(frozen=True)
class SpeakerConfig:
    use_speaker_embedding: bool = False
    num_speakers: int = 0
    speaker_embedding_dim: int = 256
    use_external_speaker_embedding_file: bool = False
    external_speaker_embedding_file: str | None = None
    use_gst: bool = False
    gst: GSTConfig = field(default_factory=GSTConfig)


@dataclass(frozen=True)
class IOConfig:
    output_path: str = "runs"
    run_name: str = "run"
    run_description: str = ""
    print_step: int = 25
    tb_plot_step: int = 100
    save_step: int = 10000
    checkpoint: bool = True
    keep_all_best: bool = False
    tb_model_param_stats: bool = False
    test_sentences_file: str | None = None


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    data: DataConfig = field(default_factory=DataConfig)
    speakers: SpeakerConfig = field(default_factory=SpeakerConfig)
    io: IOConfig = field(default_factory=IOConfig)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


# Map of flat reference-style top-level keys -> (group, field) for load parity.
_FLAT_KEY_MAP: dict[str, tuple[str, str]] = {}
for _group, _cls in (
    ("model", ModelConfig),
    ("training", TrainingConfig),
    ("data", DataConfig),
    ("speakers", SpeakerConfig),
    ("io", IOConfig),
):
    for _f in dataclasses.fields(_cls):
        _FLAT_KEY_MAP.setdefault(_f.name, (_group, _f.name))


def _strip_json_comments(text: str) -> str:
    """The reference's load_config tolerates // comments inside config.json."""
    return re.sub(r"(?m)^\s*//.*$|(?<=[,{\[\s])//[^\n\"]*$", "", text)


def _build(cls: type, d: dict[str, Any], ctx: str) -> Any:
    names = {f.name for f in dataclasses.fields(cls)}
    kept = {}
    for k, v in d.items():
        if k in names:
            kept[k] = v
        else:
            warnings.warn(f"config: unknown field {ctx}.{k} ignored", stacklevel=3)
    return cls(**kept)


def config_from_dict(raw: dict[str, Any]) -> Config:
    """Build a Config from a (possibly flat, reference-style) dict."""
    groups: dict[str, dict[str, Any]] = {
        "audio": dict(raw.get("audio", {})),
        "model": {},
        "training": {},
        "data": {},
        "speakers": {},
        "io": {},
    }
    # Nested group dicts win; flat keys are routed via the parity map.
    for gname in ("model", "training", "data", "speakers", "io"):
        if isinstance(raw.get(gname), dict):
            groups[gname].update(raw[gname])
    for k, v in raw.items():
        if k in ("audio", "model", "training", "data", "speakers", "io"):
            if isinstance(v, dict):
                continue
        if k in _FLAT_KEY_MAP:
            g, f = _FLAT_KEY_MAP[k]
            groups[g].setdefault(f, v)
        elif k not in ("audio",):
            warnings.warn(f"config: unknown top-level field {k!r} ignored", stacklevel=2)

    if "gst" in groups["speakers"] and isinstance(groups["speakers"]["gst"], dict):
        groups["speakers"]["gst"] = _build(GSTConfig, groups["speakers"]["gst"], "gst")
    ds = groups["data"].get("datasets")
    if ds is not None:
        groups["data"]["datasets"] = tuple(
            _build(DatasetConfig, d, "datasets[]") if isinstance(d, dict) else d for d in ds
        )
    gt = groups["training"].get("gradual_training")
    if gt is not None:
        groups["training"]["gradual_training"] = [list(map(int, row)) for row in gt]
    lb = groups["data"].get("length_buckets")
    if lb is not None:
        groups["data"]["length_buckets"] = tuple(tuple(map(int, b)) for b in lb)

    return Config(
        audio=_build(AudioConfig, groups["audio"], "audio"),
        model=_build(ModelConfig, groups["model"], "model"),
        training=_build(TrainingConfig, groups["training"], "training"),
        data=_build(DataConfig, groups["data"], "data"),
        speakers=_build(SpeakerConfig, groups["speakers"], "speakers"),
        io=_build(IOConfig, groups["io"], "io"),
    )


def load_config(path: str) -> Config:
    """Parity with reference ``utils/io.py::load_config`` (JSON + // comments)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return config_from_dict(json.loads(_strip_json_comments(text)))


def save_config(cfg: Config, path: str) -> None:
    """`cfg` as indented JSON (its dataclasses as dicts, anything else as
    str), the JAX package's `save_config`."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def check_config(cfg: Config) -> None:
    """Reject settings the model or the audio front end cannot run (the
    JAX package's `check_config`, parity with the reference's
    utils/generic_utils.py::check_config). Raises ValueError."""
    a = cfg.audio
    if a.num_mels <= 0 or a.fft_size <= 0 or a.sample_rate <= 0:
        raise ValueError("audio: num_mels/fft_size/sample_rate must be positive")
    hop, win = a.resolved_hop_win()
    if not (0 < hop <= win <= a.fft_size):
        raise ValueError(f"audio: need 0 < hop({hop}) <= win({win}) <= fft_size({a.fft_size})")
    if a.mel_fmax is not None and a.mel_fmax > a.sample_rate / 2:
        raise ValueError("audio: mel_fmax beyond Nyquist")
    m = cfg.model
    if m.model not in ("Tacotron", "Tacotron2"):
        raise ValueError(f"model: unknown model {m.model!r}")
    if m.r < 1:
        raise ValueError("model: r must be >= 1")
    if m.attention_type not in ("original", "graves"):
        raise ValueError(f"model: unknown attention_type {m.attention_type!r}")
    if m.prenet_type not in ("original", "bn"):
        raise ValueError(f"model: unknown prenet_type {m.prenet_type!r}")
    if m.attention_norm not in ("sigmoid", "softmax"):
        raise ValueError(f"model: unknown attention_norm {m.attention_norm!r}")
    if m.inference_compute_dtype not in ("float32", "bfloat16"):
        raise ValueError("model: inference_compute_dtype must be "
                         f"float32|bfloat16, got {m.inference_compute_dtype!r}")
    for row in cfg.training.gradual_training or ():
        if len(row) != 3:
            raise ValueError("training: gradual_training rows are [step, r, batch_size]")
