"""The port's small public helpers against the JAX package's on the CPU:
`AudioProcessor.inv_melspectrogram`, `inv_spectrogram` and
`out_linear_to_mel`, `config.save_config`,
`ConsoleLogger.print_train_start`; and `Trainer.capture_trace`, which
writes a torch.profiler trace (the JAX one a jax.profiler trace) and
returns the traced call's value.

Griffin-Lim: the JAX single-clip route (its float32 XLA loop) with the
port's shared phase injected; the port's loop keeps the kernel route's
bf16 state, so the wave at 5e-2 of its peak (tests/test_torch_gl_routes.py
holds the batched route, bf16 on both sides, at 2e-2). The mel from the
linear head 1e-5 (values of a few units).
"""

import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import your_voice_tts_tpu.ops.dsp as jdsp
from your_voice_tts_tpu.audio import AudioProcessor as JaxAP
from your_voice_tts_tpu.config import AudioConfig as JaxAudioConfig
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.config import save_config as jax_save_config
from your_voice_tts_tpu.utils.logging import ConsoleLogger as JaxConsoleLogger
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.config import AudioConfig, load_config, save_config
from your_voice_tts_torch.utils.logging import ConsoleLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")
AUDIO = dict(num_mels=20, fft_size=256, sample_rate=8000, hop_length=64, win_length=256,
             mel_fmax=None, griffin_lim_iters=2)


@pytest.mark.parametrize("kind", ["mel", "linear"])
def test_single_clip_inverses_match_jax(kind, monkeypatch):
    """inv_melspectrogram / inv_spectrogram of one clip (45 frames) against
    the JAX AudioProcessor's, the port's phase (its generator, seed 3, over
    the frame bucket) injected as the JAX draw."""
    rng = np.random.default_rng(2)
    n_bins = 20 if kind == "mel" else 129
    spec = rng.uniform(-4, 0, (n_bins, 45)).astype(np.float32)
    ap = AudioProcessor(AudioConfig(**AUDIO), seed=3)
    got = ap.inv_melspectrogram(spec) if kind == "mel" else ap.inv_spectrogram(spec)
    tb = ap._frame_bucket(45)
    phase = (torch.rand((tb, 129), generator=torch.Generator().manual_seed(3))
             * (2.0 * np.pi)).numpy()
    monkeypatch.setattr(jdsp.jax.random, "uniform", lambda *a, **k: jnp.asarray(phase))
    jap = JaxAP(JaxAudioConfig(**AUDIO))
    ref = jap.inv_melspectrogram(spec) if kind == "mel" else jap.inv_spectrogram(spec)
    assert got.shape == ref.shape == (64 * 44,)
    np.testing.assert_allclose(got, ref, atol=5e-2 * np.abs(ref).max(), rtol=0)


def test_out_linear_to_mel_matches_jax():
    rng = np.random.default_rng(4)
    lin = rng.uniform(-4, 4, (129, 30)).astype(np.float32)
    got = AudioProcessor(AudioConfig(**AUDIO)).out_linear_to_mel(lin)
    ref = JaxAP(JaxAudioConfig(**AUDIO)).out_linear_to_mel(lin)
    assert got.shape == ref.shape == (20, 30)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_save_config_matches_jax(tmp_path):
    """The smoke config saved by each package: the same JSON document, which
    each package's `load_config` reads back to the config it saved."""
    cfg, jcfg = load_config(SMOKE), jax_load_config(SMOKE)
    save_config(cfg, str(tmp_path / "port.json"))
    jax_save_config(jcfg, str(tmp_path / "jax.json"))
    got, ref = (json.loads((tmp_path / n).read_text()) for n in ("port.json", "jax.json"))
    assert got == ref
    assert load_config(str(tmp_path / "port.json")) == cfg


def test_print_train_start_matches_jax(capsys):
    ConsoleLogger().print_train_start()
    got = capsys.readouterr().out
    JaxConsoleLogger().print_train_start()
    ref = capsys.readouterr().out
    clock = re.compile(r"\d\d:\d\d:\d\d")
    assert clock.search(got) and clock.sub("T", got) == clock.sub("T", ref)


def test_capture_trace_writes_a_trace_and_returns_the_value(tmp_path):
    """Trainer.capture_trace around one train step on the CPU: the step's
    metrics come back, and log_dir holds a Chrome trace whose events
    include the step's operators; start_profiler keeps its refusal,
    pointing at capture_trace."""
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.train.trainer import Trainer

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=4, sr=8000)
    cfg = load_config(SMOKE)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, datasets=(dataclasses.replace(cfg.data.datasets[0], path=corpus),)))
    trainer = Trainer(cfg, verbose=False, device="cpu")
    batch = next(trainer.train_data.batches(2, 2))
    out = trainer.capture_trace(str(tmp_path / "trace"), trainer.train_step, batch, 2)
    assert np.isfinite(out["loss"]) and trainer.step == 1
    (name,) = os.listdir(tmp_path / "trace")
    assert name.startswith("trace_") and name.endswith(".json")
    with open(tmp_path / "trace" / name, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    with pytest.raises(NotImplementedError, match="capture_trace"):
        trainer.start_profiler()
