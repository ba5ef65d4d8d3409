"""Mean / std spectrogram statistics in the port against the JAX package on
the CPU: `bin/compute_statistics` over a synthetic corpus (both CLIs, the
same scale_stats.npy keys), and the AudioProcessor with `stats_path`: its
mel and linear spectrograms, the normalized silence it pads with, the
magnitudes Griffin-Lim inverts and the round trip through the statistics.

Tolerances: the statistics 1e-6 relative (float64 sums of float32 dB
values on both sides), but the linear std at 1e-5: float32 STFT rounding
at quiet bins moves it by 1.5e-6 (the JAX package's) and 4.5e-6 (the
port's) from a float64 STFT's on this corpus; the normalized mel at the 1e-4 the port's mel tests
hold (tests/test_torch_train.py), here over values scaled by the per-bin
std; the linear spectrogram as tests/test_torch_taco1_train.py holds it
(`hold_linear`: amplitude at 1e-5 of its frame's peak, the normalized
values at 1e-4 within 60 dB of the peak); the round trip 1e-5 (float32).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from test_torch_taco1_train import hold_linear
from your_voice_tts_tpu.audio import AudioProcessor as JaxAudioProcessor
from your_voice_tts_tpu.bin.compute_statistics import compute_statistics as jax_statistics
from your_voice_tts_tpu.bin.compute_statistics import main as jax_main
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.bin.compute_statistics import compute_statistics, main
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.data import load_meta_data
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")
STATS_TOL, LIN_STD_TOL, MEL_TOL, ROUND_TOL = 1e-6, 1e-5, 1e-4, 1e-5


@functools.cache
def corpus(root: str):
    """(JAX config, port config, items) of a 12-item sr=8000 corpus."""
    path = make_synthetic_corpus(os.path.join(root, "corpus"), n_items=12, sr=8000)
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(SMOKE)
        ds = dataclasses.replace(cfg.data.datasets[0], path=path)
        out.append(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,))))
    items, _ = load_meta_data(out[1].data.datasets, eval_split=False)
    return out[0], out[1], items


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stats"))
    jcfg, cfg, items = corpus(root)
    ref = jax_statistics(jcfg, items)
    path = os.path.join(root, "scale_stats.npy")
    np.save(path, ref, allow_pickle=True)
    with_stats = lambda c: dataclasses.replace(  # noqa: E731
        c, audio=dataclasses.replace(c.audio, stats_path=path))
    return with_stats(jcfg), with_stats(cfg), items, ref, root


def test_statistics_match_jax(setup):
    """Every array of scale_stats against the JAX package's at 1e-6
    relative (the linear std 1e-5), the frame count exact, the raw audio config the same (the
    statistics are taken with normalization and earlier statistics off)."""
    jcfg, cfg, items, ref, _ = setup
    got = compute_statistics(cfg, items, device="cpu")
    assert set(got) == set(ref)
    assert got["n_frames"] == ref["n_frames"] > 0
    assert got["audio_config"] == ref["audio_config"]
    assert got["audio_config"]["signal_norm"] is False and got["audio_config"]["stats_path"] is None
    for k in ("mel_mean", "mel_std", "linear_mean", "linear_std"):
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], err_msg=k,
                                   rtol=LIN_STD_TOL if k == "linear_std" else STATS_TOL)
    # the statistics of an already-normalized config are those of the raw
    # values: normalization and stats_path are switched off for the pass
    again = compute_statistics(cfg, items[:4], include_linear=False, device="cpu")
    assert set(again) == {"mel_mean", "mel_std", "n_frames", "audio_config"}


def test_cli_writes_the_jax_clis_file(setup, tmp_path):
    """bin/compute_statistics --device cpu writes the keys and arrays the
    JAX CLI writes (1e-6 relative; the linear std 1e-5)."""
    jcfg, cfg, items, _, root = setup
    import json

    with open(SMOKE, encoding="utf-8") as f:
        raw = json.loads("\n".join(line for line in f if not line.strip().startswith("//")))
    raw["datasets"][0]["path"] = cfg.data.datasets[0].path
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    main(["--config_path", str(cfg_path), "--out_path", str(tmp_path / "port.npy"),
          "--device", "cpu"])
    jax_main(["--config_path", str(cfg_path), "--out_path", str(tmp_path / "jax.npy")])
    got = np.load(tmp_path / "port.npy", allow_pickle=True).item()
    ref = np.load(tmp_path / "jax.npy", allow_pickle=True).item()
    assert set(got) == set(ref) and got["n_frames"] == ref["n_frames"]
    for k in ("mel_mean", "mel_std", "linear_mean", "linear_std"):
        np.testing.assert_allclose(got[k], ref[k], err_msg=k,
                                   rtol=LIN_STD_TOL if k == "linear_std" else STATS_TOL)


def test_audio_processor_normalizes_with_the_statistics(setup):
    """With stats_path the mel and linear spectrograms are (S - mean) / std
    per bin, against the JAX AudioProcessor; the pad value is each bin's
    normalized silence; Griffin-Lim's magnitudes denormalize through the
    statistics (against the JAX package's mean / std branch of
    denormalize_spec and its dB map)."""
    jcfg, cfg, items, ref, _ = setup
    jap, ap = JaxAudioProcessor(jcfg.audio), AudioProcessor(cfg.audio)
    np.testing.assert_array_equal(ap.host_stats["mel"][0], ref["mel_mean"])
    np.testing.assert_array_equal(ap.host_stats["linear"][1], ref["linear_std"])
    wavs = ap.load_wav_batch([it[1] for it in items[:4]])
    for g, r in zip(ap.melspectrogram_batch(wavs), jap.melspectrogram_batch(wavs)):
        assert abs(float(g.mean())) < 1.0               # z-scored, not range-normalized
        np.testing.assert_allclose(g, r, atol=MEL_TOL, rtol=0)
    to_db = lambda s: s * ref["linear_std"] + ref["linear_mean"]  # noqa: E731
    for g, r in zip(ap.spectrogram_batch(wavs), jap.spectrogram_batch(wavs)):
        hold_linear(g, r, to_db)
    for kind, stats in ap.host_stats.items():
        fill = ap._silence_fill(kind)
        np.testing.assert_allclose(fill * stats[1] + stats[0], cfg.audio.min_level_db,
                                   rtol=ROUND_TOL)
        np.testing.assert_array_equal(fill, jap._silence_fill(
            "inv_mel" if kind == "mel" else "inv_spec", len(stats[0])))
    from your_voice_tts_tpu.ops import dsp as jdsp

    rng = np.random.default_rng(0)
    spec = rng.standard_normal((2, 7, 129)).astype(np.float32)
    S = ap.gl_magnitudes("linear", torch.from_numpy(spec)).numpy()
    c = jcfg.audio
    D = jdsp.denormalize_spec(spec, c.min_level_db, c.max_norm, c.symmetric_norm, c.clip_norm,
                              c.signal_norm, jap.linear_stats)
    np.testing.assert_allclose(S, np.asarray(jdsp.db_to_amp(D + c.ref_level_db, c.spec_gain))
                               ** c.power, rtol=ROUND_TOL)


def test_statistics_round_trip(setup):
    """normalize -> denormalize through the statistics gives the dB values
    back (no clipping on this branch), and the statistics of a corpus
    normalized by them are mean 0, std 1 per bin."""
    from your_voice_tts_torch.ops import dsp

    _, cfg, items, ref, _ = setup
    mean, std = (torch.from_numpy(ref[k]) for k in ("mel_mean", "mel_std"))
    S = torch.from_numpy(np.random.default_rng(1).uniform(-90, 10, (3, 11, 20)).astype(
        np.float32))
    c = cfg.audio
    args = (c.min_level_db, c.max_norm, c.symmetric_norm, c.clip_norm, True)
    back = dsp.denormalize_spec(dsp.normalize_spec(S, *args, stats=(mean, std)), *args,
                                stats=(mean, std))
    np.testing.assert_allclose(back.numpy(), S.numpy(), rtol=ROUND_TOL, atol=ROUND_TOL * 100)
    ap = AudioProcessor(cfg.audio)
    mels = np.concatenate(ap.melspectrogram_batch(ap.load_wav_batch([it[1] for it in items])))
    np.testing.assert_allclose(mels.mean(0), 0.0, atol=1e-3)
    np.testing.assert_allclose(mels.std(0), 1.0, atol=1e-3)


def test_serving_program_carries_the_statistics(setup):
    """The export's serving program (`make_serving_fn`, what torch.export
    traces) of a config with statistics: its tail fill is each bin's
    normalized silence and its Griffin-Lim stage holds the statistics as
    buffers and denormalizes through them, as the AudioProcessor does;
    the program's audio is finite."""
    from your_voice_tts_torch.infer.export import make_serving_fn
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.ops import dsp
    from your_voice_tts_torch.text import symbols

    _, cfg, _, ref, _ = setup
    ap = AudioProcessor(cfg.audio)
    model = setup_model(len(symbols), cfg, device="cpu")
    program = make_serving_fn(model, cfg, ap, max_decoder_steps=6)
    np.testing.assert_array_equal(program.fill.numpy(), ap._silence_fill("mel"))
    stage = program.wave
    np.testing.assert_array_equal(stage.stats_mean.numpy(), ref["mel_mean"])
    np.testing.assert_array_equal(stage.stats_std.numpy(), ref["mel_std"])
    spec = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 9, 20)).astype(
        np.float32))
    np.testing.assert_array_equal(
        dsp.gl_magnitudes(spec, stage.inv_mel_basis, stats=(stage.stats_mean, stage.stats_std),
                          **stage.magnitude_args).numpy(),
        ap.gl_magnitudes("mel", spec).numpy())
    text = torch.ones(2, 8, dtype=torch.long)
    wav, lengths = program(text, torch.tensor([8, 5]), torch.zeros(1, dtype=torch.long))
    assert wav.shape[0] == 2 and bool(torch.isfinite(wav).all())
