"""The port's tools against the JAX package's on the CPU: the quality
metrics (utils/quality.py), `bin/preprocess` (the corpus audit and the
cache warm-up), the trainer's plots (utils/visual.py), its TensorBoard
logger without tensorboardX, and `Trainer.test_run`, which synthesizes the
test sentences and hands their figures and audio to the logger.

Tolerances: the quality metrics 1e-12 (numpy float64 on both sides, the
same operations); the audit report exact but its `loader` (the header
parser each package names).
"""

import dataclasses
import json
import os
import sys
import wave

import numpy as np
import pytest
import torch

from your_voice_tts_tpu.bin.preprocess import audit as jax_audit
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.utils import quality as jq
from your_voice_tts_torch.config import AudioConfig, load_config
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.utils import quality as pq

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")
QUALITY_TOL = 1e-12


# --- quality metrics ------------------------------------------------------

@pytest.mark.parametrize("norm", [dict(), dict(symmetric_norm=False), dict(clip_norm=False),
                                  dict(signal_norm=False)])
def test_quality_metrics_match_jax(norm):
    """denormalize_mel (range and statistics), MCD with and without DTW (in
    dB, normalized and statistics-scaled input), stop-token scores, prf
    and speaker similarity against the JAX package's functions."""
    rng = np.random.default_rng(0)
    cfg = AudioConfig(num_mels=20, **norm)
    a, b = rng.uniform(-5, 5, (23, 20)), rng.uniform(-5, 5, (17, 20))
    stats = (rng.uniform(-60, -20, 20), rng.uniform(5, 15, 20))
    for st in (None, stats):
        np.testing.assert_allclose(pq.denormalize_mel(a, cfg, st), jq.denormalize_mel(a, cfg, st),
                                   rtol=QUALITY_TOL, atol=QUALITY_TOL)
        for dtw in (True, False):
            for c in (cfg, None):
                got = pq.mel_cepstral_distortion(a, b, c, n_coef=13, use_dtw=dtw, stats=st)
                want = jq.mel_cepstral_distortion(a, b, c, n_coef=13, use_dtw=dtw, stats=st)
                assert abs(got - want) <= QUALITY_TOL * max(1.0, abs(want))
    probs = rng.uniform(0, 1, (12, 30))
    counts = []
    for p, length, tol in zip(probs, rng.integers(1, 31, 12), [0, 1, 2, 3] * 3):
        got, want = (m.stop_token_scores(p, int(length), 0.6, int(tol)) for m in (pq, jq))
        assert got == want
        counts.append(got)
    counts += [{"tp": 0, "fp": 0, "fn": 1}, {"tp": 1, "fp": 0, "fn": 0}]
    assert pq.prf(counts) == jq.prf(counts)
    x, y = rng.standard_normal(256), rng.standard_normal(256)
    for u, v in ((x, y), (x, x), (x, -2 * x), (np.zeros(4), np.ones(4))):
        assert abs(pq.speaker_similarity(u, v) - jq.speaker_similarity(u, v)) <= QUALITY_TOL


# --- preprocess -----------------------------------------------------------

def _write_wav(path, data, sr, channels=1):
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 10-item sr=8000 synthetic corpus, plus rows the audit flags: a
    missing clip, a stereo clip at 16 kHz and a text too short to train."""
    path = make_synthetic_corpus(str(tmp_path_factory.mktemp("tools")), n_items=10, sr=8000)
    rng = np.random.default_rng(1)
    _write_wav(os.path.join(path, "wavs", "SYN00-9997.wav"),
               0.1 * rng.standard_normal(2 * 4000), 16000, channels=2)
    _write_wav(os.path.join(path, "wavs", "SYN00-9996.wav"), 0.1 * rng.standard_normal(4000),
               8000)
    with open(os.path.join(path, "metadata.csv"), "a", encoding="utf-8") as f:
        f.write("SYN00-9998|a missing clip|a missing clip\n"
                "SYN00-9997|a stereo clip at a higher rate|a stereo clip at a higher rate\n"
                "SYN00-9996|hi|hi\n")
    return path


def configs(path, **model):
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(SMOKE)
        ds = dataclasses.replace(cfg.data.datasets[0], path=path)
        out.append(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
                                       model=dataclasses.replace(cfg.model, **model)))
    return out


def test_audit_report_matches_jax(corpus, tmp_path, capsys):
    """preprocess --audit: the JAX report's keys and values (the missing
    clip, the stereo clip, the resampling warning, the short text, the
    duration and text statistics), all but `loader`, which names the
    port's header parser; the CLI prints it as JSON and exits 1 on
    problems."""
    from your_voice_tts_torch.bin import preprocess

    jcfg, cfg = configs(corpus)
    got, want = preprocess.audit(cfg), jax_audit(jcfg)
    assert got.pop("loader") == "read_wav"
    want.pop("loader")
    assert got == want
    assert len(got["problems"]) == 2 and len(got["warnings"]) == 1
    assert got["filtered_by_seq_len"] == 1
    cfg_path = tmp_path / "cfg.json"
    with open(SMOKE, encoding="utf-8") as f:
        raw = json.loads("\n".join(line for line in f if not line.strip().startswith("//")))
    raw["datasets"][0]["path"] = corpus
    cfg_path.write_text(json.dumps(raw))
    assert preprocess.main(["--config_path", str(cfg_path), "--audit"]) == 1
    printed = json.loads(capsys.readouterr().out)
    assert printed["rows"] == got["rows"] == 13


@pytest.mark.parametrize("model", ["Tacotron2", "Tacotron"])
def test_preprocess_warms_the_caches_the_dataset_reads(tmp_path, model):
    """preprocess --cache_dir: every clip's mel (and, for Tacotron(1), its
    linear spectrogram) and, for a phoneme config, its phoneme ids land in
    the cache; a dataset on that cache then reads them without an audio
    processor, equal to a dataset computed afresh."""
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.bin import preprocess
    from your_voice_tts_torch.data import TTSDataset, load_meta_data

    path = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=6, sr=8000)
    with open(SMOKE, encoding="utf-8") as f:
        raw = json.loads("\n".join(line for line in f if not line.strip().startswith("//")))
    raw["datasets"][0]["path"] = path
    raw.update(model=model, use_phonemes=True, g2p_backend="CMUDictBackend")
    if model == "Tacotron":
        raw.update(tacotron_width=32, memory_size=5, attention_dim=24)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    cache = tmp_path / "cache"
    assert preprocess.main(["--config_path", str(cfg_path), "--cache_dir", str(cache),
                            "--device", "cpu"]) == 0
    files = os.listdir(cache)
    assert sum(f.startswith("mel_") for f in files) == 6
    assert sum(f.startswith("lin_") for f in files) == (6 if model == "Tacotron" else 0)
    assert len(os.listdir(cache / "phonemes")) == 6
    cfg = load_config(str(cfg_path))
    items, ev = load_meta_data(cfg.data.datasets)
    cached = TTSDataset(items + ev, cfg, None, cache_dir=str(cache))
    fresh = TTSDataset(items + ev, cfg, AudioProcessor(cfg.audio))
    for a, b in zip(cached.entries, fresh.entries):
        np.testing.assert_array_equal(a["mel"], b["mel"])
        np.testing.assert_array_equal(a["seq"], b["seq"])
        if model == "Tacotron":
            np.testing.assert_array_equal(a["linear"], b["linear"])


# --- plots and the logger -------------------------------------------------

def test_plots():
    """plot_alignment draws decoder steps on x; plot_spectrogram draws time
    on x for either layout it is told, and by the longer axis without."""
    pytest.importorskip("matplotlib")
    from your_voice_tts_torch.utils.visual import plot_alignment, plot_spectrogram

    rng = np.random.default_rng(0)
    fig = plot_alignment(rng.uniform(size=(30, 12)), title="t")
    assert fig.axes[0].images[0].get_array().shape == (12, 30)
    assert fig.axes[0].get_title() == "t"
    spec = rng.uniform(size=(7, 20))                    # [T, F], fewer frames than bins
    for s, tm in ((spec, True), (spec.T, False)):
        img = plot_spectrogram(s, time_major=tm).axes[0].images[0].get_array()
        assert img.shape == (20, 7)
    assert plot_spectrogram(spec).axes[0].images[0].get_array().shape == (7, 20)


def test_tensorboard_logger_without_tensorboardx(monkeypatch, tmp_path):
    """Without tensorboardX the logger has no writer and every method does
    nothing (no file appears); without a log directory likewise."""
    from your_voice_tts_torch.utils.logging import TensorboardLogger

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    for log_dir in (str(tmp_path), None):
        tb = TensorboardLogger(log_dir)
        assert tb.writer is None
        tb.tb_train_iter_stats(1, {"loss": 1.0})
        tb.tb_train_epoch_stats(1, {"loss": 1.0})
        tb.tb_eval_stats(1, {"loss": 1.0})
        tb.tb_train_figures(1, {"a": None})
        tb.tb_eval_figures(1, {"a": None})
        tb.tb_eval_audios(1, {"a": np.zeros(8)}, 8000)
        tb.tb_model_weights(1, torch.nn.Linear(2, 2))
        tb.flush()
    assert os.listdir(tmp_path) == []


class RecordingWriter:
    """Stands in for tensorboardX's SummaryWriter: records each call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a, **k: self.calls.append((name, a[0]))


@pytest.mark.parametrize("model", ["Tacotron2", "Tacotron", "table"])
def test_test_run_returns_results_and_logs_them(tmp_path, model):
    """Trainer.test_run on the CPU: the test sentences of
    io.test_sentences_file synthesized (each row's spectrogram [F, T],
    alignment, stop tokens and waveform), their alignment and spectrogram
    figures and audio handed to the logger under the JAX package's names;
    a speaker-table model speaks as speaker id 0; without a writer the
    results come back all the same. fit() runs it after each evaluation
    from test_delay_epochs on."""
    pytest.importorskip("matplotlib")
    from your_voice_tts_torch.train.trainer import Trainer

    path = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=8, sr=8000,
                                 n_speakers=2 if model == "table" else 1)
    sentences = tmp_path / "sentences.txt"
    sentences.write_text("Be a voice.\n\nNot an echo at all.\n")
    _, cfg = configs(path, **({} if model == "table" else dict(model=model)),
                     **(dict(tacotron_width=32, memory_size=5, attention_dim=24,
                             max_decoder_steps=10) if model == "Tacotron"
                        else dict(max_decoder_steps=10)))
    cfg = dataclasses.replace(
        cfg, io=dataclasses.replace(cfg.io, test_sentences_file=str(sentences)),
        speakers=dataclasses.replace(cfg.speakers, use_speaker_embedding=model == "table"),
        training=dataclasses.replace(cfg.training, test_delay_epochs=0, epochs=1))
    trainer = Trainer(cfg, verbose=False, device="cpu")
    trainer.tb.writer = RecordingWriter()
    results = trainer.test_run(7)
    assert [r["text"] for r in results] == ["Be a voice.", "Not an echo at all."]
    n_bins = 129 if model == "Tacotron" else 20
    for r in results:
        assert r["mel_postnet_spec"].shape[0] == n_bins
        assert r["wav"].ndim == 1 and len(r["wav"]) > 0 and np.isfinite(r["wav"]).all()
    assert sorted(trainer.tb.writer.calls) == sorted(
        [("add_figure", f"EvalFigures/{i}-{k}") for i in range(2)
         for k in ("alignment", "spectrogram")]
        + [("add_audio", f"EvalAudios/{i}-audio") for i in range(2)])
    trainer.tb.writer = None
    assert len(trainer.test_run(8)) == 2
    seen = []
    trainer.test_run = lambda step: seen.append(step)
    trainer.fit(max_steps=1)
    assert seen == [1]
