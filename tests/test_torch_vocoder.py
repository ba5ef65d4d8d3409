"""The port's WaveRNN vocoder path against the JAX package on the CPU: the
vocoder config, a JAX-saved WaveRNN checkpoint loaded by the port's
VocoderSynthesizer, and text -> wav through Synthesizer and
bin/synthesize.py with a WaveRNN vocoder (plain versions of the kernels).
"""

import dataclasses
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import your_voice_tts_tpu.ops.pallas.wavernn_gen as jax_gen
from your_voice_tts_tpu.infer.synthesizer import Synthesizer as JaxSynthesizer
from your_voice_tts_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from your_voice_tts_tpu.vocoder.config import load_vocoder_config as jax_load_vocoder_config
from your_voice_tts_tpu.vocoder.synthesizer import VocoderSynthesizer as JaxVocoder
from your_voice_tts_torch.infer.synthesizer import Synthesizer
from your_voice_tts_torch.vocoder.config import load_vocoder_config
from your_voice_tts_torch.vocoder.models.wavernn import encode_mulaw
from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

torch.set_num_threads(1)

CONFIG, CKPT = "configs/smoke_synthetic.json", "assets/bench_trained_smoke.npz"
AUDIO = {"num_mels": 20, "fft_size": 256, "sample_rate": 8000, "hop_length": 64,
         "win_length": 256, "preemphasis": 0.98, "mel_fmax": None, "do_trim_silence": False}


def vocoder_json(path, upsample, target, overlap):
    """A small WaveRNN vocoder config (n_mels 20, R = F = 32, bits 8)."""
    with open(path, "w") as f:
        json.dump({"model": "wavernn", "audio": AUDIO,
                   "wavernn": {"bits": 8, "rnn_dims": 32, "fc_dims": 32, "compute_dims": 16,
                               "res_out_dims": 16, "num_res_blocks": 2,
                               "upsample_factors": upsample, "target": target,
                               "overlap": overlap}}, f)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Vocoder configs for hop 32 (4, 4, 2) and hop 64 (4, 4, 4), a
    JAX-saved checkpoint for each, and the smoke TTS config without
    prenet dropout (the two packages draw dropout from different
    generators), 64 decode steps."""
    d = tmp_path_factory.mktemp("vocoder")
    out = {}
    for name, up in (("hop32", [4, 4, 2]), ("hop64", [4, 4, 4])):
        cfg = vocoder_json(d / f"{name}.json", up, target=96, overlap=16)
        jax_voc = JaxVocoder(cfg)
        ckpt = jax_save_checkpoint(str(d / f"{name}.npz"), params=jax_voc.params,
                                   model_state={}, opt_state=None, step=0, epoch=0, r=1)
        out[name] = (cfg, ckpt)
    with open(CONFIG) as f:
        raw = json.loads("\n".join(line for line in f if not line.strip().startswith("//")))
    raw.update(prenet_dropout=False, max_decoder_steps=64)
    out["tts"] = str(d / "tts.json")
    with open(out["tts"], "w") as f:
        json.dump(raw, f)
    return out


def test_vocoder_config_matches_jax(files):
    cfg, _ = files["hop64"]
    assert dataclasses.asdict(load_vocoder_config(cfg)) == \
        dataclasses.asdict(jax_load_vocoder_config(cfg))
    assert dataclasses.asdict(load_vocoder_config("configs/melgan_smoke.json")) == \
        dataclasses.asdict(jax_load_vocoder_config("configs/melgan_smoke.json"))


def test_melgan_vocoder_builds_on_cpu():
    from your_voice_tts_torch.vocoder.models.melgan import MelganGenerator

    voc = VocoderSynthesizer("configs/melgan_smoke.json", device="cpu")
    assert isinstance(voc.model, MelganGenerator) and voc.model.hop == 64
    assert voc.model.conv_in.weight.device.type == "cpu"
    wav = voc.mel_to_wav(np.zeros((20, 5), np.float32))
    assert wav.shape == (5 * 64,) and wav.dtype == np.float32


def test_pwgan_vocoder_builds_on_cpu(tmp_path):
    from your_voice_tts_torch.vocoder.models.pwgan import ParallelWaveganGenerator

    path = tmp_path / "pwgan.json"
    path.write_text(json.dumps({"model": "pwgan", "audio": AUDIO,
                                "pwgan": {"num_layers": 4, "stacks": 2,
                                          "upsample_factors": [4, 4, 4]}}))
    voc = VocoderSynthesizer(str(path), device="cpu")
    assert isinstance(voc.model, ParallelWaveganGenerator) and voc.model.hop == 64
    wav = voc.mel_to_wav(np.zeros((20, 5), np.float32))
    assert wav.shape == (5 * 64,) and np.isfinite(wav).all()


def test_unknown_vocoder_model_raises(tmp_path):
    path = tmp_path / "hifigan.json"
    path.write_text(json.dumps({"model": "hifigan", "audio": AUDIO}))
    with pytest.raises(ValueError, match="unknown vocoder model 'hifigan'"):
        VocoderSynthesizer(str(path), device="cpu")


def test_synthesizer_with_trained_melgan_matches_jax(files):
    """Text -> wav through the trained smoke TTS and the trained MelGAN
    asset in both packages, dropout off: the same lengths, samples within
    1e-3 (the mels differ by ~1e-4, float32 sum order)."""
    ckpt = "assets/bench_trained_melgan.npz"
    ref = JaxSynthesizer(files["tts"], CKPT, vocoder_config="configs/melgan_smoke.json",
                         vocoder_checkpoint=ckpt).tts_many(TEXTS)
    port = Synthesizer(files["tts"], CKPT, vocoder_config="configs/melgan_smoke.json",
                       vocoder_checkpoint=ckpt, device="cpu", decode_dtype=torch.float32)
    got = port.tts_many(TEXTS)
    assert [len(w) for w in got] == [len(w) for w in ref]
    for a, b in zip(got, ref):
        assert np.abs(a).max() > 1e-2
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_checkpoint_bridge_mel_to_wav_matches_jax(files, monkeypatch):
    """A JAX-saved WaveRNN .npz in the port's VocoderSynthesizer: mel_to_wav
    (edge padding, 3 folds of 128 steps, crossfade) against the JAX
    synthesizer's weights through its kernel route, with the seed the JAX
    side draws for its first call. The Pallas call runs at a 64-step chunk
    (interpret-mode cost; its output does not depend on the chunk, as the
    JAX package's test_wavernn_pallas_sampled_chunk_invariance shows).
    Classes identical, samples within 1e-5."""
    monkeypatch.setattr(jax_gen, "default_chunk", lambda *a, **k: 64)
    cfg, ckpt = files["hop32"]
    jax_voc = JaxVocoder(cfg, ckpt)
    port = VocoderSynthesizer(cfg, ckpt, device="cpu")
    mel = np.random.default_rng(6).standard_normal((20, 9)).astype(np.float32)
    _, sub = jax.random.split(jax.random.PRNGKey(0))      # mel_to_wav's first draw
    seed = int(jax.random.randint(sub, (), 0, 2 ** 31 - 1))
    w = jax_voc.cfg.wavernn
    mel_p = jnp.pad(jnp.asarray(mel.T), ((w.pad, w.pad), (0, 0)), mode="edge")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_voc.model.generate(jax_voc.params, mel_p, sub, target=w.target,
                                                overlap=w.overlap, use_pallas=True))
    got = port.mel_to_wav(mel, seed=seed)
    assert got.shape == ref.shape == (9 * 32,) and got.dtype == np.float32
    np.testing.assert_array_equal(encode_mulaw(torch.from_numpy(got), 8).numpy(),
                                  encode_mulaw(torch.from_numpy(np.array(ref)), 8).numpy())
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.fixture(scope="module")
def jax_wavs(files):
    """The JAX package's text -> wav with the hop-64 WaveRNN (its CPU route
    samples with jax.random, so only the lengths are comparable)."""
    cfg, ckpt = files["hop64"]
    synth = JaxSynthesizer(files["tts"], CKPT, vocoder_config=cfg, vocoder_checkpoint=ckpt)
    return synth.tts_many(TEXTS)


TEXTS = ["Hi there.", "Go home now."]


def test_synthesizer_with_wavernn_matches_jax_lengths(files, jax_wavs):
    cfg, ckpt = files["hop64"]
    port = Synthesizer(files["tts"], CKPT, vocoder_config=cfg, vocoder_checkpoint=ckpt,
                       device="cpu", decode_dtype=torch.float32)
    assert port.vocoder is not None and port.vocoder.model.hop == 64
    got = port.tts_many(TEXTS)
    assert [len(w) for w in got] == [len(w) for w in jax_wavs]
    assert all(np.isfinite(w).all() and 0 < np.abs(w).max() <= 1.0 for w in got)


def test_cli_with_wavernn_writes_wavs(files, jax_wavs, tmp_path):
    from your_voice_tts_torch.bin.synthesize import main

    cfg, ckpt = files["hop64"]
    main([TEXTS[0], files["tts"], CKPT, str(tmp_path), "--vocoder_config", cfg,
          "--vocoder_checkpoint", ckpt, "--device", "cpu"])
    with wave.open(str(tmp_path / "out_000.wav")) as f:
        assert f.getframerate() == 8000
        pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    assert len(pcm) == len(jax_wavs[0]) and np.abs(pcm).max() > 0
