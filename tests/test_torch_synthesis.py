"""The port's slice as a whole against the JAX package: the trained smoke
checkpoint, text -> mel through Tacotron2.inference, and text -> wav
through the Synthesizer, on the CPU (plain versions of the kernels)."""

import dataclasses
import io
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.infer.synthesizer import Synthesizer as JaxSynthesizer
from your_voice_tts_tpu.text import text_to_sequence as jax_text_to_sequence
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
from your_voice_tts_torch.infer.synthesizer import Synthesizer
from your_voice_tts_torch.text import text_to_sequence

torch.set_num_threads(1)

CONFIG, CKPT = "configs/smoke_synthetic.json", "assets/bench_trained_smoke.npz"


def without_dropout(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, prenet_dropout=False, **kw))


@pytest.fixture(scope="module")
def synths():
    """(JAX Synthesizer, port Synthesizer) on the smoke checkpoint, dropout
    off, 64 decode steps (the JAX CPU route decodes in 64-step chunks)."""
    jax_s = JaxSynthesizer(without_dropout(jax_load_config(CONFIG), max_decoder_steps=64), CKPT)
    port = Synthesizer(without_dropout(load_config(CONFIG), max_decoder_steps=64), CKPT,
                       device="cpu", decode_dtype=torch.float32)
    return jax_s, port


def test_tacotron2_inference_matches_jax(synths):
    """Postnet mel within 1e-4 (float32, sum order only), lengths exact;
    alignments and stops up to each row's length (past its stop the scan
    freezes a row, the kernel route keeps it running)."""
    jax_s, port = synths
    texts = ["Hi there.", "The quick brown fox jumps over the lazy dog.",
             "Hello world, this is a test"]
    text, lengths = _pad_texts([text_to_seq(t, port.cfg) for t in texts])
    ref = jax_s.model.inference(jax_s.variables, jnp.asarray(text, jnp.int32),
                                jnp.asarray(lengths, jnp.int32), use_pallas=False,
                                max_decoder_steps=50)
    got = port.model.inference(text, lengths, max_decoder_steps=50,
                               decode_dtype=torch.float32)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(ref["mel_lengths"]))
    assert got["mel_lengths"].min() < 100        # one row stops before the cap
    np.testing.assert_allclose(got["postnet_outputs"].numpy(),
                               np.asarray(ref["postnet_outputs"]), atol=1e-4)
    for row, n in enumerate(np.asarray(ref["mel_lengths"]) // 2):
        for key in ("alignments", "stop_probs"):
            np.testing.assert_allclose(got[key][row, :n].numpy(),
                                       np.asarray(ref[key])[row, :n], atol=1e-4)


def test_synthesizer_wav_lengths_match_jax(synths):
    jax_s, port = synths
    texts = ["Hi there.", "It is cold. A cat sat.", "Go home now."]
    ref = jax_s.tts_many(texts)
    got = port.tts_many(texts)
    assert [len(w) for w in got] == [len(w) for w in ref]
    assert all(np.isfinite(w).all() and np.abs(w).max() > 0 for w in got)


def test_tts_to_wav_bytes(synths):
    _, port = synths
    blob = port.tts_to_wav_bytes("Hi there.")
    with wave.open(io.BytesIO(blob)) as f:
        assert f.getframerate() == 8000 and f.getsampwidth() == 2
        assert f.getnframes() > 0


def test_cli_writes_wavs(tmp_path):
    from your_voice_tts_torch.bin.synthesize import main

    main(["Hi there.", CONFIG, CKPT, str(tmp_path), "--device", "cpu"])
    with wave.open(str(tmp_path / "out_000.wav")) as f:
        assert f.getnframes() > 0


@pytest.mark.parametrize("text", [
    "Dr. Smith paid $3.50 on the 2nd of May, 1984.",
    "Turn {L EH1 F T} now!",
    "Mrs. O'Neil's   café — 12,000 people?",
])
def test_text_frontend_matches_jax(text):
    np.testing.assert_array_equal(text_to_sequence(text), jax_text_to_sequence(text))


@pytest.mark.parametrize("path", [CONFIG, "configs/ljspeech_tacotron2.json"])
def test_config_matches_jax(path):
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(jax_load_config(path))


def tacotron_config(loader, **kw):
    """The smoke config's audio with a small Tacotron(1) (width 32, memory 5,
    attention 24), dropout off, 12 decode steps."""
    cfg = loader(CONFIG)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, model="Tacotron", memory_size=5, tacotron_width=32, attention_dim=24,
        prenet_dropout=False, max_decoder_steps=12, **kw))


def test_tacotron_synthesis_matches_jax(tmp_path):
    """Text -> linear spectrogram -> wav through a JAX-saved Tacotron(1)
    checkpoint (its stopnet bias at -10, so every row decodes all its
    steps): the linear outputs match the JAX `synthesis_batch` within 1e-3
    (float32, sum order only), the wav lengths exactly."""
    from your_voice_tts_tpu.infer.synthesis import synthesis_batch as jax_synthesis_batch
    from your_voice_tts_tpu.train.checkpoint import save_checkpoint
    from your_voice_tts_torch.infer.synthesis import synthesis_batch

    jax_s = JaxSynthesizer(tacotron_config(jax_load_config))
    params = jax_s.variables["params"]
    stop = params["decoder"]["stopnet"]
    stop["b"] = jnp.full_like(stop["b"], -10.0)
    ckpt = save_checkpoint(str(tmp_path / "taco1.npz"), params=params,
                           model_state=jax_s.variables["state"], opt_state={}, step=1,
                           epoch=0, r=2)
    port = Synthesizer(tacotron_config(load_config), ckpt, device="cpu",
                       decode_dtype=torch.float32)
    assert port.model.output_type == "linear" and port.model.r == 2
    texts = ["Hi there.", "The quick brown fox jumps.", "Go home now."]
    ref = jax_synthesis_batch(jax_s.model, jax_s.variables, texts, jax_s.cfg, jax_s.ap)
    got = synthesis_batch(port.model, texts, port.cfg, port.ap, decode_dtype=torch.float32)
    for g, r in zip(got, ref):
        assert g["mel_postnet_spec"].shape == r["mel_postnet_spec"].shape == (129, 24)
        np.testing.assert_allclose(g["mel_postnet_spec"], r["mel_postnet_spec"], atol=1e-3)
        assert g["wav"].shape == r["wav"].shape
        assert np.isfinite(g["wav"]).all() and np.abs(g["wav"]).max() > 0
