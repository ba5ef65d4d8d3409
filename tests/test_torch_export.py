"""The serving export (`infer/export.py`, `ops/library.py`) against the
JAX package's, on the CPU, at tests/test_export.py's tiny Tacotron2 (20
mels, n_fft 256, hop 64, 4 Griffin-Lim iterations, 10 decode steps), built
in both packages from the same weights through the port's weight bridge.

An artifact is held against its own unexported program (`make_serving_fn`):
lengths exact, wav within 1e-6. The stages against the JAX package, at the
tolerances the port's tests hold them to elsewhere:
- the masked spectrogram (plain decode in float32) against the JAX
  `model.inference` and the JAX artifact's tail fill, as
  `test_torch_synthesis.py` holds inference against the JAX package: 1e-4
  (sum order only), lengths exact; unconditioned, and with d-vectors and a
  GST style at once;
- the waveform stage against `dsp.inv_melspectrogram_batch` (the whole-loop
  Pallas kernel in interpret mode) with the seed's phase injected:
  `test_torch_gl_routes.py`'s 2e-2 of the peak (bf16 loop state, a
  de-emphasis gain of up to 50x);
- MelGAN end to end against the JAX `make_serving_fn(vocoder=...)` at 1e-5
  (float32 decode on both sides; MelGAN draws nothing).
Where the live port route is held against the JAX package elsewhere
(Tacotron(1) in `test_torch_tacotron.py`, the speaker table in
`test_torch_speakers.py`), the traced route is held against the live one.
The server's command line and the rule that an artifact serves without
model code are in `test_torch_guards.py`.
"""

import dataclasses
import functools
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from your_voice_tts_tpu.audio import AudioProcessor as JaxAP
from your_voice_tts_tpu.config import AudioConfig as JaxAudioConfig
from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.infer import export as jexport
from your_voice_tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from your_voice_tts_tpu.ops import dsp as jdsp
from your_voice_tts_torch.audio import AudioProcessor, GriffinLimStage
from your_voice_tts_torch.config import AudioConfig, DataConfig, ModelConfig
from your_voice_tts_torch.infer.export import (ExportedSpeakerEncoder, ExportedSynthesizer,
                                               export_serving, export_speaker_encoder,
                                               make_serving_fn)
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.ops import prng
from your_voice_tts_torch.text import symbols
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax

torch.set_num_threads(1)

N_MELS, CHARS = 20, len(symbols)
TINY = dict(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48, attention_rnn_dim=48,
            attention_dim=24, attention_location_filters=8, attention_location_kernel_size=15,
            prenet_dim=24, postnet_dim=32, max_decoder_steps=10, prenet_dropout=False)
AUDIO = dict(num_mels=N_MELS, fft_size=256, sample_rate=8000, hop_length=64, win_length=256,
             griffin_lim_iters=4, mel_fmax=None)


class Cfg:
    """The config groups export reads, for both packages."""

    def __init__(self, model, audio, data=None):
        self.model, self.audio, self.data = model, audio, data


def pair(seed=0, **kw):
    """(JAX model, its variables, the port's model with the same weights)
    for the tiny config; kw go to both constructors."""
    jm = JaxTacotron2(CHARS, JaxModelConfig(**TINY), n_mels=N_MELS, **kw)
    v = jm.init(jax.random.PRNGKey(seed))
    pm = Tacotron2(CHARS, ModelConfig(**TINY), n_mels=N_MELS, device="cpu", **kw)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pm.load_state_dict(params_from_jax(tree(v["params"]), tree(v["state"]), jax_layouts(pm)),
                       strict=True)
    return jm, v, pm


@pytest.fixture(scope="module")
def tiny():
    jm, v, pm = pair()
    cfg = Cfg(ModelConfig(**TINY), AudioConfig(**AUDIO), DataConfig())
    return jm, v, pm, cfg, AudioProcessor(cfg.audio, "cpu")


@pytest.fixture(scope="module")
def served(tiny, tmp_path_factory):
    """The tiny model exported at (B=4, T=16): (directory, manifest, its
    ExportedSynthesizer, the unexported program)."""
    _, _, pm, cfg, ap = tiny
    out = str(tmp_path_factory.mktemp("exported"))
    manifest = export_serving(pm, cfg, ap, out, batch_sizes=(4,), text_buckets=(16,))
    return out, manifest, ExportedSynthesizer(out), make_serving_fn(pm, cfg, ap)


def batch(B=4, T=16, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, N_MELS + 10, (B, T)).astype(np.int64)
    lens = np.asarray(lens if lens is not None else [T - 3 * i for i in range(B)], np.int64)
    for i, n in enumerate(lens):
        text[i, n:] = 0
    return text, lens


def run(program, *args, seed=0):
    with torch.no_grad():
        return program(*(torch.as_tensor(a) for a in args), torch.tensor([seed]))


def jax_inference(jm, v, text, lens, **kw):
    """The JAX model's float32 inference (its scan), jitted."""
    return jax.jit(lambda t, n, kw: jm.inference(v, t, n, use_pallas=False, **kw))(
        jnp.asarray(text, jnp.int32), jnp.asarray(lens, jnp.int32), kw)


def jax_fill(ap):
    return np.float32(-ap.cfg.max_norm if ap.cfg.symmetric_norm else 0.0)


def jax_masked(spec, lengths, fill):
    keep = np.arange(spec.shape[1])[None, :, None] < np.asarray(lengths)[:, None, None]
    return np.where(keep, np.asarray(spec), fill)


# ---------------------------------------------------------------- the artifact

def test_artifact_equals_its_unexported_program(served):
    out, manifest, exp, program = served
    assert manifest["entries"] == [{"file": "serve_b4_t16.pt2", "batch": 4, "text_bucket": 16}]
    assert manifest["platforms"] == ["cpu"] and manifest["seed"] == "int64 [1]"
    assert manifest["torch_version"] == torch.__version__
    text, lens = batch()
    for seed in (0, 3):
        wav, ml = exp(text, lens, seed=seed)
        ref_wav, ref_ml = run(program, text, lens, seed=seed)
        np.testing.assert_array_equal(ml, ref_ml.numpy())
        assert wav.shape == (4, 64 * (10 * 2 - 1))
        np.testing.assert_allclose(wav, ref_wav.numpy(), atol=1e-6)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0
    graph = str(torch.export.load(os.path.join(out, "serve_b4_t16.pt2")).graph)
    assert "yvt.taco2_decode" in graph and "yvt.griffin_lim" in graph


def test_spectrogram_stage_matches_jax(tiny):
    """The masked spectrogram against the JAX model and the JAX artifact's
    tail fill; lengths exact."""
    jm, v, pm, cfg, ap = tiny
    program = make_serving_fn(pm, cfg, ap, decode_dtype=torch.float32)
    text, lens = batch(seed=1)
    with torch.no_grad():
        spec, ml = program.spectrogram(torch.from_numpy(text), torch.from_numpy(lens),
                                       torch.tensor([0]))
    ref = jax_inference(jm, v, text, lens)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ref["mel_lengths"]))
    np.testing.assert_allclose(spec.numpy(), jax_masked(ref["postnet_outputs"],
                                                        ref["mel_lengths"], jax_fill(ap)),
                               atol=1e-4)


def test_waveform_stage_matches_jax(tiny, monkeypatch):
    """GriffinLimStage against `dsp.inv_melspectrogram_batch` on the Pallas
    whole-loop route (interpret mode), the phase the seed draws injected as
    the JAX package's shared phase."""
    _, _, _, cfg, ap = tiny
    rng = np.random.default_rng(4)
    spec = rng.uniform(-4, 0, (2, 20, N_MELS)).astype(np.float32)
    spec[1, 14:] = -cfg.audio.max_norm
    seed = torch.tensor([5])
    with torch.no_grad():
        got = GriffinLimStage(ap, "mel")(torch.from_numpy(spec), seed).numpy()
    phase = prng.gl_phase(20, 129, seed).numpy()
    monkeypatch.setattr(jdsp.jax.random, "uniform", lambda *a, **k: jnp.asarray(phase))
    jap, a = JaxAP(JaxAudioConfig(**AUDIO)), cfg.audio
    inv = jax.jit(functools.partial(
        jdsp.inv_melspectrogram_batch, mel_inv_basis=jnp.asarray(jap.inv_mel_basis),
        window=jnp.asarray(jap.window), n_fft=256, hop=64, preemph=a.preemphasis,
        ref_level_db=a.ref_level_db, min_level_db=a.min_level_db, spec_gain=a.spec_gain,
        max_norm=a.max_norm, symmetric=a.symmetric_norm, clip=a.clip_norm, power=a.power,
        gl_iters=a.griffin_lim_iters, gl_momentum=a.griffin_lim_momentum, use_pallas=True,
        batch_invariant=True))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(inv(jnp.asarray(spec), jax.random.PRNGKey(0)))
    assert got.shape == ref.shape == (2, 64 * 19)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=2e-2 * np.abs(r).max())


def test_melgan_artifact_matches_jax(tiny, tmp_path):
    """A MelGAN generator in place of Griffin-Lim: the artifact, its
    unexported program and the JAX make_serving_fn(vocoder=...) agree on
    the whole wav (frames x the upsampling product)."""
    from your_voice_tts_tpu.vocoder.config import MelganConfig as JaxMelganConfig
    from your_voice_tts_tpu.vocoder.config import VocoderConfig as JaxVocoderConfig
    from your_voice_tts_tpu.vocoder.synthesizer import VocoderSynthesizer as JaxVocoder
    from your_voice_tts_torch.vocoder.config import MelganConfig, VocoderConfig
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    jm, v, pm, cfg, ap = tiny
    mg = dict(upsample_factors=(4, 4, 4), base_channels=8, num_res_blocks=1, num_scales=1,
              disc_base_channels=4)
    vaudio = dict(AUDIO, do_trim_silence=False)
    jvoc = JaxVocoder(JaxVocoderConfig(model="melgan", audio=JaxAudioConfig(**vaudio),
                                       melgan=JaxMelganConfig(**mg)), None)
    voc = VocoderSynthesizer(VocoderConfig(model="melgan", audio=AudioConfig(**vaudio),
                                           melgan=MelganConfig(**mg)), device="cpu")
    voc.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jvoc.params),
                                              {}, jax_layouts(voc.model)), strict=True)
    out = str(tmp_path / "melgan")
    manifest = export_serving(pm, cfg, ap, out, batch_sizes=(2,), text_buckets=(16,),
                              vocoder=voc, decode_dtype=torch.float32)
    assert manifest["waveform"] == "melgan" and manifest["samples_per_frame"] == 64
    text, lens = batch(B=2, seed=2, lens=[16, 10])
    wav, ml = ExportedSynthesizer(out)(text, lens, seed=0)
    ref_wav, _ = run(make_serving_fn(pm, cfg, ap, vocoder=voc, decode_dtype=torch.float32),
                     text, lens)
    np.testing.assert_allclose(wav, ref_wav.numpy(), atol=1e-6)
    jcfg = Cfg(JaxModelConfig(**TINY), JaxAudioConfig(**AUDIO))
    live = jexport.make_serving_fn(jm, v, jcfg, JaxAP(jcfg.audio), vocoder=jvoc)
    jwav, jml = jax.jit(live)(jnp.asarray(text, jnp.int32), jnp.asarray(lens, jnp.int32),
                              jax.random.PRNGKey(0))
    assert wav.shape == np.asarray(jwav).shape == (2, 10 * 2 * 64)
    np.testing.assert_array_equal(ml, np.asarray(jml))
    np.testing.assert_allclose(wav, np.asarray(jwav), atol=1e-5)


def test_tacotron1_linear_head(tmp_path):
    """Tacotron(1) exports with its linear head inverted without the mel
    pseudo-inverse through its own decode op: the traced spectrogram
    equals the live `inference`'s (held against the JAX kernel route in
    test_torch_tacotron.py) with the tail masked, and the artifact its
    unexported program."""
    from your_voice_tts_torch.models.tacotron import Tacotron

    kw = dict(model="Tacotron", r=2, memory_size=5, max_decoder_steps=4, attention_dim=24,
              attention_location_filters=8, attention_location_kernel_size=15,
              tacotron_width=32, prenet_dropout=False)
    pm = Tacotron(CHARS, ModelConfig(**kw), n_mels=N_MELS, num_freq=129, device="cpu", seed=1)
    cfg = Cfg(ModelConfig(**kw), AudioConfig(**AUDIO), DataConfig())
    ap = AudioProcessor(cfg.audio, "cpu")
    text, lens = batch(B=2, seed=3, lens=[16, 11])
    program = make_serving_fn(pm, cfg, ap)
    with torch.no_grad():
        spec, ml = program.spectrogram(torch.from_numpy(text), torch.from_numpy(lens),
                                       torch.tensor([0]))
        live = pm.inference(text, lens)
    np.testing.assert_array_equal(ml.numpy(), live["mel_lengths"].numpy())
    assert spec.shape == (2, 8, 129)
    np.testing.assert_array_equal(spec.numpy(), jax_masked(live["postnet_outputs"],
                                                           live["mel_lengths"], jax_fill(ap)))
    out = str(tmp_path / "taco1")
    export_serving(pm, cfg, ap, out, batch_sizes=(2,), text_buckets=(16,))
    graph = str(torch.export.load(os.path.join(out, "serve_b2_t16.pt2")).graph)
    assert "yvt.taco1_decode" in graph and "yvt.griffin_lim" in graph
    wav, got_ml = ExportedSynthesizer(out)(text, lens, seed=1)
    ref_wav, ref_ml = run(program, text, lens, seed=1)
    np.testing.assert_array_equal(got_ml, ref_ml.numpy())
    np.testing.assert_allclose(wav, ref_wav.numpy(), atol=1e-6)


# -------------------------------------------------- speakers and style as inputs

@pytest.fixture(scope="module")
def cloning(tmp_path_factory):
    """A d-vector (8-wide) + GST Tacotron2 in both packages, the port's
    exported at B = 4 with a two-speaker table in the manifest."""
    jm, v, pm = pair(seed=1, num_speakers=4, speaker_embedding_dim=8, use_gst=True)
    cfg = Cfg(ModelConfig(**TINY), AudioConfig(**AUDIO), DataConfig())
    ap = AudioProcessor(cfg.audio, "cpu")
    rng = np.random.default_rng(4)
    table = {f"spk{i}": rng.standard_normal(8).tolist() for i in range(2)}
    out = str(tmp_path_factory.mktemp("cloning"))
    manifest = export_serving(pm, cfg, ap, out, batch_sizes=(4,), text_buckets=(16,),
                              speaker_mode="dvector", d_dim=8, speakers=table, style_frames=8)
    return jm, v, pm, cfg, ap, table, manifest, ExportedSynthesizer(out)


def test_dvector_and_style_inputs(cloning):
    """The conditioned spectrogram stage against the JAX model (float32
    decode, its scan); the artifact against its unexported program; the
    d-vector and the style each reach the audio; a short style reference
    tiles into the exported window."""
    jm, v, pm, cfg, ap, table, manifest, exp = cloning
    assert manifest["speaker_input"] == {"kind": "dvector", "dim": 8}
    assert manifest["style_input"] == {"frames": 8, "num_mels": N_MELS}
    rng = np.random.default_rng(7)
    text, lens = batch(seed=5)
    dv = rng.standard_normal((4, 8)).astype(np.float32)
    sty = rng.standard_normal((4, 8, N_MELS)).astype(np.float32)
    f32 = make_serving_fn(pm, cfg, ap, speaker_mode="dvector", style_frames=8,
                          decode_dtype=torch.float32)
    with torch.no_grad():
        spec, ml = f32.spectrogram(*(torch.from_numpy(a) for a in (text, lens, dv, sty)),
                                   torch.tensor([0]))
    ref = jax_inference(jm, v, text, lens, speaker_embeddings=jnp.asarray(dv),
                        style_mel=jnp.asarray(sty))
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ref["mel_lengths"]))
    np.testing.assert_allclose(spec.numpy(), jax_masked(ref["postnet_outputs"],
                                                        ref["mel_lengths"], jax_fill(ap)),
                               atol=1e-4)
    wav, got_ml = exp(text, lens, seed=0, d_vectors=dv, style_mel=sty)
    ref_wav, ref_ml = run(make_serving_fn(pm, cfg, ap, speaker_mode="dvector", style_frames=8),
                          text, lens, dv, sty)
    np.testing.assert_array_equal(got_ml, ref_ml.numpy())
    np.testing.assert_allclose(wav, ref_wav.numpy(), atol=1e-6)
    other_dv, _ = exp(text, lens, seed=0, d_vectors=dv[::-1].copy(), style_mel=sty)
    other_sty, _ = exp(text, lens, seed=0, d_vectors=dv, style_mel=sty[::-1].copy())
    assert np.abs(other_dv[0] - wav[0]).max() > 1e-6 and np.abs(other_sty[0] - wav[0]).max() > 1e-6
    short, _ = exp(text[:1], lens[:1], d_vectors=dv[:1], style_mel=sty[:1, :3])
    tiled, _ = exp(text[:1], lens[:1], d_vectors=dv[:1],
                   style_mel=np.tile(sty[:1, :3], (1, 3, 1))[:, :8])
    np.testing.assert_array_equal(short, tiled)
    with pytest.raises(ValueError, match="expects d_vectors"):
        exp(text, lens, style_mel=sty)
    with pytest.raises(ValueError, match="expects style_mel"):
        exp(text, lens, d_vectors=dv)


def test_tts_many_matches_single_calls(cloning):
    """tts_many: per-row speakers in one program call; a request's audio does
    not depend on its batchmates (at the same row: the same bits; alone, at
    row 0, within the JAX test's spectral bound); speaker errors come per
    request; the neutral all-zero style serves a GST artifact without a
    reference."""
    *_, table, _, exp = cloning
    texts, speakers = ["hello there", "ab", "a longer line"], ["spk0", "spk1", "spk0"]
    wavs = exp.tts_many(texts, speakers)
    other = exp.tts_many([texts[0], "other words", "x"], ["spk0", "spk1", "spk1"])
    np.testing.assert_array_equal(wavs[0], other[0])
    for text, spk, wav in zip(texts, speakers, wavs):
        solo = exp.tts_many([text], [spk])[0]
        assert wav.shape == solo.shape
        assert np.linalg.norm(wav - solo) / max(np.linalg.norm(solo), 1e-6) < 0.2
    a, b = exp.tts_many(["ab", "ab"], ["spk0", "spk1"])
    assert a.shape != b.shape or np.abs(a - b).max() > 1e-6
    with pytest.raises(ValueError, match="unknown speaker"):
        exp._resolve_speaker("nope")
    with pytest.raises(ValueError, match="d-vector of dim 8"):
        exp._resolve_speaker([0.0] * 3)
    with pytest.raises(ValueError, match="speakers"):
        exp.tts_many(texts, ["spk0"])
    np.testing.assert_array_equal(exp.tts_many(["ab"], [table["spk1"]])[0],
                                  exp.tts_many(["ab"], ["spk1"])[0])
    assert exp.tts_to_wav_bytes("hello", speaker="spk1")[:4] == b"RIFF"


def test_speaker_table_input(tmp_path):
    """A speaker-table model exports with an id input: the spectrogram stage
    against the live float32 `inference` (held against the JAX package in
    test_torch_speakers.py; 1e-4: the unpacked BiLSTM sums in another
    order), the artifact against its unexported program, names and numeric
    strings resolved."""
    pm = Tacotron2(CHARS, ModelConfig(**TINY), n_mels=N_MELS, device="cpu", num_speakers=3,
                   seed=2)
    cfg = Cfg(ModelConfig(**TINY), AudioConfig(**AUDIO), DataConfig())
    ap = AudioProcessor(cfg.audio, "cpu")
    text, lens = batch(B=2, seed=6, lens=[16, 12])
    ids = np.array([2, 0], np.int64)
    f32 = make_serving_fn(pm, cfg, ap, speaker_mode="id", decode_dtype=torch.float32)
    with torch.no_grad():
        spec, ml = f32.spectrogram(*(torch.from_numpy(a) for a in (text, lens, ids)),
                                   torch.tensor([0]))
        ref = pm.inference(text, lens, decode_dtype=torch.float32, speaker_ids=ids)
    np.testing.assert_array_equal(ml.numpy(), ref["mel_lengths"].numpy())
    np.testing.assert_allclose(spec.numpy(), jax_masked(ref["postnet_outputs"],
                                                        ref["mel_lengths"], jax_fill(ap)),
                               atol=1e-4)
    out = str(tmp_path / "ids")
    manifest = export_serving(pm, cfg, ap, out, batch_sizes=(2,), text_buckets=(16,),
                              speaker_mode="id", speakers={"a": 0, "b": 2})
    assert manifest["speaker_input"] == {"kind": "id", "dim": None}
    exp = ExportedSynthesizer(out)
    wav, got_ml = exp(text, lens, speaker_ids=ids)
    ref_wav, ref_ml = run(make_serving_fn(pm, cfg, ap, speaker_mode="id"), text, lens, ids)
    np.testing.assert_array_equal(got_ml, ref_ml.numpy())
    np.testing.assert_allclose(wav, ref_wav.numpy(), atol=1e-6)
    assert exp._resolve_speaker("b") == 2 and exp._resolve_speaker("1") == 1
    assert exp._resolve_speaker(None) == 0
    with pytest.raises(ValueError, match="unknown speaker"):
        exp._resolve_speaker("zed")


def test_export_refusals_follow_jax(tiny, tmp_path):
    """The JAX export's refusals: an unknown speaker_mode, d-vectors without
    d_dim, a vocoder on a linear head, WaveRNN. As in the JAX export, an
    unconditioned model given speaker_mode "id" builds, its speaker input
    unread; a single-voice artifact refuses a speaker."""
    _, _, pm, cfg, ap = tiny
    with pytest.raises(ValueError, match="unknown speaker_mode 'bogus'"):
        export_serving(pm, cfg, ap, str(tmp_path / "x"), speaker_mode="bogus")
    with pytest.raises(ValueError, match="speaker_mode='dvector' needs d_dim"):
        export_serving(pm, cfg, ap, str(tmp_path / "x"), speaker_mode="dvector")
    assert not (tmp_path / "x").exists()
    text, lens = batch(B=2, seed=8, lens=[16, 9])
    program = make_serving_fn(pm, cfg, ap, speaker_mode="id")
    a = run(program, text, lens, np.array([0, 1]))
    b = run(program, text, lens, np.array([1, 0]))
    assert torch.equal(a[0], b[0])

    class Voc:
        class cfg:
            model = "wavernn"
    with pytest.raises(NotImplementedError, match="melgan/pwgan"):
        make_serving_fn(pm, cfg, ap, vocoder=Voc())


def test_bucket_padding_and_chunking(served):
    """A smaller request pads into the exported shape; a batch past the
    largest exported one runs in chunks of it (row 4 sits at position 0 of
    the second chunk, so it equals a solo call); a text past every bucket
    raises."""
    exp = served[2]
    text, lens = batch(B=1, T=9, seed=9, lens=[9])
    wav, ml = exp(text, lens)
    assert wav.shape[0] == 1 and ml.shape == (1,)
    text6, lens6 = batch(B=6, seed=10, lens=[16, 14, 12, 10, 8, 6])
    wav6, ml6 = exp(text6, lens6)
    assert wav6.shape[0] == 6 and ml6.shape == (6,)
    solo, ml_solo = exp(text6[4:5], lens6[4:5])
    assert ml6[4] == ml_solo[0]
    np.testing.assert_allclose(wav6[4], solo[0], atol=1e-6)
    with pytest.raises(ValueError, match="no exported shape fits"):
        exp(np.zeros((1, 32), np.int64), np.full((1,), 32, np.int64))
    with pytest.raises(ValueError, match="takes no speaker input"):
        exp(text, lens, speaker_ids=[0])
    with pytest.raises(ValueError, match="closes over one voice"):
        exp._resolve_speaker("someone")


def test_speaker_encoder_artifact_matches_live(tmp_path):
    """The exported GE2E encoder against `compute_embedding` on the tile
    path and the sliding-window path (five windows, chunked through B=2)."""
    from your_voice_tts_torch.speaker_encoder.model import SpeakerEncoder

    enc = SpeakerEncoder(input_dim=N_MELS, proj_dim=16, lstm_dim=24, num_layers=2,
                         device="cpu", seed=3)
    out = str(tmp_path / "se")
    manifest = export_speaker_encoder(enc, out, input_dim=N_MELS, batch_sizes=(2,),
                                      num_frames=12)
    assert manifest["proj_dim"] == 16 and manifest["platforms"] == ["cpu"]
    served = ExportedSpeakerEncoder(out)
    rng = np.random.default_rng(6)
    for T in (7, 40):
        mel = rng.standard_normal((T, N_MELS)).astype(np.float32)
        live = enc.compute_embedding(mel, num_frames=12).numpy()
        got = served.embed(mel)
        np.testing.assert_allclose(got, live, atol=1e-5)
        assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-4


def test_server_serves_an_artifact_directory(served):
    """make_server on an ExportedSynthesizer: /api/tts answers a WAV cut to
    the row's frames, stream=1 answers 400 (an artifact has no streaming),
    and text past the exported symbol table raises."""
    import wave as wavemod

    from your_voice_tts_torch.infer.server import make_server

    _, manifest, exp, _ = served
    srv = make_server(exp, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}/api/tts?text="
    try:
        with urllib.request.urlopen(base + "hello%20artifact") as r:
            assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
            blob = r.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "hi&stream=1")
        assert e.value.code == 400 and b"cannot stream" in e.value.read()
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
    import io
    with wavemod.open(io.BytesIO(blob), "rb") as f:
        assert f.getframerate() == 8000
        assert 0 < f.getnframes() <= 10 * 2 * 64
    small = ExportedSynthesizer.__new__(ExportedSynthesizer)
    small.manifest = dict(manifest, num_chars=5)
    with pytest.raises(ValueError, match="different symbol table"):
        small.text_to_ids("hello artifact")


# ------------------------------------------------------- the pieces underneath

def test_bilstm_unpacked_equals_bilstm():
    """The traced route's BiLSTM (each row reversed within its length by one
    gather) against the packed one, 1e-6, zero at the pads."""
    from your_voice_tts_torch.nn.rnn import bilstm, bilstm_unpacked

    torch.manual_seed(0)
    lstm = torch.nn.LSTM(12, 8, batch_first=True, bidirectional=True)
    lens = torch.tensor([9, 5, 1, 7])
    x = torch.randn(4, 9, 12) * (torch.arange(9)[None] < lens[:, None])[..., None]
    with torch.no_grad():
        got, ref = bilstm_unpacked(lstm, x, lens), bilstm(lstm, x, lens)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    assert not got[1, 5:].any()


def test_seed_tensor_draws():
    """The draws a traced program makes from its seed tensor: the key and a
    uniform draw on it bit for bit as the JAX package's hash
    (`ops/pallas/wavernn_gen.py` `_fmix32`, `_uniform`); the same seed gives
    the same bits run to run, another seed others; normal draws are
    standard normal."""
    from your_voice_tts_tpu.ops.pallas.wavernn_gen import _fmix32, _uniform

    for s, step in ((0, 0), (7, 3), (2 ** 31 - 1, 49)):
        ref = _fmix32(jnp.int32(s) + jnp.int32(step) * np.int32(-1640531527))
        key = prng.seed_key(torch.tensor([s]), step)
        assert int(key[0]) == int(np.asarray(ref).view(np.uint32))
        np.testing.assert_array_equal(prng.uniform((4, 40), key, 31).numpy(),
                                      np.asarray(_uniform((4, 40), ref, 31)))
    a, b, c = (prng.gl_phase(40, 129, torch.tensor([s])) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) > 0 and float(a.max()) < 2 * np.pi
    n1, n2, n3 = (prng.normal((64, 512), prng.seed_key(torch.tensor([s])), prng.NOISE_SALTS)
                  for s in (4, 4, 5))
    assert torch.equal(n1, n2) and not torch.equal(n1, n3)
    assert abs(float(n1.mean())) < 0.02 and abs(float(n1.std()) - 1.0) < 0.02
    d1, d2 = prng.HashDraws(torch.tensor([3])), prng.HashDraws(torch.tensor([3]))
    first = d1.rand((5, 6))
    assert torch.equal(first, d2.rand((5, 6))) and not torch.equal(first, d1.rand((5, 6)))


def test_prenet_dropout_keys_on_the_seed(tiny):
    """With the prenet's dropout on, the program's seed keys it: the same
    seed, the same spectrogram; another seed, another; and the same masks
    as the live route's `seed` (the decode's hash PRNG)."""
    _, _, pm, cfg, ap = tiny
    model = Tacotron2(CHARS, dataclasses.replace(cfg.model, prenet_dropout=True),
                      n_mels=N_MELS, device="cpu", seed=4)
    program = make_serving_fn(model, Cfg(model.cfg, cfg.audio), ap, decode_dtype=torch.float32)
    text, lens = batch(B=2, seed=11, lens=[16, 12])
    with torch.no_grad():
        s1, s1b, s2 = (program.spectrogram(torch.from_numpy(text), torch.from_numpy(lens),
                                           torch.tensor([s]))[0] for s in (1, 1, 2))
        live = model.inference(text, lens, seed=1, decode_dtype=torch.float32)
    assert torch.equal(s1, s1b) and not torch.equal(s1, s2)
    n = int(live["mel_lengths"][1])
    # float32: test_torch_synthesis.py's 1e-4 (the unpacked BiLSTM sums in
    # another order)
    torch.testing.assert_close(s1[1, :n], live["postnet_outputs"][1, :n], atol=1e-4, rtol=0)
