"""The port's speaker conditioning and cloning path against the JAX package
on the CPU: speakers.json parsing, the GE2E speaker encoder (both
recurrences, both window paths of compute_embedding, the trained smoke
encoder), Tacotron2 conditioned on its own speaker table and on d-vectors,
the Synthesizer's speaker resolution, the trained multi-speaker asset, and
bin/compute_embeddings. Numpy inputs from seeds on both sides; float32 and
prenet dropout off wherever outputs are compared (the two packages draw
dropout from different generators), so they differ by sum order only.
"""

import dataclasses
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.infer.synthesizer import Synthesizer as JaxSynthesizer
from your_voice_tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from your_voice_tts_tpu.speaker_encoder.model import SpeakerEncoder as JaxSpeakerEncoder
from your_voice_tts_tpu.speaker_encoder.model import load_encoder as jax_load_encoder
from your_voice_tts_tpu.utils.speakers import parse_speakers as jax_parse_speakers
from your_voice_tts_torch.config import ModelConfig, load_config
from your_voice_tts_torch.infer.synthesizer import Synthesizer
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.speaker_encoder.model import (SpeakerEncoder, arch_from_checkpoint,
                                                        load_encoder)
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax
from your_voice_tts_torch.utils.speakers import (load_speaker_mapping, parse_speakers,
                                                 save_speaker_mapping)

torch.set_num_threads(1)

SMOKE = "configs/smoke_synthetic.json"
SE_CKPT, SPK_JSON = "assets/speaker_encoder_smoke.npz", "assets/speakers_smoke.json"
MULTI_CKPT = "assets/bench_trained_multispeaker.npz"


# ------------------------------------------------------------ speakers.json

def test_parse_speakers_id_mode(tmp_path):
    mapping = {"alice": 0, "bob": 1, "carol": 2}
    save_speaker_mapping(str(tmp_path), mapping)
    loaded = load_speaker_mapping(str(tmp_path))
    assert loaded == mapping
    assert parse_speakers(loaded) == jax_parse_speakers(loaded) == (mapping, None)
    assert parse_speakers({}) == ({}, None)


def test_parse_speakers_dvector_mode():
    """Clips averaged per speaker (dict clips and bare lists), ids in sorted
    name order; the asset file as well."""
    rng = np.random.default_rng(0)
    mapping = {"zed": {"a": {"embedding": rng.standard_normal(5).tolist()},
                       "b": rng.standard_normal(5).tolist()},
               "amy": rng.standard_normal(5).tolist()}
    for m in (mapping, load_speaker_mapping(SPK_JSON)):
        ids, embs = parse_speakers(m)
        ref_ids, ref_embs = jax_parse_speakers(m)
        assert ids == ref_ids and sorted(embs) == sorted(ref_embs)
        for name in embs:
            assert embs[name].dtype == np.float32
            np.testing.assert_array_equal(embs[name], ref_embs[name])
    assert parse_speakers(mapping)[0] == {"amy": 0, "zed": 1}


# ------------------------------------------------------------ speaker encoder

def encoder_pair(recur_on_proj, seed=0):
    """(JAX encoder, its params, the port's with the same weights): 20 mels,
    LSTMs of 32 projected to 16, 2 layers."""
    jm = JaxSpeakerEncoder(input_dim=20, proj_dim=16, lstm_dim=32, num_layers=2,
                           recur_on_proj=recur_on_proj)
    params = jm.init(jax.random.PRNGKey(seed))
    port = SpeakerEncoder(input_dim=20, proj_dim=16, lstm_dim=32, num_layers=2,
                          recur_on_proj=recur_on_proj, device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    port.load_state_dict(params_from_jax(np_params, {}, jax_layouts(port)), strict=True)
    return jm, params, port


@pytest.mark.parametrize("recur_on_proj", [True, False])
def test_speaker_encoder_matches_jax(recur_on_proj):
    jm, params, port = encoder_pair(recur_on_proj)
    mels = np.random.default_rng(1).standard_normal((3, 17, 20)).astype(np.float32)
    ref = np.asarray(jm(params, jnp.asarray(mels)))
    with torch.no_grad():
        got = port(torch.from_numpy(mels)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("recur_on_proj", [True, False])
@pytest.mark.parametrize("T", [7, 40, 95])
def test_compute_embedding_matches_jax(recur_on_proj, T):
    """T 7 and 40: the mel tiled to 40 frames; T 95: windows of 40 at a hop
    of 20, averaged and re-normalized."""
    jm, params, port = encoder_pair(recur_on_proj, seed=2)
    mel = np.random.default_rng(T).standard_normal((T, 20)).astype(np.float32)
    ref = np.asarray(jm.compute_embedding(params, jnp.asarray(mel), num_frames=40))
    got = port.compute_embedding(mel, num_frames=40).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_lstm_recurring_on_projection_needs_a_narrower_projection():
    with pytest.raises(ValueError, match="proj < hidden"):
        SpeakerEncoder(input_dim=20, proj_dim=32, lstm_dim=32, device="cpu")


def test_trained_encoder_asset_loads_strictly():
    """The trained smoke encoder: its architecture from the parameter shapes
    (20 mels, 2 layers of 128 projected to 64, recurring on the
    projection), loaded strictly, embeds as the JAX package's."""
    arch = arch_from_checkpoint(SE_CKPT)
    assert arch == {"input_dim": 20, "proj_dim": 64, "lstm_dim": 128, "num_layers": 2,
                    "recur_on_proj": True}
    port = load_encoder(SE_CKPT, device="cpu")
    jm, params = jax_load_encoder(SE_CKPT)
    mel = np.random.default_rng(4).standard_normal((60, 20)).astype(np.float32)
    ref = np.asarray(jm.compute_embedding(params, jnp.asarray(mel), num_frames=40))
    np.testing.assert_allclose(port.compute_embedding(mel, num_frames=40).numpy(), ref,
                               atol=1e-5)


# ------------------------------------------------------------ conditioned Tacotron2

N_MELS, CHARS, B, T = 20, 30, 3, 11
SMALL = dict(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
             attention_rnn_dim=48, attention_dim=24, attention_location_filters=8,
             attention_location_kernel_size=15, prenet_dim=24, postnet_dim=32,
             max_decoder_steps=12, prenet_dropout=False)


@pytest.mark.parametrize("spk_dim", [0, 8])
def test_conditioned_inference_matches_jax(spk_dim):
    """4 speakers: spk_dim 0 is the model's own table (512 wide, E = 544
    at the decode), 8 is external d-vectors (E = 40). Float32 decode,
    dropout off: the postnet mel 1e-4, lengths equal, alignments and stops
    up to each row's length (past its stop the scan freezes a row, the
    kernel route keeps it running)."""
    jm = JaxTacotron2(CHARS, JaxModelConfig(**SMALL), n_mels=N_MELS, num_speakers=4,
                      speaker_embedding_dim=spk_dim)
    variables = jm.init(jax.random.PRNGKey(0))
    pm = Tacotron2(CHARS, ModelConfig(**SMALL), n_mels=N_MELS, device="cpu", num_speakers=4,
                   speaker_embedding_dim=spk_dim)
    pm.load_state_dict(params_from_jax(variables["params"], variables["state"]))
    assert pm.decoder.decode_weights(torch.float32)["dims"]["E"] == 32 + (spk_dim or 512)
    rng = np.random.default_rng(spk_dim)
    text = rng.integers(1, CHARS, (B, T))
    lengths = np.array([11, 9, 6])
    kw, ref_kw = {}, {}
    if spk_dim:
        dvec = rng.standard_normal((B, spk_dim)).astype(np.float32)
        dvec /= np.linalg.norm(dvec, axis=-1, keepdims=True)
        kw["speaker_embeddings"], ref_kw["speaker_embeddings"] = dvec, jnp.asarray(dvec)
    else:
        ids = np.array([3, 0, 2])
        kw["speaker_ids"], ref_kw["speaker_ids"] = ids, jnp.asarray(ids, jnp.int32)
    ref = jm.inference(variables, jnp.asarray(text, jnp.int32), jnp.asarray(lengths, jnp.int32),
                       use_pallas=False, **ref_kw)
    got = pm.inference(text, lengths, decode_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(ref["mel_lengths"]))
    np.testing.assert_allclose(got["postnet_outputs"].numpy(),
                               np.asarray(ref["postnet_outputs"]), atol=1e-4)
    for row, n in enumerate(np.asarray(ref["mel_lengths"]) // 2):
        for key in ("alignments", "stop_probs"):
            np.testing.assert_allclose(got[key][row, :n].numpy(),
                                       np.asarray(ref[key])[row, :n], atol=1e-4)
    with pytest.raises(ValueError, match="speaker_embeddings" if spk_dim else "speaker_ids"):
        pm.inference(text, lengths)


@pytest.mark.parametrize("spk_dim", [0, 8])
def test_conditioned_inference_in_bf16(spk_dim):
    """compute_dtype bf16: the table and the d-vectors are cast to bf16 as
    the reference casts them, the memory stays bf16 through the
    concatenation, and the outputs come back float32, near the float32
    route (bf16 rounding of the encoder, key projection and postnet)."""
    from your_voice_tts_torch.models.common import compute_copy

    pm = Tacotron2(CHARS, ModelConfig(**SMALL), n_mels=N_MELS, device="cpu", num_speakers=4,
                   speaker_embedding_dim=spk_dim, seed=3)
    rng = np.random.default_rng(7)
    text, lengths = rng.integers(1, CHARS, (B, T)), np.array([11, 9, 6])
    kw = ({"speaker_embeddings": rng.standard_normal((B, spk_dim)).astype(np.float32)}
          if spk_dim else {"speaker_ids": np.array([3, 0, 2])})
    ref = pm.inference(text, lengths, decode_dtype=torch.float32, **kw)
    got = pm.inference(text, lengths, decode_dtype=torch.float32,
                       compute_dtype=torch.bfloat16, **kw)
    if not spk_dim:
        assert compute_copy(pm, "speaker_embedding", torch.bfloat16).weight.dtype \
            == torch.bfloat16
    assert got["postnet_outputs"].dtype == torch.float32
    err = float((got["postnet_outputs"] - ref["postnet_outputs"]).abs().max())
    assert 0 < err < 0.1, err


# ------------------------------------------------------------ Synthesizer

def smoke_config(**model):
    cfg = load_config(SMOKE)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


@pytest.fixture(scope="module")
def id_mapping(tmp_path_factory):
    path = tmp_path_factory.mktemp("spk") / "speakers.json"
    path.write_text(json.dumps({"alice": 0, "bob": 1, "carol": 2}))
    return str(path)


@pytest.fixture(scope="module")
def resolvers(id_mapping):
    """{mode: (port Synthesizer, JAX Synthesizer)} on an id mapping and on
    the asset's d-vector mapping."""
    return {mode: (Synthesizer(smoke_config(), speakers_json=path, device="cpu"),
                   JaxSynthesizer(jax_load_config(SMOKE), speakers_json=path))
            for mode, path in (("id", id_mapping), ("dvec", SPK_JSON))}


@pytest.mark.parametrize("mode", ["id", "dvec"])
@pytest.mark.parametrize("speaker", [None, "bob", 1, "2", 0, "bob2", 3, -1, "x"])
def test_resolve_speaker_matches_jax(resolvers, mode, speaker):
    """Names, ids, a numeric string meaning an id, out of range, unknown:
    the same resolution and the same messages as the JAX Synthesizer."""
    if mode == "dvec" and speaker in ("bob", "bob2"):
        speaker = "SYN03" if speaker == "bob" else "SYN99"
    port, jax_s = resolvers[mode]
    try:
        ref = jax_s._resolve_speaker(speaker)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port._resolve_speaker(speaker)
        assert str(got.value) == str(e)
        return
    got = port._resolve_speaker(speaker)
    assert got[0] == ref[0]
    if got[0] == "dvec":
        np.testing.assert_array_equal(got[1], ref[1])
    else:
        assert got[1] == ref[1]


def test_synthesizer_builds_the_conditioned_model(id_mapping):
    port = Synthesizer(smoke_config(), speakers_json=id_mapping, device="cpu")
    assert (port.model.num_speakers, port.model.spk_dim) == (3, 512)
    assert port.model.speaker_embedding.weight.shape == (3, 512)
    port = Synthesizer(smoke_config(), speakers_json=SPK_JSON, device="cpu")
    assert (port.model.num_speakers, port.model.spk_dim) == (8, 64)
    assert not hasattr(port.model, "speaker_embedding")


def test_tts_many_groups_rows_by_conditioning_mode(id_mapping, monkeypatch):
    """One synthesis_batch a conditioning mode, the ids in row order, and
    each request's sentences back in order."""
    import your_voice_tts_torch.infer.synthesizer as mod

    port = Synthesizer(smoke_config(max_decoder_steps=4), speakers_json=id_mapping,
                       device="cpu", decode_dtype=torch.float32)
    calls = []
    real = mod.synthesis_batch

    def spy(model, texts, *a, **kw):
        calls.append((texts, kw.get("speaker_ids")))
        return real(model, texts, *a, **kw)

    monkeypatch.setattr(mod, "synthesis_batch", spy)
    wavs = port.tts_many(["Hi. Go now.", "Yes."], ["carol", 1])
    assert len(calls) == 1 and calls[0][0] == ["Hi.", "Go now.", "Yes."]
    assert calls[0][1].tolist() == [2, 2, 1]
    assert len(wavs) == 2 and all(w.ndim == 1 and np.isfinite(w).all() for w in wavs)
    with pytest.raises(ValueError, match="2 texts but 1 speakers"):
        port.tts_many(["a", "b"], [0])


@pytest.fixture(scope="module")
def multi_synths():
    """(JAX, port) Synthesizers on the trained multi-speaker asset with its
    d-vector mapping (8 speakers, 64 wide), dropout off, 64 steps."""
    cfg = dict(prenet_dropout=False, max_decoder_steps=64)
    jax_cfg = jax_load_config(SMOKE)
    jax_cfg = dataclasses.replace(jax_cfg, model=dataclasses.replace(jax_cfg.model, **cfg))
    jax_s = JaxSynthesizer(jax_cfg, MULTI_CKPT, speakers_json=SPK_JSON)
    port = Synthesizer(smoke_config(**cfg), MULTI_CKPT, speakers_json=SPK_JSON, device="cpu",
                       decode_dtype=torch.float32)
    return jax_s, port


def test_trained_multispeaker_mel_matches_jax(multi_synths):
    """One speaker, one sentence through the trained asset: the postnet mel
    1e-4 and the same length."""
    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq

    jax_s, port = multi_synths
    _, dvec = port._resolve_speaker("SYN05")
    text, lengths = _pad_texts([text_to_seq("the quick brown fox jumps over a lazy dog.",
                                            port.cfg)])
    ref = jax_s.model.inference(jax_s.variables, jnp.asarray(text, jnp.int32),
                                jnp.asarray(lengths, jnp.int32), use_pallas=False,
                                speaker_embeddings=jnp.asarray(dvec)[None])
    got = port.model.inference(text, lengths, decode_dtype=torch.float32,
                               speaker_embeddings=dvec[None])
    n = int(ref["mel_lengths"][0])
    assert int(got["mel_lengths"][0]) == n
    np.testing.assert_allclose(got["postnet_outputs"].numpy(),
                               np.asarray(ref["postnet_outputs"]), atol=1e-4)


def test_trained_multispeaker_tts(multi_synths):
    _, port = multi_synths
    wav = port.tts("Hi there.", speaker="SYN02")
    assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()


# ------------------------------------------------------------ bin/compute_embeddings

def test_compute_embeddings_matches_jax(tmp_path):
    """Both CLIs on one synthetic corpus (2 speakers, 4 clips) with the
    trained smoke encoder at 40 frames: the same speakers and clips, each
    embedding within 1e-5."""
    from your_voice_tts_tpu.bin.compute_embeddings import main as jax_main
    from your_voice_tts_torch.bin.compute_embeddings import main
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=4, sr=8000,
                                   n_speakers=2, seed=3)
    assert len(glob.glob(f"{corpus}/wavs/*.wav")) == 4
    args = ["--checkpoint", SE_CKPT, "--config", SMOKE, "--data_path", corpus,
            "--formatter", "synthetic", "--num_frames", "40"]
    jax_main(args + ["--output", str(tmp_path / "jax.json")])
    main(args + ["--output", str(tmp_path / "port.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert sorted(got) == sorted(ref) == ["SYN00", "SYN01"]
    for spk in ref:
        assert sorted(got[spk]) == sorted(ref[spk])
        for clip in ref[spk]:
            assert list(got[spk][clip]) == ["embedding"]
            np.testing.assert_allclose(got[spk][clip]["embedding"], ref[spk][clip]["embedding"],
                                       atol=1e-5)


def test_cli_clones_a_speaker(tmp_path):
    """bin/synthesize with --speakers_json / --speaker_id on the trained
    multi-speaker asset writes a wav; an unknown speaker raises."""
    import wave

    from your_voice_tts_torch.bin.synthesize import main

    args = ["Hi there.", SMOKE, MULTI_CKPT, str(tmp_path), "--speakers_json", SPK_JSON,
            "--device", "cpu"]
    main(args + ["--speaker_id", "SYN01"])
    with wave.open(str(tmp_path / "out_000.wav")) as f:
        assert f.getframerate() == 8000 and f.getnframes() > 0
    with pytest.raises(ValueError, match="unknown speaker 'nobody'"):
        main(args + ["--speaker_id", "nobody"])
