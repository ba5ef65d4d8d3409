"""The port's phoneme frontend against the JAX package on the CPU: the
phoneme table, the ids of every G2P backend (rules, CMUDict, the lookup of
precomputed phonemizations, espeak through a fake binary), the default
chain and its pin, the dataset's phoneme disk cache, one training step on
phonemes and the Synthesizer that pins its backend back, and a phoneme
config's `synthesis_batch` at the smoke width.

Ids are compared exactly; the synthesis in float32 with prenet dropout off
and the stopnet bias at -10 (every row decodes all its steps), within
1e-3, as the Tacotron(1) synthesis test holds its linear outputs.
"""

import dataclasses
import importlib
import logging
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import your_voice_tts_tpu.text as jax_text
import your_voice_tts_torch.text as text
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.infer.synthesis import synthesis_batch as jax_synthesis_batch
from your_voice_tts_tpu.infer.synthesizer import Synthesizer as JaxSynthesizer
from your_voice_tts_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.data import TTSDataset, load_meta_data
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.infer import synthesis
from your_voice_tts_torch.infer.synthesizer import Synthesizer
from your_voice_tts_torch.text import cmudict

torch.set_num_threads(1)

# the text packages export a `symbols` list that hides the module
symbols = importlib.import_module("your_voice_tts_torch.text.symbols")
jax_symbols = importlib.import_module("your_voice_tts_tpu.text.symbols")
jax_cmudict = importlib.import_module("your_voice_tts_tpu.text.cmudict")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")
SENTENCES = [
    "It's the dog's bone, isn't it? They'll say \"no\"!",
    "In 1984 the 3 quick brown foxes jumped over 2.5 lazy dogs; then they rested.",
    "Zyxwv and qorblat are not words, but happily the cities' mayors stopped talking.",
    "'Quoted' words, (brackets) - dashes: and colons.",
    "Mr. Smith paid $12 for the books at 10:30 on the 1st of May.",
]


def phoneme_config(loader, **data):
    cfg = loader(SMOKE)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, use_phonemes=True, text_cleaner="phoneme_cleaners", **data))


# ------------------------------------------------------------ tables

def test_phoneme_table_entry_for_entry():
    assert symbols.phonemes == jax_symbols.phonemes
    assert symbols.symbols == jax_symbols.symbols
    assert cmudict.VALID_SYMBOLS == jax_cmudict.VALID_SYMBOLS
    assert symbols.make_symbols("abc", "!?a") == jax_symbols.make_symbols("abc", "!?a")
    assert not hasattr(symbols, "_ARPABET_BASE")         # one copy, in text/cmudict.py


# ------------------------------------------------------------ backends

def backend_pair(kind):
    if kind == "rule":
        return text.RuleG2PBackend(), jax_text.RuleG2PBackend()
    return (text.CMUDictBackend(text.bundled_cmudict_path()),
            jax_text.CMUDictBackend(jax_text.bundled_cmudict_path()))


@pytest.mark.parametrize("eos_bos", [False, True])
@pytest.mark.parametrize("kind", ["rule", "cmudict"])
def test_phoneme_ids_match_jax(kind, eos_bos):
    """Contractions, possessives, out-of-vocabulary words, numbers and
    punctuation: the same ids, and for CMUDict the same word, derived and
    OOV counts."""
    port, ref = backend_pair(kind)
    for s in SENTENCES:
        got = text.phoneme_to_sequence(s, "phoneme_cleaners", enable_eos_bos=eos_bos,
                                       backend=port)
        want = jax_text.phoneme_to_sequence(s, "phoneme_cleaners", enable_eos_bos=eos_bos,
                                            backend=ref)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert text.sequence_to_phoneme(got) == jax_text.sequence_to_phoneme(want)
        np.testing.assert_array_equal(text.pad_with_eos_bos(got, use_phonemes=True),
                                      jax_text.pad_with_eos_bos(want, use_phonemes=True))
    if kind == "cmudict":
        assert (port.word_count, port.derived_count, port.oov_count) == \
            (ref.word_count, ref.derived_count, ref.oov_count)
        assert port.oov_count > 0 and port.derived_count > 0
        assert port.oov_rate == ref.oov_rate


def test_cmudict_lexicon_and_derivation_match_jax():
    path = text.bundled_cmudict_path()
    assert os.path.samefile(path, jax_text.bundled_cmudict_path())
    port, ref = cmudict.CMUDict(path), jax_cmudict.CMUDict(path)
    assert len(port) == len(ref) > 1000
    lines = ["HELLO  HH AH0 L OW1", "HELLO(1)  HH EH0 L OW1", ";;; comment", "BAD  QQ X",
             "READ  R EH1 D", "READ(2)  R IY1 D"]
    for keep in (True, False):
        a, b = cmudict.CMUDict(lines, keep), jax_cmudict.CMUDict(lines, keep)
        assert [a.lookup(w) for w in ("hello", "read", "bad")] == \
            [b.lookup(w) for w in ("hello", "read", "bad")]
    for w in ("books", "dogs", "houses", "wanted", "looked", "played", "jumping", "making",
              "stopping", "slowly", "happily", "smaller", "smallest", "cities", "tried",
              "happiest", "happier", "dog's", "zyxwv"):
        assert cmudict.derive(w, port.lookup) == jax_cmudict.derive(w, ref.lookup), w
    for pron in ("HH AH0 L OW1", "K AE2 T", "ER0"):
        assert cmudict.arpabet_to_ipa(pron) == jax_cmudict.arpabet_to_ipa(pron)


def test_cache_backend(tmp_path):
    mapping = {"hello world": "həlˈoʊ wˈɜːld", "hi": "haɪ"}
    np.save(tmp_path / "a.npy", {"hello world": mapping["hello world"]})
    np.save(tmp_path / "b.npy", {"hi": mapping["hi"]})
    port = text.CacheBackend.from_npy_dir(str(tmp_path))
    ref = jax_text.CacheBackend.from_npy_dir(str(tmp_path))
    assert port.mapping == ref.mapping == mapping
    for s in mapping:
        np.testing.assert_array_equal(
            text.phoneme_to_sequence(s, "basic_cleaners", backend=port),
            jax_text.phoneme_to_sequence(s, "basic_cleaners", backend=ref))
    with pytest.raises(KeyError, match="not in phoneme cache"):
        port.phonemize("missing")


FAKE_IPA = "h_ə_l_ˈoʊ w_ˈɜː_l_d"


@pytest.fixture
def fake_espeak(tmp_path, monkeypatch):
    """An `espeak-ng` at the front of PATH that checks the call's flags
    (-q --ipa=3 -v LANG TEXT), fails on "boom" and prints FAKE_IPA."""
    script = tmp_path / "espeak-ng"
    script.write_text(
        "#!/bin/sh\n"
        "[ \"$1\" = -q ] && [ \"$2\" = --ipa=3 ] && [ \"$3\" = -v ] || exit 64\n"
        "[ -n \"$5\" ] || exit 64\n"
        "case \"$5\" in *boom*) echo 'synthetic failure' >&2; exit 1;; esac\n"
        f"printf '%s\\n' '{FAKE_IPA}'\n")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ.get('PATH', '')}")
    return str(tmp_path)


def test_espeak_backend_through_a_fake_binary(fake_espeak):
    import subprocess

    port, ref = text.EspeakBackend("en-us"), jax_text.EspeakBackend("en-us")
    assert port._bin == os.path.join(fake_espeak, "espeak-ng") == ref._bin
    assert port.phonemize("hello world") == ref.phonemize("hello world") \
        == FAKE_IPA.replace("_", "")
    np.testing.assert_array_equal(
        text.phoneme_to_sequence("hello world", backend=port),
        jax_text.phoneme_to_sequence("hello world", backend=ref))
    with pytest.raises(subprocess.CalledProcessError):
        port.phonemize("boom now")
    assert isinstance(text.default_g2p_backend("en-us"), text.EspeakBackend)
    assert isinstance(text.default_g2p_backend(prefer="EspeakBackend"), text.EspeakBackend)
    # a pinned lexicon wins over the binary
    assert isinstance(text.default_g2p_backend(prefer="CMUDictBackend"), text.CMUDictBackend)


def test_espeak_backend_raises_without_a_binary(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="binary not found"):
        text.EspeakBackend()


def test_default_chain_pin_and_rule_warning(monkeypatch, tmp_path, caplog):
    """Without espeak: the bundled lexicon; a pin builds its backend; a
    pinned espeak that cannot be built and an unknown pin warn and fall
    through; without a lexicon the rules, with the warning."""
    monkeypatch.setenv("PATH", str(tmp_path))
    assert isinstance(text.default_g2p_backend(), text.CMUDictBackend)
    assert isinstance(text.default_g2p_backend(prefer="RuleG2PBackend"), text.RuleG2PBackend)
    with caplog.at_level(logging.WARNING, logger="your_voice_tts_torch.text"):
        assert isinstance(text.default_g2p_backend(prefer="EspeakBackend"),
                          text.CMUDictBackend)
        assert isinstance(text.default_g2p_backend(prefer="NoSuchBackend"),
                          text.CMUDictBackend)
        assert isinstance(text.default_g2p_backend(
            cmudict_path=str(tmp_path / "missing.txt")), text.RuleG2PBackend)
    msgs = " ".join(r.getMessage() for r in caplog.records)
    assert "pinned EspeakBackend unavailable" in msgs
    assert "unknown pinned G2P backend" in msgs
    assert "unusable" in msgs and "NOT linguistically faithful" in msgs
    caplog.clear()
    monkeypatch.setattr(text, "bundled_cmudict_path", lambda: None)
    with caplog.at_level(logging.WARNING, logger="your_voice_tts_torch.text"):
        assert isinstance(text.default_g2p_backend(), text.RuleG2PBackend)
        assert isinstance(text.default_g2p_backend(prefer="CMUDictBackend"),
                          text.RuleG2PBackend)
    assert sum("rule-based" in r.getMessage() for r in caplog.records) == 2


def test_text_to_seq_routes_and_keeps_one_backend(monkeypatch, tmp_path):
    """A phoneme config's ids equal the JAX package's `text_to_seq` for the
    same pin, with and without EOS/BOS; the backend is built once a
    (language, lexicon, pin)."""
    from your_voice_tts_tpu.infer.synthesis import text_to_seq as jax_text_to_seq

    monkeypatch.setenv("PATH", str(tmp_path))
    for pin in ("CMUDictBackend", "RuleG2PBackend"):
        for eos_bos in (False, True):
            kw = dict(g2p_backend=pin, enable_eos_bos_chars=eos_bos)
            cfg, jcfg = phoneme_config(load_config, **kw), phoneme_config(jax_load_config, **kw)
            for s in SENTENCES:
                np.testing.assert_array_equal(synthesis.text_to_seq(s, cfg),
                                              jax_text_to_seq(s, jcfg))
            assert synthesis.g2p_backend(cfg) is synthesis.g2p_backend(cfg)
    assert type(synthesis.g2p_backend(phoneme_config(load_config))).__name__ \
        == "CMUDictBackend"


# ------------------------------------------------------------ dataset, training

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_corpus(str(tmp_path_factory.mktemp("corpus")), n_items=12, sr=8000)


def corpus_config(corpus, **data):
    cfg = phoneme_config(load_config, **data)
    ds = dataclasses.replace(cfg.data.datasets[0], path=corpus)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
        training=dataclasses.replace(cfg.training, run_eval=False))


def test_dataset_phoneme_cache(corpus, tmp_path, caplog):
    """The ids of the dataset equal the JAX package's; the phoneme cache
    writes one file a text under phonemes/, named by the JAX package's
    sha1 key, and a second dataset reads them back (a planted file shows
    it is read, not recomputed)."""
    from your_voice_tts_tpu.audio import AudioProcessor as JaxAudioProcessor
    from your_voice_tts_tpu.data import TTSDataset as JaxTTSDataset
    from your_voice_tts_torch.audio import AudioProcessor

    cfg = corpus_config(corpus)
    items, _ = load_meta_data(cfg.data.datasets)
    ap = AudioProcessor(cfg.audio, "cpu")
    with caplog.at_level(logging.INFO, logger="your_voice_tts_torch.data.dataset"):
        ds = TTSDataset(items, cfg, ap, cache_dir=str(tmp_path / "port"))
    assert any("OOV rate" in r.getMessage() for r in caplog.records)
    jcfg = phoneme_config(jax_load_config)
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data,
                                                              datasets=cfg.data.datasets))
    ref = JaxTTSDataset(items, jcfg, JaxAudioProcessor(jcfg.audio),
                        cache_dir=str(tmp_path / "jax"))
    assert ds.g2p_backend_name == ref.g2p_backend_name == "CMUDictBackend"
    assert ds.g2p_oov_rate == ref.g2p_oov_rate
    assert [e["text"] for e in ds.entries] == [e["text"] for e in ref.entries]
    for a, b in zip(ds.entries, ref.entries):
        np.testing.assert_array_equal(a["seq"], b["seq"])
    port_files = sorted(os.listdir(tmp_path / "port" / "phonemes"))
    assert port_files == sorted(os.listdir(tmp_path / "jax" / "phonemes"))
    assert len(port_files) == len({it[0] for it in items})
    planted = np.arange(3, 30, dtype=np.int32)
    np.save(tmp_path / "port" / "phonemes" / port_files[0], planted)
    again = TTSDataset(items, cfg, ap, cache_dir=str(tmp_path / "port"))
    assert sum(np.array_equal(e["seq"], planted) for e in again.entries) >= 1


def test_one_training_step_on_phonemes_and_the_pin_back(corpus, tmp_path):
    """One Trainer step on the phoneme table; the checkpoint's meta names
    the backend; a Synthesizer on a config pinned elsewhere loads it
    strictly and pins CMUDictBackend back; the JAX package loads the
    checkpoint strictly, the phoneme-wide table leaf for leaf."""
    from your_voice_tts_tpu.models import setup_model as jax_setup_model
    from your_voice_tts_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
    from your_voice_tts_torch.train.checkpoint import read_checkpoint
    from your_voice_tts_torch.train.trainer import Trainer

    cfg = corpus_config(corpus)
    trainer = Trainer(cfg, output_path=str(tmp_path / "run"), verbose=False, device="cpu")
    assert trainer.num_chars == len(symbols.phonemes)
    assert trainer.model.embedding.num_embeddings == len(symbols.phonemes)
    trainer.fit(max_steps=1)
    path = str(tmp_path / "run" / "checkpoint_1.npz")
    _, _, meta = read_checkpoint(path)
    assert meta["g2p_backend"] == "CMUDictBackend"
    pinned = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                               g2p_backend="RuleG2PBackend"))
    synth = Synthesizer(pinned, path, device="cpu")
    assert synth.cfg.data.g2p_backend == "CMUDictBackend"
    assert isinstance(synthesis.g2p_backend(synth.cfg), text.CMUDictBackend)
    jm = jax_setup_model(len(jax_symbols.phonemes), 0, phoneme_config(jax_load_config))
    v = jm.init(jax.random.PRNGKey(0))
    params, _, _, _ = jax_load_checkpoint(path, params=v["params"], model_state=v["state"])
    np.testing.assert_array_equal(np.asarray(params["embedding"]["table"]),
                                  trainer.model.embedding.weight.detach().numpy())


# ------------------------------------------------------------ synthesis

def test_phoneme_synthesis_batch_matches_jax(tmp_path):
    """A phoneme config (CMUDict pinned) through both packages'
    `synthesis_batch` on a JAX-saved checkpoint at the smoke width:
    postnet mels within 1e-3 (float32, sum order only; 64 steps, the JAX
    CPU route decodes in 64-step chunks), the waveforms'
    lengths equal."""
    kw = dict(g2p_backend="CMUDictBackend")
    jcfg = phoneme_config(jax_load_config, **kw)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, prenet_dropout=False, max_decoder_steps=64))
    jax_s = JaxSynthesizer(jcfg)
    params = jax_s.variables["params"]
    assert params["embedding"]["table"].shape[0] == len(symbols.phonemes)
    stop = params["decoder"]["stopnet"]
    stop["b"] = jnp.full_like(stop["b"], -10.0)
    ckpt = jax_save_checkpoint(str(tmp_path / "ph.npz"), params=params,
                               model_state=jax_s.variables["state"], opt_state={}, step=1,
                               epoch=0, r=jcfg.model.r, extra={"g2p_backend": "CMUDictBackend"})
    cfg = phoneme_config(load_config, **kw)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, prenet_dropout=False, max_decoder_steps=64))
    port = Synthesizer(cfg, ckpt, device="cpu", decode_dtype=torch.float32)
    texts = SENTENCES[:3]
    ref = jax_synthesis_batch(jax_s.model, jax_s.variables, texts, jax_s.cfg, jax_s.ap)
    got = synthesis.synthesis_batch(port.model, texts, port.cfg, port.ap,
                                    decode_dtype=torch.float32)
    for g, r in zip(got, ref):
        assert g["mel_postnet_spec"].shape == r["mel_postnet_spec"].shape
        np.testing.assert_allclose(g["mel_postnet_spec"], r["mel_postnet_spec"], atol=1e-3)
        assert g["wav"].shape == r["wav"].shape and np.isfinite(g["wav"]).all()
    wavs = port.tts_many(texts)
    assert len(wavs) == 3 and all(np.isfinite(w).all() and len(w) for w in wavs)
