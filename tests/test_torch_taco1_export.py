"""The serving export of a Tacotron(1) that decodes on the step loop
(Graves attention, location features off), on the CPU: the decode crosses
into the traced program as the registered op `yvt::taco1_step_decode`
(ops/library.py), which runs `TacotronDecoder._decode_loop` eagerly on
weights the program carries.

- the artifact against its unexported program (`make_serving_fn`), bit
  for bit on the wav and the lengths, prenet dropout on, two seeds;
- the traced spectrogram stage against the live `inference` (dropout off),
  bit for bit, each row's tail masked;
- with prenet dropout off, the program's spectrogram stage against the
  JAX package's `make_serving_fn` (its scan, float32, the waveform stage
  replaced by the identity so that its masked spectrogram comes out):
  1e-5 absolute on the linear head of values ~1 (the step loop against the
  JAX scan, tests/test_torch_taco1_variants.py's inference tolerance is
  1e-4 there, sum order only; held tighter where it holds), lengths exact;
- a bf16 compute dtype: the traced route decodes on bf16 copies of the
  decoder's weights, as the live route's `compute_copy` does, bit for bit.

The models are the narrow Tacotron(1) of tests/test_torch_taco1_variants.py,
built in both packages from the JAX `init` through the checkpoint bridge.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_taco1_train import configs as taco1_configs
from tests.test_torch_taco1_train import np_tree
from your_voice_tts_tpu.audio import AudioProcessor as JaxAP
from your_voice_tts_tpu.infer import export as jexport
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.ops import dsp as jdsp
from your_voice_tts_tpu.text import symbols as jax_symbols
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.infer.export import (ExportedSynthesizer, export_serving,
                                               make_serving_fn)
from your_voice_tts_torch.models import setup_model
from your_voice_tts_torch.text import symbols
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax

torch.set_num_threads(1)

KINDS = {"graves": dict(attention_type="graves"), "no_location": dict(location_attn=False)}
STEPS = 12
JAX_TOL = 1e-5


@functools.cache
def models(kind: str, dropout: bool, compute: str = "float32"):
    """(JAX model, its variables, the port model with those weights, the
    JAX config, the port config) of the narrow Tacotron(1) at r = 2 with
    KINDS[kind], prenet dropout as `dropout`, `compute` as its inference
    compute dtype."""
    flags = dict(KINDS[kind], prenet_dropout=dropout, max_decoder_steps=STEPS,
                 inference_compute_dtype=compute)
    jcfg, cfg = (dataclasses.replace(c, model=dataclasses.replace(c.model, **flags))
                 for c in taco1_configs("unused"))
    jm = jax_setup_model(len(jax_symbols), 0, jcfg)
    v = jm.init(jax.random.PRNGKey(1))
    pm = setup_model(len(symbols), cfg, device="cpu")
    pm.load_state_dict(params_from_jax(np_tree(v["params"]), np_tree(v["state"]),
                                       jax_layouts(pm)), strict=True)
    assert not pm.decoder.kernel_supported()
    return jm, v, pm, jcfg, cfg


def text_batch(B: int = 3, T: int = 16):
    rng = np.random.default_rng(5)
    lens = np.array([16, 9, 12, 5][:B], np.int64)
    text = np.where(np.arange(T)[None] < lens[:, None], rng.integers(1, 60, (B, T)), 0)
    return text.astype(np.int64), lens


def run(program, text, lens, seed=0):
    with torch.no_grad():
        return program(torch.from_numpy(text), torch.from_numpy(lens), torch.tensor([seed]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_artifact_equals_its_unexported_program(kind, tmp_path):
    """Prenet dropout on (the encoder's from the seed's hash draws, the
    decoder's from the step loop's): the loaded artifact's wav and lengths
    equal its unexported program's bit for bit for two seeds, which give
    different audio; the graph holds the step-loop op and Griffin-Lim,
    not kernel 8's op."""
    _, _, pm, _, cfg = models(kind, True)
    ap = AudioProcessor(cfg.audio, "cpu")
    out = str(tmp_path / kind)
    manifest = export_serving(pm, cfg, ap, out, batch_sizes=(3,), text_buckets=(16,))
    assert manifest["max_decoder_steps"] == STEPS and manifest["r"] == 2
    graph = str(torch.export.load(os.path.join(out, "serve_b3_t16.pt2")).graph)
    assert "yvt.taco1_step_decode" in graph and "yvt.griffin_lim" in graph
    assert "yvt.taco1_decode." not in graph
    exp, program = ExportedSynthesizer(out), make_serving_fn(pm, cfg, ap)
    text, lens = text_batch()
    wavs = []
    for seed in (0, 3):
        wav, ml = exp(text, lens, seed=seed)
        ref_wav, ref_ml = run(program, text, lens, seed)
        np.testing.assert_array_equal(ml, ref_ml.numpy())
        np.testing.assert_array_equal(wav, ref_wav.numpy())
        assert wav.shape == (3, cfg.audio.hop_length * (STEPS * 2 - 1))
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0
        wavs.append(wav)
    assert not np.array_equal(*wavs)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_traced_spectrogram_is_the_live_inference(kind, compute):
    """Dropout off: the program's spectrogram stage (the traced route, the
    op on the copied weights) equals the live `inference` (the step loop on
    the module; in bf16 on its `compute_copy`) bit for bit, each row's
    frames past its length set to the fill; the lengths equal."""
    _, _, pm, _, cfg = models(kind, False, compute)
    ap = AudioProcessor(cfg.audio, "cpu")
    program = make_serving_fn(pm, cfg, ap)
    text, lens = text_batch()
    with torch.no_grad():
        spec, ml = program.spectrogram(torch.from_numpy(text), torch.from_numpy(lens),
                                       torch.tensor([0]))
        live = pm.inference(text, lens, compute_dtype=program.compute_dtype)
    np.testing.assert_array_equal(ml.numpy(), live["mel_lengths"].numpy())
    keep = np.arange(STEPS * 2)[None, :, None] < live["mel_lengths"].numpy()[:, None, None]
    ref = np.where(keep, live["postnet_outputs"].numpy(), program.fill.numpy())
    assert spec.shape == ref.shape == (3, STEPS * 2, cfg.audio.num_freq)
    np.testing.assert_array_equal(spec.numpy(), ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_program_matches_the_jax_export(kind, monkeypatch):
    """Dropout off, float32: the program's masked spectrogram against the
    JAX `make_serving_fn` (the scan route) with its waveform stage
    (`dsp.inv_spectrogram_batch`) replaced by the identity, JAX_TOL; the
    lengths exact."""
    jm, v, pm, jcfg, cfg = models(kind, False)
    text, lens = text_batch()
    monkeypatch.setattr(jdsp, "inv_spectrogram_batch", lambda spec, key, **kw: spec)
    serve = jexport.make_serving_fn(jm, v, jcfg, JaxAP(jcfg.audio))
    ref, ref_ml = jax.jit(serve)(jnp.asarray(text, jnp.int32), jnp.asarray(lens, jnp.int32),
                                 jax.random.PRNGKey(0))
    program = make_serving_fn(pm, cfg, AudioProcessor(cfg.audio, "cpu"))
    with torch.no_grad():
        spec, ml = program.spectrogram(torch.from_numpy(text), torch.from_numpy(lens),
                                       torch.tensor([0]))
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ref_ml))
    assert spec.shape == np.asarray(ref).shape
    np.testing.assert_allclose(spec.numpy(), np.asarray(ref), atol=JAX_TOL, rtol=0)
