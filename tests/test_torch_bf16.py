"""`model.inference_compute_dtype`: the port's bf16 inference against the
JAX package's, for Tacotron2 and Tacotron(1) at smoke widths, and a float32
config that leaves today's outputs bit-for-bit.

Weights go through the `.npz` checkpoint bridge: the trained smoke
checkpoint for Tacotron2, a JAX-saved Tacotron(1) checkpoint. The JAX side
runs its kernel route (`use_pallas=True`, the Pallas decode in interpret
mode) with `compute_dtype=jnp.bfloat16`; the port runs the plain decode at
bf16 with `compute_dtype=torch.bfloat16`.

Tolerances: bf16 rounds at other places in the two frameworks (XLA fuses
a bf16 convolution, BatchNorm and activation into one rounding where
PyTorch rounds after each op; the JAX scan carries its bf16 LSTM/GRU
state, torch's bf16 RNN accumulates in float32). One bf16 ulp at the mels'
largest magnitude (|x| < 8) is 0.0625: frames are held within one such
ulp, alignments within 0.05, stop probabilities within 2e-3, lengths
exactly; the encoder memory and W_k m that the decode is given within 2%
of their largest value, and closer on average than the float32 route's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.infer.synthesizer import Synthesizer as JaxSynthesizer
from your_voice_tts_tpu.models.common import cast_compute
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.infer.synthesis import _pad_texts, synthesis_batch, text_to_seq
from your_voice_tts_torch.infer.synthesizer import Synthesizer

torch.set_num_threads(1)

CONFIG, CKPT = "configs/smoke_synthetic.json", "assets/bench_trained_smoke.npz"
TEXTS = ["Hi there.", "The quick brown fox jumps over the lazy dog.",
         "Hello world, this is a test"]
STEPS = 40
FRAME_TOL, ALIGN_TOL, STOP_TOL = 0.0625, 0.05, 2e-3


def with_model(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))


def tacotron_config(loader, **kw):
    """The smoke config's audio with a small Tacotron(1) (width 32, memory
    5, attention 24), dropout off (its encoder prenet draws from
    jax.random in the reference)."""
    return with_model(loader(CONFIG), model="Tacotron", memory_size=5, tacotron_width=32,
                      attention_dim=24, prenet_dropout=False, max_decoder_steps=STEPS, **kw)


@pytest.fixture(scope="module")
def taco2():
    """(JAX Synthesizer, port Synthesizer) on the trained smoke checkpoint,
    bf16 inference, dropout on (both decodes draw it from the hash PRNG)."""
    kw = dict(inference_compute_dtype="bfloat16", max_decoder_steps=STEPS)
    return (JaxSynthesizer(with_model(jax_load_config(CONFIG), **kw), CKPT),
            Synthesizer(with_model(load_config(CONFIG), **kw), CKPT, device="cpu"))


@pytest.fixture(scope="module")
def taco1(tmp_path_factory):
    from your_voice_tts_tpu.train.checkpoint import save_checkpoint

    jax_s = JaxSynthesizer(tacotron_config(jax_load_config,
                                           inference_compute_dtype="bfloat16"))
    path = str(tmp_path_factory.mktemp("taco1") / "taco1.npz")
    ckpt = save_checkpoint(path, params=jax_s.variables["params"],
                           model_state=jax_s.variables["state"], opt_state={}, step=1,
                           epoch=0, r=2)
    port = Synthesizer(tacotron_config(load_config, inference_compute_dtype="bfloat16"),
                       ckpt, device="cpu")
    return jax_s, port


def batch(port):
    return _pad_texts([text_to_seq(t, port.cfg) for t in TEXTS])


def jax_bf16(jax_s, text, lengths):
    with pltpu.force_tpu_interpret_mode():
        out = jax_s.model.inference(jax_s.variables, jnp.asarray(text, jnp.int32),
                                    jnp.asarray(lengths, jnp.int32), use_pallas=True,
                                    compute_dtype=jnp.bfloat16, pallas_seed=0,
                                    max_decoder_steps=STEPS)
    return {k: np.asarray(v) for k, v in out.items()}


def assert_close(got, ref):
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), ref["mel_lengths"])
    for key, tol in (("decoder_outputs", FRAME_TOL), ("postnet_outputs", FRAME_TOL),
                     ("alignments", ALIGN_TOL), ("stop_probs", STOP_TOL)):
        assert got[key].dtype == torch.float32 and got[key].shape == ref[key].shape, key
        err = float(np.abs(got[key].numpy() - ref[key]).max())
        assert err <= tol, f"{key}: {err} > {tol}"


def bf16_valued(t) -> bool:
    return torch.equal(t, t.to(torch.bfloat16).float())


@pytest.mark.parametrize("model", ["taco2", "taco1"])
def test_bf16_inference_matches_jax(request, model):
    jax_s, port = request.getfixturevalue(model)
    text, lengths = batch(port)
    ref = jax_bf16(jax_s, text, lengths)
    got = port.model.inference(text, lengths, max_decoder_steps=STEPS,
                               compute_dtype=torch.bfloat16)
    assert_close(got, ref)
    # the frames were cast to bf16 before the postnet, which ran in bf16
    assert bf16_valued(got["decoder_outputs"]) and bf16_valued(got["postnet_outputs"])
    f32 = port.model.inference(text, lengths, max_decoder_steps=STEPS)
    assert not bf16_valued(f32["postnet_outputs"])


def jax_decode_inputs(jax_s, model, text, lengths):
    """The JAX bf16 route's encoder memory and key projection W_k m, as
    float32 numpy."""
    params, state = cast_compute(jax_s.variables["params"], jax_s.variables["state"],
                                 jnp.bfloat16)
    jm = jax_s.model
    text, lengths = jnp.asarray(text, jnp.int32), jnp.asarray(lengths, jnp.int32)
    if model == "taco2":
        x = jm.embedding(params["embedding"], text)
        enc, _ = jm.encoder(params["encoder"], state["encoder"], x, lengths, None, train=False)
    else:
        enc = jm._encode(params, state, text, None, False, None, None, None)[0]
    pinp = jm.decoder.attention.preprocess_inputs(params["decoder"]["attention"], enc)
    assert enc.dtype == pinp.dtype == jnp.bfloat16
    return [np.asarray(v.astype(jnp.float32)) for v in (enc, pinp)]


def port_run(port, model, monkeypatch, compute_dtype):
    """The port's inference at `compute_dtype`: the encoder memory and W_k m
    its decode was given, and every module that ran with the dtype of its
    output."""
    import your_voice_tts_torch.models.tacotron as t1
    import your_voice_tts_torch.models.tacotron2 as t2

    mod, fn = (t2, "tacotron2_decode") if model == "taco2" else (t1, "tacotron1_decode")
    real, seen, ran = getattr(mod, fn), {}, []

    def spy(w, enc, pinp, mask, **kw):
        seen["enc"], seen["pinp"] = enc.clone(), pinp.clone()
        return real(w, enc, pinp, mask, **kw)

    def hook(module, args, out):
        if isinstance(out, torch.Tensor) and any(True for _ in module.parameters(False)):
            ran.append((module, out.dtype))

    text, lengths = batch(port)
    with monkeypatch.context() as mp:
        mp.setattr(mod, fn, spy)
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            port.model.inference(text, lengths, max_decoder_steps=STEPS,
                                 compute_dtype=compute_dtype)
        finally:
            handle.remove()
    return seen["enc"].numpy(), seen["pinp"].numpy(), ran


@pytest.mark.parametrize("model", ["taco2", "taco1"])
def test_bf16_decode_inputs_match_jax(request, monkeypatch, model):
    """What the decode is given under bf16 inference: the encoder memory and
    W_k m, bf16 values, within 2% of their largest value of the JAX bf16
    route's. The float32 route is as close by that measure (its largest
    error from the JAX bf16 values was 0.0097 vs bf16's 0.0078 for the
    Tacotron2 memory, 0.0304 vs 0.0313 for its W_k m): one bf16 rounding of
    the reference dominates both. What separates them is the mean error,
    where bf16's rounding at the same places shows (bf16 0.72-0.86 of the
    float32 route's, over both models and both tensors): it must stay
    below 0.9 of the float32 route's."""
    jax_s, port = request.getfixturevalue(model)
    refs = jax_decode_inputs(jax_s, model, *batch(port))
    bf16 = port_run(port, model, monkeypatch, torch.bfloat16)
    f32 = port_run(port, model, monkeypatch, None)
    for name, ref, got, full in zip(("memory", "W_k m"), refs, bf16, f32):
        assert bf16_valued(torch.from_numpy(got)) and not bf16_valued(torch.from_numpy(full))
        assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max(), name
        mean_bf16, mean_f32 = np.abs(got - ref).mean(), np.abs(full - ref).mean()
        assert mean_bf16 < 0.9 * mean_f32, (name, mean_bf16, mean_f32)


@pytest.mark.parametrize("model", ["taco2", "taco1"])
def test_bf16_inference_runs_its_modules_in_bf16(request, monkeypatch, model):
    """Inside `inference` at bf16, every module with weights that runs (the
    embedding, encoder, key projection and postnet; the decode has none)
    holds bf16 weights and returns bf16; at float32 every one returns
    float32."""
    _, port = request.getfixturevalue(model)
    ran = port_run(port, model, monkeypatch, torch.bfloat16)[2]
    kinds = {type(m).__name__ for m, _ in ran}
    assert {"Embedding", "Conv1d", "Linear"} <= kinds and len(ran) >= 8, kinds
    for m, dtype in ran:
        assert dtype == torch.bfloat16, type(m).__name__
        assert all(t.dtype == torch.bfloat16 for t in m.parameters(False)
                   if t.is_floating_point()), type(m).__name__
    ran = port_run(port, model, monkeypatch, None)[2]
    assert ran and all(dtype == torch.float32 for _, dtype in ran)


@pytest.mark.parametrize("model", ["taco2", "taco1"])
def test_synthesis_batch_reads_the_compute_dtype(request, model):
    """A "bfloat16" config serves the bf16 outputs; a "float32" config the
    float32 ones, bit-for-bit those of inference without a compute dtype."""
    _, port = request.getfixturevalue(model)
    text, lengths = batch(port)
    m = port.model
    for dtype, compute in (("bfloat16", torch.bfloat16), ("float32", None)):
        cfg = with_model(port.cfg, inference_compute_dtype=dtype)
        got = synthesis_batch(m, TEXTS, cfg, port.ap)
        ref = m.inference(text, lengths, compute_dtype=compute)
        for g, r, n in zip(got, ref["postnet_outputs"], ref["mel_lengths"]):
            np.testing.assert_array_equal(g["mel_postnet_spec"], r[: max(int(n), m.r)].T.numpy())


def test_float32_is_todays_path(taco2):
    """compute_dtype None runs the float32 modules themselves: no bf16 copy
    is made, and the outputs equal a second run bit-for-bit."""
    _, port = taco2
    text, lengths = batch(port)
    m = port.model
    m.__dict__.pop("_compute_copies", None)
    a = m.inference(text, lengths, max_decoder_steps=STEPS)
    assert "_compute_copies" not in m.__dict__
    b = m.inference(text, lengths, max_decoder_steps=STEPS, compute_dtype=None)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_compute_copy_follows_weight_edits(taco2):
    """The bf16 copies are rebuilt when the float32 weights change."""
    from your_voice_tts_torch.models.common import compute_copy

    _, port = taco2
    m = port.model
    first = compute_copy(m, "postnet", torch.bfloat16)
    assert compute_copy(m, "postnet", torch.bfloat16) is first
    w = next(m.postnet.parameters())
    with torch.no_grad():
        w.mul_(1.0)
    second = compute_copy(m, "postnet", torch.bfloat16)
    assert second is not first
    assert next(second.parameters()).dtype == torch.bfloat16
