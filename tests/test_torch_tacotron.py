"""The port's Tacotron(1) against the JAX package at small widths: the CBHG,
the encoder path, the decode's plain version (of the CUDA kernel) against
the Pallas decode kernel run in interpret mode and against the XLA scan, the
whole `Tacotron.inference` against the JAX model's kernel route, and the
checkpoint bridge.

Weights come from the JAX `Tacotron.init` through `params_from_jax`;
inputs are made with numpy from a seed and handed to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.models.common import sequence_mask as jax_sequence_mask
from your_voice_tts_tpu.models.tacotron import CBHG as JaxCBHG
from your_voice_tts_tpu.models.tacotron import Tacotron as JaxTacotron
from your_voice_tts_tpu.ops.pallas.taco1_decode import tacotron1_decode_pallas
from your_voice_tts_tpu.ops.pallas.wavernn_gen import _fmix32, _uniform
from your_voice_tts_torch.config import ModelConfig
from your_voice_tts_torch.models.tacotron import CBHG, Tacotron
from your_voice_tts_torch.ops import prng
from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode
from your_voice_tts_torch.train.checkpoint import (load_checkpoint, params_from_jax,
                                                   params_to_jax)

torch.set_num_threads(1)

N_MELS, N_FREQ, CHARS = 20, 129, 30
# tests/test_tacotron_model.py:18-21 and tests/test_pallas_kernels.py:309-319
SMALL = dict(model="Tacotron", r=2, memory_size=5, tacotron_width=32, attention_dim=24,
             attention_location_filters=8, attention_location_kernel_size=15,
             max_decoder_steps=20)


def small_models(**kw):
    """(JAX model, JAX variables, port model with the same weights)."""
    cfg = dict(SMALL, **kw)
    jm = JaxTacotron(CHARS, JaxModelConfig(**cfg), n_mels=N_MELS, num_freq=N_FREQ)
    variables = jm.init(jax.random.PRNGKey(0))
    pm = Tacotron(CHARS, ModelConfig(**cfg), n_mels=N_MELS, num_freq=N_FREQ, device="cpu")
    pm.load_state_dict(params_from_jax(variables["params"], variables["state"]), strict=True)
    return jm, variables, pm


@pytest.fixture(scope="module")
def models():
    return small_models(prenet_dropout=False)


def randomize_bn_state(state, seed):
    """Running statistics away from (0, 1), so the BatchNorms do work."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"mean", "var"}:
                n = np.asarray(node["mean"]).shape
                node["mean"] = jnp.asarray(0.3 * rng.standard_normal(n), jnp.float32)
                node["var"] = jnp.asarray(np.exp(0.4 * rng.standard_normal(n)), jnp.float32)
            else:
                for v in node.values():
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(state)
    return state


def text_batch(B=4, T=13, seed=1):
    """Ids with lengths T, T - 3, T - 5, ...: odd pad counts, zero ids in
    the padding (the batch as synthesis pads it)."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(T - np.array([0, 3, 5, 7, 1, 9][:B]), 2)
    text = rng.integers(1, CHARS, (B, T))
    text[np.arange(T)[None, :] >= lengths[:, None]] = 0
    return text, lengths


@pytest.mark.parametrize("in_dim,kw", [
    (32, dict(K=4, bank_channels=16, projections=(16, 32), highway_dim=16, gru_dim=16)),
    (16, dict(K=16, bank_channels=16, projections=(16, 16), highway_dim=16, gru_dim=16)),
    (20, dict(K=8, projections=(32, 20), highway_dim=16, gru_dim=16)),     # PostCBHG
])
def test_cbhg_matches_jax(in_dim, kw):
    """Eval-mode CBHG (running statistics moved off (0, 1)) on rows padded
    with 0, 3 and 5 zero frames: the backward GRU starts inside the padding
    on both sides. float32, rel 1e-4."""
    jc = JaxCBHG(in_dim, **kw)
    p, s = jc.init(jax.random.PRNGKey(2)), randomize_bn_state(jc.init_state(), 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 13, in_dim)).astype(np.float32)
    x[1, 10:] = 0.0
    x[2, 8:] = 0.0
    ref, _ = jc(p, s, jnp.asarray(x), train=False)
    pc = CBHG(in_dim, **kw)
    pc.load_state_dict(params_from_jax(p, s), strict=True)
    pc.eval()
    with torch.no_grad():
        got = pc(torch.from_numpy(x))
    assert got.shape == (3, 13, 2 * kw["gru_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_encoder_matches_jax(models):
    jm, v, pm = models
    text, lengths = text_batch()
    ref = jm._encode(v["params"], v["state"], jnp.asarray(text), None, False, None, None,
                     None)[0]
    with torch.no_grad():
        got = pm.encoder_cbhg(pm.enc_prenet(pm.embedding(torch.from_numpy(text))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def decode_inputs(jm, v, B=4, T=13):
    text, lengths = text_batch(B, T)
    enc = jm._encode(v["params"], v["state"], jnp.asarray(text), None, False, None, None,
                     None)[0]
    enc = np.array(enc)
    pinp = jm.decoder.attention.preprocess_inputs(v["params"]["decoder"]["attention"], enc)
    return enc, lengths, np.array(pinp)


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (2**31 - 1, 49)])
def test_hash_prng_bit_exact_at_taco1_widths(seed, step):
    """The decoder prenet's dropout draws: salts 21 and 22 over its two
    widths (256 and 128 at full width)."""
    key = _fmix32(jnp.int32(seed) + jnp.int32(step) * np.int32(-1640531527))
    for salt, width in ((21, 256), (22, 128)):
        ref = np.asarray(_uniform((8, width), key, salt))
        got = prng.uniform((8, width), prng.step_key(seed, step), salt).numpy()
        np.testing.assert_array_equal(got, ref)


# dtype, tolerances (frames, alignments / stops): float32 differs only by sum
# order; bf16 rounds every matrix input, the Pallas kernel's own
# kernel-vs-scan tolerances (tests/test_pallas_kernels.py:723-727)
@pytest.mark.parametrize("dtype,r,tol", [
    ("float32", 2, (1e-4, 1e-4)),
    ("float32", 5, (1e-4, 1e-4)),
    ("bfloat16", 2, (5e-3, 2e-3)),
])
def test_decode_plain_matches_pallas_kernel_with_dropout(dtype, r, tol):
    """Dropout on: the plain decode draws the Pallas kernel's hash-PRNG masks
    bit for bit, so frames, alignments and stops agree. Held over the first
    chunk: past it, once every row is done, the kernel route zero-fills
    while the Pallas interpreter keeps decoding."""
    jm, v, pm = small_models(prenet_dropout=True, r=r)
    enc, lengths, pinp = decode_inputs(jm, v)
    mask = np.arange(enc.shape[1])[None, :] < lengths[:, None]
    kw = dict(r=r, max_steps=12, chunk=6, seed=11, prenet_dropout=True)
    ref = tacotron1_decode_pallas(v["params"]["decoder"], jnp.asarray(enc), jnp.asarray(pinp),
                                  jnp.asarray(mask), n_mels=N_MELS, memory_size=5,
                                  interpret=True, dtype=getattr(jnp, dtype), **kw)
    got = tacotron1_decode(pm.decoder.decode_weights(getattr(torch, dtype)),
                           torch.from_numpy(enc), torch.from_numpy(pinp),
                           torch.from_numpy(mask), **kw)
    n = 6
    np.testing.assert_allclose(got[0][:n].numpy(), np.asarray(ref[0])[:n], atol=tol[0])
    np.testing.assert_allclose(got[1][:n].numpy(), np.asarray(ref[1])[:n], atol=tol[1])
    np.testing.assert_allclose(got[2][:n].numpy(), np.asarray(ref[2])[:n], atol=tol[1])
    # the masks are really on: another seed moves the frames
    other = tacotron1_decode(pm.decoder.decode_weights(getattr(torch, dtype)),
                             torch.from_numpy(enc), torch.from_numpy(pinp),
                             torch.from_numpy(mask), **dict(kw, seed=12))
    assert float((other[0][:n] - got[0][:n]).abs().max()) > 10 * tol[0]


@pytest.mark.parametrize("dtype,tol", [("float32", (1e-4, 1e-4)), ("bfloat16", (5e-3, 2e-3))])
def test_decoder_inference_matches_jax_scan(models, dtype, tol):
    """Dropout off, 20 steps: the port's decoder (plain decode) against
    `TacotronDecoder.inference`, the XLA scan; lengths exact."""
    jm, v, pm = models
    enc, lengths, _ = decode_inputs(jm, v)
    ref = jm.decoder.inference(v["params"]["decoder"], v["state"]["decoder"],
                               jnp.asarray(enc), jnp.asarray(lengths), None, 20)
    got = pm.decoder.inference(torch.from_numpy(enc), torch.from_numpy(lengths), 20, 2,
                               dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=tol[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=tol[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=tol[1])


def test_bn_prenet_fold_matches_jax_scan():
    """BN prenets (decoder and encoder) with randomized scales and running
    statistics: the decoder's folds into plain Linears for the decode (no
    dropout), the encoder's runs in eval mode; the decode matches the XLA
    scan."""
    jm, v, _ = small_models(prenet_type="bn", prenet_dropout=False)
    rng = np.random.default_rng(5)
    for bn in v["params"]["decoder"]["prenet"]["bns"] + v["params"]["enc_prenet"]["bns"]:
        bn["scale"] = jnp.asarray(1 + 0.3 * rng.standard_normal(bn["scale"].shape), jnp.float32)
    randomize_bn_state(v["state"], 6)
    cfg = dict(SMALL, prenet_type="bn", prenet_dropout=False)
    pm = Tacotron(CHARS, ModelConfig(**cfg), n_mels=N_MELS, num_freq=N_FREQ, device="cpu")
    pm.load_state_dict(params_from_jax(v["params"], v["state"]), strict=True)
    enc, lengths, _ = decode_inputs(jm, v)
    with torch.no_grad():
        penc = pm.encoder_cbhg(pm.enc_prenet(pm.embedding(torch.from_numpy(text_batch()[0]))))
    np.testing.assert_allclose(penc.numpy(), enc, rtol=1e-4, atol=1e-5)
    ref = jm.decoder.inference(v["params"]["decoder"], v["state"]["decoder"],
                               jnp.asarray(enc), jnp.asarray(lengths), None, 12)
    got = pm.decoder.inference(torch.from_numpy(enc), torch.from_numpy(lengths), 12, 2,
                               dtype=torch.float32)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)


def test_long_text_matches_pallas_tiled_formulation(models):
    """T = 140: the reference switches to its tiled location formulation
    past 128 symbols; the port's single folded correlation matches it."""
    jm, v, pm = models
    enc, lengths, pinp = decode_inputs(jm, v, B=3, T=140)
    lengths = np.array([140, 90, 40])
    mask = np.arange(140)[None, :] < lengths[:, None]
    kw = dict(r=2, max_steps=10, prenet_dropout=False)
    ref = tacotron1_decode_pallas(v["params"]["decoder"], jnp.asarray(enc), jnp.asarray(pinp),
                                  jnp.asarray(mask), n_mels=N_MELS, memory_size=5,
                                  interpret=True, loc_tiled=True, **kw)
    got = tacotron1_decode(pm.decoder.decode_weights(torch.bfloat16), torch.from_numpy(enc),
                           torch.from_numpy(pinp), torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=5e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=2e-3)


def test_decode_refuses_r_past_r_init(models):
    _, _, pm = models
    w = pm.decoder.decode_weights(torch.float32)
    with pytest.raises(ValueError, match="r_init"):
        tacotron1_decode(w, torch.zeros(1, 4, 32), torch.zeros(1, 4, 24),
                         torch.ones(1, 4, dtype=torch.bool), r=3, max_steps=2)


def test_r_past_the_memory_matches_jax_scan():
    """r = 3 frames a step into a 2-frame queue: the Pallas kernel leaves
    this to the XLA scan, whose queue keeps the step's last 2 frames; the
    port's decode follows it (float32, dropout off, lengths exact)."""
    jm, v, pm = small_models(prenet_dropout=False, r=3, memory_size=2)
    enc, lengths, _ = decode_inputs(jm, v)
    ref = jm.decoder.inference(v["params"]["decoder"], v["state"]["decoder"],
                               jnp.asarray(enc), jnp.asarray(lengths), None, 12, r=3)
    got = pm.decoder.inference(torch.from_numpy(enc), torch.from_numpy(lengths), 12, 3,
                               dtype=torch.float32)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-4)


@pytest.mark.parametrize("r", [2, 5])
def test_tacotron_inference_matches_jax_kernel_route(r):
    """The whole `Tacotron.inference` (bf16 decode) against the JAX model
    with use_pallas=True under the Pallas interpreter, prenet dropout off:
    mel and linear outputs, stop probabilities and lengths."""
    jm, v, pm = small_models(prenet_dropout=False, r=r, memory_size=5)
    randomize_bn_state(v["state"], 7)
    pm.load_state_dict(params_from_jax(v["params"], v["state"]), strict=True)
    text, lengths = text_batch(B=3, T=11)
    with pltpu.force_tpu_interpret_mode():
        ref = jm.inference(v, jnp.asarray(text), jnp.asarray(lengths), use_pallas=True,
                           max_decoder_steps=10)
    got = pm.inference(text, lengths, max_decoder_steps=10)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(ref["mel_lengths"]))
    assert got["postnet_outputs"].shape == (3, 10 * r, N_FREQ)
    np.testing.assert_allclose(got["decoder_outputs"].numpy(),
                               np.asarray(ref["decoder_outputs"]), atol=5e-3)
    np.testing.assert_allclose(got["stop_probs"].numpy(), np.asarray(ref["stop_probs"]),
                               atol=2e-3)
    # the linear head sums the frames' bf16 rounding differences over the
    # PostCBHG's convolutions and BiGRU
    np.testing.assert_allclose(got["postnet_outputs"].numpy(),
                               np.asarray(ref["postnet_outputs"]), atol=2e-2)


def test_encoder_prenet_dropout_is_seeded(models):
    """The encoder prenet's dropout stays on at inference and is drawn from a
    generator seeded by `seed`: same seed, same output; another, another."""
    _, v, _ = models
    cfg = dict(SMALL, prenet_dropout=True)
    pm = Tacotron(CHARS, ModelConfig(**cfg), n_mels=N_MELS, num_freq=N_FREQ, device="cpu")
    text, lengths = text_batch(B=2, T=9)
    a, b, c = (pm.inference(text, lengths, max_decoder_steps=3, seed=s)["postnet_outputs"]
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_jax_checkpoint_loads_strictly(tmp_path, models):
    """A JAX-saved Tacotron(1) checkpoint loads leaf-exact; the port's
    writer gives back the JAX package's keys and values."""
    from your_voice_tts_tpu.train.checkpoint import _flatten, save_checkpoint

    jm, v, _ = models
    randomize_bn_state(v["state"], 8)
    path = save_checkpoint(str(tmp_path / "taco1.npz"), params=v["params"],
                           model_state=v["state"], opt_state={}, step=3, epoch=0, r=2)
    pm = Tacotron(CHARS, ModelConfig(**dict(SMALL, prenet_dropout=False)), n_mels=N_MELS,
                  num_freq=N_FREQ, device="cpu", seed=9)
    meta = load_checkpoint(pm, path)
    assert meta["r"] == 2
    params, state = params_to_jax(pm)
    for ref, got in ((_flatten(v["params"]), params), (_flatten(v["state"]), state)):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_sequence_mask_and_config():
    from your_voice_tts_torch.models.common import sequence_mask
    lengths = np.array([3, 0, 5])
    np.testing.assert_array_equal(sequence_mask(torch.from_numpy(lengths), 5).numpy(),
                                  np.asarray(jax_sequence_mask(jnp.asarray(lengths), 5)))
    assert dataclasses.asdict(ModelConfig(**SMALL)) == dataclasses.asdict(
        JaxModelConfig(**SMALL))
