"""The port's decode (plain PyTorch version of the CUDA decode kernel)
against the JAX package's Pallas decode kernel run in interpret mode, with
prenet dropout on, plus the hash PRNG both draw it from.

Inputs are made with numpy from a seed and handed to both sides; the
port's weights are the JAX model's, carried over by params_from_jax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.models.common import sequence_mask as jax_sequence_mask
from your_voice_tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from your_voice_tts_tpu.ops.pallas.taco2_decode import tacotron2_decode_pallas
from your_voice_tts_tpu.ops.pallas.wavernn_gen import _fmix32, _uniform
from your_voice_tts_torch.config import ModelConfig
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.ops import prng
from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode
from your_voice_tts_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

N_MELS, CHARS, B, T = 20, 30, 4, 12
SMALL = dict(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
             attention_rnn_dim=48, attention_dim=24,
             attention_location_filters=8, attention_location_kernel_size=15,
             prenet_dim=24, postnet_dim=32, max_decoder_steps=12)


def small_models(**kw):
    """(JAX model, JAX variables, port model with the same weights)."""
    cfg = dict(SMALL, **kw)
    jm = JaxTacotron2(CHARS, JaxModelConfig(**cfg), n_mels=N_MELS)
    variables = jm.init(jax.random.PRNGKey(0))
    pm = Tacotron2(CHARS, ModelConfig(**cfg), n_mels=N_MELS, device="cpu")
    pm.load_state_dict(params_from_jax(variables["params"], variables["state"]))
    return jm, variables, pm


@pytest.fixture(scope="module")
def models():
    return small_models(prenet_dropout=True)


def decode_inputs(jm, params, stop_rows):
    """Encoder memory [B, T, E] (numpy, seeded), lengths, mask and W_k m.
    Rows in `stop_rows` get the stop logit's context direction added so
    they fire their stop token at the first step."""
    p = params["decoder"]
    rng = np.random.default_rng(3)
    enc = (0.5 * rng.standard_normal((B, T, SMALL["encoder_dim"]))).astype(np.float32)
    H2 = SMALL["decoder_rnn_dim"]
    c = np.asarray(p["projection"]["w"])[H2:] @ np.asarray(p["stopnet"]["w"])[H2:, 0]
    for row in stop_rows:
        enc[row] += 8.0 * c / (c @ c)
    lengths = np.array([12, 10, 8, 7])
    pinp = np.array(jm.decoder.attention.preprocess_inputs(p["attention"], jnp.asarray(enc)))
    return enc, lengths, pinp


# dtype, tolerances (frames, alignments/stops): float32 differs only by sum
# order (1e-4); bf16 rounds every matrix input, the Pallas kernel's own
# kernel-vs-scan tolerances (tests/test_pallas_kernels.py:349-355)
@pytest.mark.parametrize("dtype,stop_rows,tol", [
    ("float32", (0,), (1e-4, 1e-4)),
    ("float32", (0, 1, 2, 3), (1e-4, 1e-4)),
    ("bfloat16", (0,), (5e-3, 2e-3)),
])
def test_decode_plain_matches_pallas_kernel(models, dtype, stop_rows, tol):
    jm, variables, pm = models
    params = variables["params"]
    enc, lengths, pinp = decode_inputs(jm, params, stop_rows)
    mask = np.arange(T)[None, :] < lengths[:, None]
    kw = dict(r=2, max_steps=12, chunk=4, seed=7, prenet_dropout=True)
    ref = tacotron2_decode_pallas(
        params["decoder"], jnp.asarray(enc), jnp.asarray(pinp), jnp.asarray(mask),
        n_mels=N_MELS, interpret=True, dtype=getattr(jnp, dtype), **kw)
    got = tacotron2_decode(
        pm.decoder.decode_weights(getattr(torch, dtype)), torch.from_numpy(enc),
        torch.from_numpy(pinp), torch.from_numpy(mask), **kw)
    ref_len = np.asarray(ref[3])
    assert ref_len[0] == 1                       # the pushed row stops at once
    np.testing.assert_array_equal(got[3].numpy(), ref_len)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=tol[0])
    # once every row is done the kernel route zero-fills the later chunks;
    # the Pallas interpreter does not take that branch off the TPU (it keeps
    # decoding), so there alignments and stops are held over the first chunk
    n = 4 if len(stop_rows) == B else 12
    np.testing.assert_allclose(got[1][:n].numpy(), np.asarray(ref[1])[:n], atol=tol[1])
    np.testing.assert_allclose(got[2][:n].numpy(), np.asarray(ref[2])[:n], atol=tol[1])
    if len(stop_rows) == B:
        assert not got[1][4:].any() and not got[2][4:].any()


def test_decode_dropout_is_on_and_seeded(models):
    """Different seeds draw different dropout masks, the same seed the same
    ones (the hash PRNG is keyed by seed and step)."""
    jm, variables, pm = models
    enc, lengths, pinp = decode_inputs(jm, variables["params"], ())
    args = (pm.decoder.decode_weights(torch.float32), torch.from_numpy(enc),
            torch.from_numpy(pinp), torch.from_numpy(np.arange(T)[None] < lengths[:, None]))
    a, b, c = (tacotron2_decode(*args, r=2, max_steps=3, seed=s)[0] for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (123456, 499), (2**31 - 1, 77)])
def test_hash_prng_bit_exact(seed, step):
    key = _fmix32(jnp.int32(seed) + jnp.int32(step) * np.int32(-1640531527))
    assert prng.step_key(seed, step) == int(np.asarray(key).astype(np.uint32))
    for salt in (11, 12):
        ref = np.asarray(_uniform((5, 24), key, salt))
        got = prng.uniform((5, 24), prng.step_key(seed, step), salt).numpy()
        np.testing.assert_array_equal(got, ref)


def test_prenet_bn_fold_matches_jax_scan():
    """A BN prenet folds into plain Linears for the decode: with dropout off
    (BN prenets never drop) the plain decode matches the JAX scan."""
    jm, variables, pm = small_models(prenet_type="bn", prenet_dropout=False)
    rng = np.random.default_rng(5)
    for bn in pm.decoder.prenet.bns:
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(1 + 0.3 * rng.standard_normal(bn.weight.shape)))
            bn.running_var.copy_(torch.from_numpy(np.exp(0.5 * rng.standard_normal(bn.weight.shape))))
    p, s = variables["params"], variables["state"]
    for i, bn in enumerate(pm.decoder.prenet.bns):
        p["decoder"]["prenet"]["bns"][i]["scale"] = jnp.asarray(bn.weight.detach().numpy())
        s["decoder"]["prenet"]["bns"][i]["var"] = jnp.asarray(bn.running_var.numpy())
    enc, lengths, _ = decode_inputs(jm, p, ())
    ref = jm.decoder.inference(p["decoder"], s["decoder"], jnp.asarray(enc),
                               jnp.asarray(lengths), None, 8)
    got = pm.decoder.inference(torch.from_numpy(enc), torch.from_numpy(lengths), 8, 2,
                               dtype=torch.float32)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    # past a row's stop the scan freezes its state, the kernel route does
    # not: alignments agree up to each row's length
    for row, n in enumerate(np.asarray(ref[3]) // 2):
        np.testing.assert_allclose(got[1][row, :n].numpy(), np.asarray(ref[1])[row, :n],
                                   atol=1e-4)


def test_decoder_inference_slices_active_r():
    """r_init 3 sizes the projection for 3 frames; decoding at r=2 takes the
    prefix and feeds back frame r - 1 of the group."""
    cfg = dict(SMALL, r=2, prenet_dropout=False)
    jm = JaxTacotron2(CHARS, JaxModelConfig(**cfg), n_mels=N_MELS, r_init=3)
    v = jm.init(jax.random.PRNGKey(1))
    pm = Tacotron2(CHARS, ModelConfig(**cfg), n_mels=N_MELS, r_init=3, device="cpu")
    pm.load_state_dict(params_from_jax(v["params"], v["state"]))
    enc, lengths, _ = decode_inputs(jm, v["params"], ())
    ref = jm.decoder.inference(v["params"]["decoder"], v["state"]["decoder"],
                               jnp.asarray(enc), jnp.asarray(lengths), None, 6, r=2)
    got = pm.decoder.inference(torch.from_numpy(enc), torch.from_numpy(lengths), 6, 2,
                               dtype=torch.float32)
    assert got[0].shape == (B, 12, N_MELS)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)


def test_sequence_mask_matches_jax():
    from your_voice_tts_torch.models.common import sequence_mask
    lengths = np.array([3, 0, 5])
    np.testing.assert_array_equal(
        sequence_mask(torch.from_numpy(lengths), 5).numpy(),
        np.asarray(jax_sequence_mask(jnp.asarray(lengths), 5)))


def test_unsupported_attention_raises():
    """Every attention variant of the JAX package builds (their decode is
    held in tests/test_torch_attention_variants.py); an unknown attention
    type raises. The name is historical: the variants in Tacotron(1), whose
    decode kernel has none, raised until they took the step loop; now each
    builds and routes off the kernel, as the JAX package's
    `taco1_supported` sends them to its scan (held in
    tests/test_torch_taco1_variants.py)."""
    from your_voice_tts_torch.models.tacotron import Tacotron

    with pytest.raises(ValueError, match="unknown attention type"):
        Tacotron2(CHARS, dataclasses.replace(ModelConfig(**SMALL), attention_type="dca"),
                  n_mels=N_MELS, device="cpu")
    for kw in (dict(attention_type="graves"), dict(windowing=True),
               dict(use_forward_attn=True), dict(transition_agent=True)):
        cfg = dataclasses.replace(ModelConfig(**SMALL), **kw)
        Tacotron2(CHARS, cfg, n_mels=N_MELS, device="cpu")
        taco1 = Tacotron(CHARS, dataclasses.replace(cfg, model="Tacotron", tacotron_width=32,
                                                    memory_size=5), n_mels=N_MELS, num_freq=33,
                         device="cpu")
        assert not taco1.decoder.kernel_supported(), kw
    with pytest.raises(ValueError, match="unknown attention type"):
        Tacotron(CHARS, dataclasses.replace(ModelConfig(**SMALL), model="Tacotron",
                                            tacotron_width=32, memory_size=5,
                                            attention_type="dca"),
                 n_mels=N_MELS, num_freq=33, device="cpu")
