"""The port's WaveRNN against the JAX package on the CPU: the plain sample
loop against the Pallas kernel (interpret mode) in every I/O mode, against
the XLA scan, the mu-law helpers, folding, the upsample network, and
`WaveRNN.generate` end to end.

The small WaveRNN of tests/test_pallas_kernels.py (n_mels 20, R = F = 32,
upsample (4, 4, 2)), three fold rows of 128 steps; inputs from numpy seeds,
JAX weights mapped onto the port by `params_from_jax`. Each Pallas
call runs in interpret mode at a chunk of 64 steps (a few seconds a call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import your_voice_tts_tpu.ops.pallas.wavernn_gen as jax_gen
from your_voice_tts_tpu.vocoder.models import wavernn as jw
from your_voice_tts_torch.ops.wavernn_gen import (generation_weights, wavernn_generate,
                                                  wavernn_generate_plain)
from your_voice_tts_torch.train.checkpoint import params_from_jax
from your_voice_tts_torch.vocoder.models import wavernn as pw

torch.set_num_threads(1)

SMALL = dict(n_mels=20, rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
             num_res_blocks=2, pad=2, upsample_factors=(4, 4, 2))


def pair(bits=8, mode="mulaw", num_mixtures=4):
    """(JAX model, JAX params, port model with the same weights)."""
    jm = jw.WaveRNN(bits=bits, mode=mode, num_mixtures=num_mixtures, **SMALL)
    p = jm.init(jax.random.PRNGKey(0))
    port = pw.WaveRNN(bits=bits, mode=mode, num_mixtures=num_mixtures, device="cpu", **SMALL)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p), {}))
    return jm, p, port


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 128, 20)).astype(np.float32),
            rng.standard_normal((3, 128, 16)).astype(np.float32))


def classes(samples, bits):
    return pw.encode_mulaw(torch.from_numpy(np.array(samples)), bits).numpy()


# (mode, bits, greedy, seed): mu-law greedy and sampled; bits=6 pins the
# Gumbel draw's lane-padded width (128, not 64 classes); MoL and Gaussian
# sampled
MODES = [("mulaw", 8, True, 0), ("mulaw", 8, False, 7), ("mulaw", 6, False, 7),
         ("mol", 8, False, 7), ("gauss", 8, False, 7)]


@pytest.mark.parametrize("mode,bits,greedy,seed", MODES)
def test_plain_matches_pallas_kernel(inputs, mode, bits, greedy, seed):
    """Same hash-PRNG draws on both sides: mu-law classes identical,
    samples within 1e-5 (float32 sums in another order, 128 recurrent
    steps; measured ~1e-6)."""
    cond, aux = inputs
    _, p, port = pair(bits, mode)
    got = wavernn_generate(generation_weights(port), torch.from_numpy(cond),
                           torch.from_numpy(aux), seed, bits=bits, mode=mode,
                           num_mixtures=4, greedy=greedy).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_gen.wavernn_generate_pallas(
            p, jnp.asarray(cond), jnp.asarray(aux), seed, bits=bits, chunk=64, mode=mode,
            num_mixtures=4, greedy=greedy))
    assert got.shape == ref.shape == (3, 128)
    if mode == "mulaw":
        np.testing.assert_array_equal(classes(got, bits), classes(ref, bits))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got).max() <= 1.0 and got.std() > 1e-2


def test_plain_greedy_matches_xla_scan(inputs):
    """Greedy plain loop against WaveRNN.generate_fold (the XLA scan), at
    the JAX package's own kernel-vs-scan tolerance, 1e-4."""
    cond, aux = inputs
    jm, p, port = pair()
    got = wavernn_generate_plain(generation_weights(port), torch.from_numpy(cond),
                                 torch.from_numpy(aux), 0, bits=8, greedy=True)
    ref = jm.generate_fold(p, jnp.asarray(cond), jnp.asarray(aux), jax.random.PRNGKey(2),
                           greedy=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("bits", [8, 10])
def test_mulaw_helpers_match_jax(bits):
    x = np.random.default_rng(1).uniform(-1, 1, 4096).astype(np.float32)
    cls = np.arange(2 ** bits, dtype=np.int32)
    np.testing.assert_array_equal(pw.encode_mulaw(torch.from_numpy(x), bits).numpy(),
                                  np.asarray(jw.encode_mulaw(jnp.asarray(x), bits)))
    np.testing.assert_allclose(pw.decode_mulaw(torch.from_numpy(cls), bits).numpy(),
                               np.asarray(jw.decode_mulaw(jnp.asarray(cls), bits)), atol=1e-6)
    np.testing.assert_allclose(pw.label_to_float(torch.from_numpy(cls), bits).numpy(),
                               np.asarray(jw.label_to_float(jnp.asarray(cls), bits)), atol=1e-7)


@pytest.mark.parametrize("L,target,overlap", [(1000, 200, 20), (150, 200, 20), (777, 64, 16)])
def test_fold_and_unfold_match_jax(L, target, overlap):
    """Folding is a copy (exact); the crossfade sums two faded copies
    (1e-6: the fade ramps' float32 rounding)."""
    x = np.random.default_rng(2).standard_normal((L, 5)).astype(np.float32)
    got = pw.fold_with_overlap(torch.from_numpy(x), target, overlap).numpy()
    ref = np.asarray(jw.fold_with_overlap(jnp.asarray(x), target, overlap))
    np.testing.assert_array_equal(got, ref)
    y = got[..., 0]
    np.testing.assert_allclose(pw.xfade_and_unfold(torch.from_numpy(y), target, overlap).numpy(),
                               np.asarray(jw.xfade_and_unfold(jnp.asarray(y), target, overlap)),
                               atol=1e-6)


def test_upsample_network_matches_jax():
    """cond and aux of the conditioning network, float32 convolutions:
    within 1e-5."""
    jm, p, port = pair()
    mel = np.random.default_rng(3).standard_normal((2, 12, 20)).astype(np.float32)
    cond, aux = port.upsample(torch.from_numpy(mel))
    rc, ra = jm.upsample(p["upsample"], jnp.asarray(mel))
    assert cond.shape == rc.shape == (2, 8 * 32, 20) and aux.shape == ra.shape == (2, 256, 16)
    np.testing.assert_allclose(cond.detach().numpy(), np.asarray(rc), atol=1e-5)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(ra), atol=1e-5)


def test_generate_matches_jax_kernel_route(monkeypatch):
    """mel -> upsample -> 3 folds of 96 steps -> sample loop -> crossfade,
    against JAX generate(use_pallas=True) with the seed the JAX side draws
    from its key. The Pallas call runs at a 64-step chunk instead of its
    default 1024 (interpret-mode cost); the JAX package's
    test_wavernn_pallas_sampled_chunk_invariance shows the output does not
    depend on it. Classes identical, samples within 1e-5."""
    monkeypatch.setattr(jax_gen, "default_chunk", lambda *a, **k: 64)
    jm, p, port = pair()
    mel = np.random.default_rng(4).standard_normal((10, 20)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jm.generate(p, jnp.asarray(mel), key, target=64, overlap=16,
                                     use_pallas=True))
    got = port.generate(torch.from_numpy(mel), seed, target=64, overlap=16).numpy()
    assert got.shape == ref.shape == (6 * 32,)
    np.testing.assert_array_equal(classes(got, 8), classes(ref, 8))
    np.testing.assert_allclose(got, ref, atol=1e-5)
