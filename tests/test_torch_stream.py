"""Kernel 1's stream state and streaming synthesis, on the CPU: the port's
plain decode with `stream=` / `return_stream` against the JAX package's
Pallas decode kernel in interpret mode, and the port's
`Tacotron2.inference_truncated` against the JAX kernel route over chained
text chunks, with the same weights and numpy inputs from seeds.

The Pallas interpreter does not take the kernel's early exit (it keeps
decoding once every row is done), so the stream out is held where no row
stops before the last chunk; the freeze at the all-done chunk boundary is
held against the plain version's own shorter run, and on the card
(`chip_smoke.py`'s server phase, `tests/test_torch_cuda.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from your_voice_tts_tpu.ops.pallas.taco2_decode import tacotron2_decode_pallas
from your_voice_tts_torch.config import ModelConfig
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode
from your_voice_tts_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

N_MELS, CHARS, B, T = 20, 30, 4, 12
SMALL = dict(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
             attention_rnn_dim=48, attention_dim=24,
             attention_location_filters=8, attention_location_kernel_size=15,
             prenet_dim=24, postnet_dim=32, max_decoder_steps=12, prenet_dropout=True)
H1 = H2 = 48
# dtype -> (frames and stream tolerance, alignments / stops tolerance):
# float32 differs from the interpreter by sum order only; bf16 rounds every
# matrix input on both sides (tests/test_torch_decode.py)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-3, 2e-3)}


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port model with the same weights)."""
    jm = JaxTacotron2(CHARS, JaxModelConfig(**SMALL), n_mels=N_MELS)
    v = jm.init(jax.random.PRNGKey(0))
    pm = Tacotron2(CHARS, ModelConfig(**SMALL), n_mels=N_MELS, device="cpu")
    pm.load_state_dict(params_from_jax(v["params"], v["state"]))
    return jm, v, pm


def memory(jm, params, seed, stop_rows=()):
    """Encoder memory [B, T, E] from a seed, its mask and W_k m; rows in
    `stop_rows` get the folded stop row's context direction, so they stop
    at their first step."""
    p = params["decoder"]
    rng = np.random.default_rng(seed)
    enc = (0.5 * rng.standard_normal((B, T, SMALL["encoder_dim"]))).astype(np.float32)
    c = np.asarray(p["projection"]["w"])[H2:] @ np.asarray(p["stopnet"]["w"])[H2:, 0]
    for row in stop_rows:
        enc[row] += 8.0 * c / (c @ c)
    mask = np.arange(T)[None, :] < np.array([12, 10, 8, 7])[:, None]
    pinp = np.array(jm.decoder.attention.preprocess_inputs(p["attention"], jnp.asarray(enc)))
    return enc, mask, pinp


def seeded_stream(seed):
    """((h1, c1), (h2, c2), frame) as numpy, float32, from a seed."""
    rng = np.random.default_rng(seed)
    h1, h2 = (np.tanh(rng.standard_normal((B, H))).astype(np.float32) for H in (H1, H2))
    c1, c2 = (rng.standard_normal((B, H)).astype(np.float32) for H in (H1, H2))
    frame = rng.standard_normal((B, N_MELS)).astype(np.float32)
    return (h1, c1), (h2, c2), frame


def flat(stream):
    (h1, c1), (h2, c2), frame = stream
    return [np.asarray(t) for t in (h1, c1, h2, c2, frame)]


def as_torch(stream):
    (h1, c1), (h2, c2), frame = (tuple(map(np.asarray, p)) if isinstance(p, tuple)
                                 else np.asarray(p) for p in stream)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return (t(h1), t(c1)), (t(h2), t(c2)), t(frame)


def both(models, dtype, enc, mask, pinp, jax_stream, port_stream, **kw):
    """(JAX kernel outputs, port outputs), each with its stream out."""
    jm, v, pm = models
    ref = tacotron2_decode_pallas(
        v["params"]["decoder"], jnp.asarray(enc), jnp.asarray(pinp), jnp.asarray(mask),
        n_mels=N_MELS, interpret=True, dtype=getattr(jnp, dtype), stream=jax_stream,
        return_stream=True, **kw)
    got = tacotron2_decode(
        pm.decoder.decode_weights(getattr(torch, dtype)), torch.from_numpy(enc),
        torch.from_numpy(pinp), torch.from_numpy(mask), stream=port_stream,
        return_stream=True, **kw)
    return ref, got


def assert_decode_close(ref, got, tol):
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=tol[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=tol[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=tol[1])
    for name, a, b in zip(("h1", "c1", "h2", "c2", "frame"), flat(got[4]), flat(ref[4])):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=tol[0], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_from_a_stream_matches_pallas(models, dtype):
    """A seeded stream in; outputs and the stream out against the
    interpreter's. Row 0 stops at once: its fed-back frame, and so its
    stream frame, is zero from then on while its LSTMs keep running."""
    jm, v, _ = models
    enc, mask, pinp = memory(jm, v["params"], 3, stop_rows=(0,))
    stream = seeded_stream(11)
    kw = dict(r=2, max_steps=12, chunk=4, seed=7, prenet_dropout=True)
    ref, got = both(models, dtype, enc, mask, pinp, stream, as_torch(stream), **kw)
    assert int(np.asarray(ref[3])[0]) == 1 and np.asarray(ref[3]).max() == 12
    assert not got[4][2][0].any()
    assert_decode_close(ref, got, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_chunks_match_pallas(models, dtype):
    """Chunk 1 fresh, chunk 2 from each side's own chunk-1 stream, on
    another memory: the chain agrees, and chunk 2 differs from a cold
    start."""
    jm, v, _ = models
    kw = dict(r=2, max_steps=8, chunk=4, seed=3, prenet_dropout=True)
    ref1, got1 = both(models, dtype, *memory(jm, v["params"], 4), None, None, **kw)
    assert_decode_close(ref1, got1, TOL[dtype])
    ref2, got2 = both(models, dtype, *memory(jm, v["params"], 5), ref1[4], got1[4], **kw)
    assert_decode_close(ref2, got2, TOL[dtype])
    cold = tacotron2_decode(models[2].decoder.decode_weights(getattr(torch, dtype)),
                            *map(torch.from_numpy, memory(jm, v["params"], 5)[::2]),
                            torch.from_numpy(memory(jm, v["params"], 5)[1]), **kw)
    assert not torch.allclose(cold[0], got2[0], atol=1e-2)


def test_stream_out_after_whole_chunks(models):
    """max_steps 10 with chunk 4: the kernel decodes 12 steps, and the
    stream out is the state after step 12 (the interpreter's), the same
    as a 12-step decode's, not the state after step 10."""
    jm, v, pm = models
    enc, mask, pinp = memory(jm, v["params"], 6)
    kw = dict(r=2, chunk=4, seed=5, prenet_dropout=True)
    ref, got = both(models, "float32", enc, mask, pinp, None, None, max_steps=10, **kw)
    assert got[0].shape[0] == 10
    assert_decode_close(ref, got, TOL["float32"])
    w = pm.decoder.decode_weights(torch.float32)
    args = [torch.from_numpy(a) for a in (enc, pinp, mask)]
    twelve = tacotron2_decode(w, *args, max_steps=12, return_stream=True, **kw)
    ten = tacotron2_decode(w, *args, max_steps=10, chunk=10, seed=5, r=2,
                           prenet_dropout=True, return_stream=True)
    for a, b, c in zip(flat(got[4]), flat(twelve[4]), flat(ten[4])):
        assert np.array_equal(a, b) and not np.allclose(a, c)


def test_stream_freezes_at_the_all_done_boundary(models):
    """Every row stops at its first step: the decode leaves at the first
    chunk boundary (step 4), and the stream out is the state after step 4,
    as a 4-step decode leaves it, not after 12."""
    jm, v, pm = models
    enc, mask, pinp = memory(jm, v["params"], 3, stop_rows=range(B))
    w = pm.decoder.decode_weights(torch.float32)
    args = [torch.from_numpy(a) for a in (enc, pinp, mask)]
    stream = as_torch(seeded_stream(12))
    kw = dict(r=2, seed=7, prenet_dropout=True, stream=stream, return_stream=True)
    full = tacotron2_decode(w, *args, max_steps=12, chunk=4, **kw)
    four = tacotron2_decode(w, *args, max_steps=4, chunk=4, **kw)
    assert full[3].tolist() == [1] * B and not full[1][4:].any()
    for a, b in zip(flat(full[4]), flat(four[4])):
        assert np.array_equal(a, b)
    assert not full[4][2].any()                    # every row done: zero frames
    # the caller's stream is read, never written
    for a, b in zip(flat(stream), flat(as_torch(seeded_stream(12)))):
        assert np.array_equal(a, b)


def test_stream_shapes_are_checked(models):
    jm, v, pm = models
    enc, mask, pinp = memory(jm, v["params"], 3)
    (h1, c1), (h2, c2), frame = as_torch(seeded_stream(1))
    bad = ((h1, c1), (h2, c2[:, :-1]), frame)
    with pytest.raises(ValueError, match="stream c2"):
        tacotron2_decode(pm.decoder.decode_weights(torch.float32),
                         *[torch.from_numpy(a) for a in (enc, pinp, mask)], r=2, max_steps=4,
                         stream=bad)


# ----------------------------------------------------------------- the model

STEPS = 16


@pytest.fixture(scope="module")
def quiet_models():
    """The small models with the stopnet bias at -10, so that no row stops
    and the interpreter's stream is comparable (see the module docstring)."""
    cfg = dict(SMALL, max_decoder_steps=STEPS)
    jm = JaxTacotron2(CHARS, JaxModelConfig(**cfg), n_mels=N_MELS)
    v = jm.init(jax.random.PRNGKey(2))
    v["params"]["decoder"]["stopnet"]["b"] = jnp.full_like(
        v["params"]["decoder"]["stopnet"]["b"], -10.0)
    pm = Tacotron2(CHARS, ModelConfig(**cfg), n_mels=N_MELS, device="cpu")
    pm.load_state_dict(params_from_jax(v["params"], v["state"]))
    return jm, v, pm


def texts(seed):
    rng = np.random.default_rng(seed)
    lengths = np.array([9, 7, 5])
    text = rng.integers(1, CHARS, (3, 9))
    text[np.arange(9)[None, :] >= lengths[:, None]] = 0
    return text, lengths


def test_inference_truncated_matches_the_jax_kernel_route(quiet_models):
    """Two chained chunks through the whole model: the JAX encoder, its
    Pallas decode in interpret mode (bf16, the kernel route's), its
    postnet, against the port's plain decode at bf16 and float32 encoder
    and postnet. Frames, alignments and stops within the decode's bf16
    tolerances; the postnet mel and the stream within the frames' 5e-3."""
    jm, v, pm = quiet_models
    ref_stream = got_stream = None
    for seed in (21, 22):
        text, lengths = texts(seed)
        with pltpu.force_tpu_interpret_mode():
            ref, ref_stream = jm.inference_truncated(
                v, jnp.asarray(text, jnp.int32), jnp.asarray(lengths, jnp.int32),
                use_pallas=True, stream_state=ref_stream)
        got, got_stream = pm.inference_truncated(text, lengths, stream_state=got_stream)
        np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(ref["mel_lengths"]))
        for key, tol in (("decoder_outputs", 5e-3), ("postnet_outputs", 5e-3),
                         ("alignments", 2e-3), ("stop_probs", 2e-3)):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=tol,
                                       err_msg=key)
        for name, a, b in zip(("h1", "c1", "h2", "c2", "frame"), flat(got_stream),
                              flat(ref_stream)):
            np.testing.assert_allclose(a, b, atol=5e-3, err_msg=name)


def test_inference_truncated_fresh_equals_inference(quiet_models):
    """The JAX package's own case: with no stream in, inference_truncated
    equals inference (here bit for bit: the same decode)."""
    pm = quiet_models[2]
    text, lengths = texts(23)
    full = pm.inference(text, lengths)
    out, stream = pm.inference_truncated(text, lengths)
    assert all(torch.equal(out[k], full[k]) for k in full)
    assert len(stream) == 3


def test_inference_truncated_streams_state_across_chunks(quiet_models):
    """The JAX package's own case: chunk 2 from chunk 1's stream differs
    from a cold chunk 2, is finite, and the same state gives the same
    output."""
    pm = quiet_models[2]
    out1, stream1 = pm.inference_truncated(*texts(24))
    assert any(np.abs(t).max() > 0 for t in flat(stream1))
    warm, _ = pm.inference_truncated(*texts(25), stream_state=stream1)
    cold, _ = pm.inference_truncated(*texts(25))
    w, c = warm["postnet_outputs"], cold["postnet_outputs"]
    assert w.shape == c.shape and torch.isfinite(w).all()
    assert not torch.allclose(w, c)
    again, _ = pm.inference_truncated(*texts(25), stream_state=stream1)
    assert torch.equal(again["postnet_outputs"], w)
