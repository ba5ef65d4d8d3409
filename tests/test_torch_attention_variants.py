"""Kernel 1's attention variants on the CPU: the port's plain decode with
windowing, forward attention (transition agent, forward mask) and Graves
GMM attention against the JAX package's Pallas decode kernel in interpret
mode, with the same weights (carried by params_from_jax, or by a checkpoint
the JAX package writes) and numpy inputs from seeds; the model's route
(`Tacotron2.inference`, `inference_truncated`) against the JAX kernel
route; the Trainer's refusals; windowing training as plain attention.

Tolerances: float32 differs from the interpreter by sum order only
(frames 2e-4, alignments 1e-4, as the JAX package's kernel-vs-scan tests,
tests/test_pallas_kernels.py); bf16 rounds every matrix input on both
sides (5e-3 / 2e-3, as tests/test_torch_stream.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from your_voice_tts_tpu.ops.pallas.taco2_decode import tacotron2_decode_pallas
from your_voice_tts_torch.config import ModelConfig
from your_voice_tts_torch.models.attention import GravesAttention, LocationSensitiveAttention
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.ops.taco2_decode import (GRAVES, LOCATION, OPTIONS, attention_route,
                                                   held_steps, tacotron2_decode)
from your_voice_tts_torch.train.checkpoint import load_checkpoint, params_from_jax

torch.set_num_threads(1)

N_MELS, CHARS, B, T_TEXT, STEPS = 20, 30, 4, 12, 20
SMALL = dict(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
             attention_rnn_dim=48, attention_dim=24, attention_location_filters=8,
             attention_location_kernel_size=15, prenet_dim=24, postnet_dim=32,
             max_decoder_steps=STEPS, prenet_dropout=True)
# the JAX package's variants (tests/test_pallas_kernels.py) and Graves
VARIANTS = {
    "windowing": dict(windowing=True),
    "forward": dict(use_forward_attn=True),
    "forward_ta": dict(use_forward_attn=True, transition_agent=True),
    "forward_mask": dict(use_forward_attn=True, forward_attn_mask=True),
    "window_forward": dict(windowing=True, use_forward_attn=True),
    "softmax_window": dict(attention_norm="softmax", windowing=True),
    "graves": dict(attention_type="graves"),
}
FORWARD_TA_MASK = dict(use_forward_attn=True, transition_agent=True, forward_attn_mask=True)
F32_TOL, BF16_TOL = (2e-4, 1e-4), (5e-3, 2e-3)


def models(variant: dict, seed: int = 0, **cfg):
    """(JAX model, its variables, the port model with the same weights)."""
    kw = dict(SMALL, **variant, **cfg)
    jm = JaxTacotron2(CHARS, JaxModelConfig(**kw), n_mels=N_MELS)
    v = jm.init(jax.random.PRNGKey(seed))
    pm = Tacotron2(CHARS, ModelConfig(**kw), n_mels=N_MELS, device="cpu")
    pm.load_state_dict(params_from_jax(v["params"], v["state"]), strict=True)
    return jm, v, pm


def memory(jm, v, seed: int = 1):
    """Encoder memory [B, T, E] of seeded random text through the JAX
    encoder, lengths [B], mask, and W_k m (None for Graves), numpy."""
    p, s = v["params"], v["state"]
    rng = np.random.default_rng(seed)
    text = rng.integers(1, CHARS, (B, T_TEXT))
    lengths = np.array([T_TEXT, T_TEXT - 2, T_TEXT - 4, T_TEXT - 5])
    enc, _ = jm.encoder(p["encoder"], s["encoder"], jm.embedding(p["embedding"], text),
                        jnp.asarray(lengths), None, train=False)
    pinp = jm.decoder.attention.preprocess_inputs(p["decoder"]["attention"], enc)
    mask = np.arange(T_TEXT)[None, :] < lengths[:, None]
    return (np.asarray(enc), lengths, mask, None if pinp is None else np.asarray(pinp))


def decode_both(variant: dict, dtype: str, seed: int = 0):
    """The JAX Pallas decode (interpret mode) and the port's plain decode on
    the same weights and memory, with the variant's flags."""
    jm, v, pm = models(variant, seed)
    enc, lengths, mask, pinp = memory(jm, v)
    flags = jm.decoder._attn_kernel_flags()
    kw = dict(r=2, max_steps=STEPS, chunk=5, seed=7, prenet_dropout=True,
              norm=getattr(jm.decoder.attention, "norm", "sigmoid"))
    ref = tacotron2_decode_pallas(
        v["params"]["decoder"], jnp.asarray(enc), None if pinp is None else jnp.asarray(pinp),
        jnp.asarray(mask), n_mels=N_MELS, interpret=True, dtype=getattr(jnp, dtype),
        **kw, **flags)
    got = tacotron2_decode(
        pm.decoder.decode_weights(getattr(torch, dtype)), torch.from_numpy(enc),
        None if pinp is None else torch.from_numpy(pinp), torch.from_numpy(mask),
        **kw, **pm.decoder.attn_kernel_flags())
    return got, ref


def hold(got, ref, tol):
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=tol[0],
                               err_msg="frames")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=tol[1],
                               err_msg="alignments")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=tol[1],
                               err_msg="stops")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_plain_matches_pallas_float32(variant):
    got, ref = decode_both(VARIANTS[variant], "float32")
    hold(got, ref, F32_TOL)
    assert float(got[1].abs().sum()) > 0


@pytest.mark.parametrize("variant", ["forward_ta_mask", "graves"])
def test_variant_plain_matches_pallas_bf16(variant):
    got, ref = decode_both(FORWARD_TA_MASK if variant == "forward_ta_mask"
                           else VARIANTS["graves"], "bfloat16")
    hold(got, ref, BF16_TOL)


def test_attention_modules_and_flags():
    """init_attn builds each variant under the JAX package's names; the
    decoder's flags are the JAX route's; Graves's l2 bias starts at 10.0 for
    the widths and 0.5 for the steps, its means at 0."""
    jm, _, pm = models(FORWARD_TA_MASK, windowing=True, win_back=2, win_front=4)
    a = pm.decoder.attention
    assert isinstance(a, LocationSensitiveAttention) and a.ta.weight.shape == (1, 32 + 48)
    want = jm.decoder._attn_kernel_flags()
    want.pop("loc_attn")
    assert pm.decoder.attn_kernel_flags() == want
    g = Tacotron2(CHARS, ModelConfig(**SMALL, attention_type="graves", attention_heads=3),
                  n_mels=N_MELS, device="cpu").decoder.attention
    assert isinstance(g, GravesAttention) and g.K == 3
    assert g.l1.weight.shape == (48, 48) and g.l2.weight.shape == (9, 48)
    assert g.l2.bias[:3].eq(0).all() and g.l2.bias[3:6].eq(10).all()
    assert g.l2.bias[6:].eq(0.5).all()
    assert g.preprocess_inputs(torch.zeros(1, 2, 32)) is None
    with pytest.raises(ValueError, match="unknown attention type"):
        Tacotron2(CHARS, ModelConfig(**SMALL, attention_type="gmmv2"), n_mels=N_MELS,
                  device="cpu")


def test_attention_routes_and_refusals():
    """What the decode serves: options act only with windowing or forward
    attention; Graves takes none of them; the agent needs its weights."""
    loc = models({})[2].decoder.decode_weights(torch.float32)
    assert attention_route(loc) == LOCATION
    assert attention_route(loc, trans_agent=True, forward_attn_mask=True) == LOCATION
    assert attention_route(loc, windowing=True) == OPTIONS
    with pytest.raises(ValueError, match="transition agent needs its weights"):
        attention_route(loc, forward_attn=True, trans_agent=True)
    graves = models(VARIANTS["graves"])[2].decoder.decode_weights(torch.float32)
    assert attention_route(graves) == GRAVES and graves["dims"]["GK"] == 4
    with pytest.raises(ValueError, match="Graves attention takes none"):
        attention_route(graves, windowing=True)


@pytest.mark.parametrize("variant", ["forward_ta_mask", "graves"])
def test_checkpoint_inference_matches_the_jax_kernel_route(variant, tmp_path):
    """A JAX-initialised model of each kind, written by the JAX package's
    checkpoint writer and loaded strictly by the port: Tacotron2.inference
    (bf16 decode, float32 encoder and postnet) against the JAX
    `Decoder.inference_pallas` in interpret mode on the JAX encoder's
    memory, prenet dropout on (the hash PRNG is bit-exact)."""
    from your_voice_tts_tpu.train.checkpoint import save_checkpoint

    flags = FORWARD_TA_MASK if variant == "forward_ta_mask" else VARIANTS[variant]
    cfg = dict(SMALL, **flags)
    jm = JaxTacotron2(CHARS, JaxModelConfig(**cfg), n_mels=N_MELS)
    v = jm.init(jax.random.PRNGKey(3))
    path = save_checkpoint(str(tmp_path / "model.npz"), params=v["params"],
                           model_state=v["state"], opt_state={}, step=1, epoch=0, r=2)
    pm = Tacotron2(CHARS, ModelConfig(**cfg), n_mels=N_MELS, device="cpu")
    load_checkpoint(pm, path)
    enc, lengths, _, _ = memory(jm, v, seed=4)
    text = np.random.default_rng(4).integers(1, CHARS, (B, T_TEXT))
    p, s = v["params"], v["state"]
    ref = jm.decoder.inference_pallas(p["decoder"], jnp.asarray(enc), jnp.asarray(lengths),
                                      STEPS, seed=5, interpret=True, state=s["decoder"])
    got = pm.inference(text, lengths, seed=5)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got["decoder_outputs"].numpy(), np.asarray(ref[0]),
                               atol=BF16_TOL[0])
    np.testing.assert_allclose(got["alignments"].numpy(), np.asarray(ref[1]),
                               atol=BF16_TOL[1])
    np.testing.assert_allclose(got["stop_probs"].numpy(), np.asarray(ref[2]),
                               atol=BF16_TOL[1])


def test_inference_truncated_forward_attention_matches_pallas():
    """Two chained chunks of a forward-attention model: the LSTM state
    streams, the attention (alpha) starts afresh each chunk; the port's
    decoder against the JAX `inference_truncated_pallas` (interpret mode,
    float32) on the same memories."""
    cfg = dict(SMALL, use_forward_attn=True)
    jm = JaxTacotron2(CHARS, JaxModelConfig(**cfg), n_mels=N_MELS)
    v = jm.init(jax.random.PRNGKey(6))
    v["params"]["decoder"]["stopnet"]["b"] = jnp.full_like(
        v["params"]["decoder"]["stopnet"]["b"], -10.0)       # no row stops
    pm = Tacotron2(CHARS, ModelConfig(**cfg), n_mels=N_MELS, device="cpu")
    pm.load_state_dict(params_from_jax(v["params"], v["state"]), strict=True)
    ref_stream = got_stream = None
    for seed in (7, 8):
        enc, lengths, _, _ = memory(jm, v, seed)
        ref = jm.decoder.inference_truncated_pallas(
            v["params"]["decoder"], jnp.asarray(enc), jnp.asarray(lengths), 10, seed=seed,
            stream=ref_stream, interpret=True, state=v["state"]["decoder"])
        ref_stream = ref[4]
        got = pm.decoder.inference_truncated(torch.from_numpy(enc), torch.from_numpy(lengths),
                                             10, 2, seed=seed, dtype=torch.bfloat16,
                                             stream=got_stream)
        got_stream = got[4]
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        for i, (name, tol) in enumerate((("frames", 5e-3), ("alignments", 2e-3),
                                         ("stops", 2e-3))):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), atol=tol,
                                       err_msg=f"chunk {seed - 6} {name}")
        (h1, c1), (h2, c2), fr = got_stream
        (rh1, rc1), (rh2, rc2), rfr = ref_stream
        for a, b in ((h1, rh1), (c1, rc1), (h2, rh2), (c2, rc2), (fr, rfr)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """An 8-item sr=8000 synthetic corpus for the Trainers below."""
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus

    return make_synthetic_corpus(str(tmp_path_factory.mktemp("variants")), n_items=8, sr=8000)


@pytest.mark.parametrize("flags,match", [
    (dict(use_forward_attn=True), "use_forward_attn"),
    (dict(use_forward_attn=True, transition_agent=True), "use_forward_attn"),
    (dict(transition_agent=True), "transition_agent"),
    (dict(attention_type="graves"), "Graves"),
])
def test_trainer_refuses_variants_before_reading_data(corpus, flags, match):
    """The name is historical: the Trainer once refused these configs (the
    option `match` names) before reading data. They train now, on the JAX
    package's scan route (tests/test_torch_train_variants.py holds them
    against it): the Trainer builds on each config and its corpus, its
    decoder takes the step loop, and one train step with dropout gives
    finite losses and moves the weights; the refusal and its message are
    gone."""
    import inspect

    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.train.trainer import Trainer

    cfg = load_config("configs/smoke_synthetic.json")
    ds = dataclasses.replace(cfg.data.datasets[0], path=corpus)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **flags),
                              data=dataclasses.replace(cfg.data, datasets=(ds,)))
    trainer = Trainer(cfg, device="cpu", verbose=False)
    assert not trainer.model.decoder.fast_grad_supported(), match
    before = [p.detach().clone() for p in trainer.params]
    metrics = trainer.train_step(next(trainer.train_data.batches(4, 2)), 2)
    assert all(np.isfinite(v) for v in metrics.values()), (match, metrics)
    assert any(not torch.equal(a, b) for a, b in zip(before, trainer.params)), match
    assert "later slice" not in inspect.getsource(Trainer.__init__)


@pytest.mark.parametrize("flags,match", [
    (dict(use_forward_attn=True), "forward_attn"),
    (dict(use_forward_attn=True, transition_agent=True, forward_attn_mask=True),
     "forward_attn"),
    (dict(transition_agent=True), "trans_agent"),
    (dict(attention_type="graves"), "Graves"),
])
def test_teacher_forced_pass_refuses_variants(flags, match):
    """The name is historical: the teacher-forced pass once refused these
    configs. It now runs them as the JAX package does, through the step
    loop (`Decoder._scan`, the JAX `lax.scan` over `_step`; the agent alone,
    without forward attention, too, as the JAX package routes it): frames,
    alignments and stop logits against the JAX `Decoder.forward` within
    1e-5 (tests/test_decoder_grad.py's tolerance between the JAX routes),
    dropout off, on seeded memory with rows of their own lengths."""
    jm, v, pm = models(flags, seed=2)
    assert not pm.decoder.fast_grad_supported() and not jm.decoder.fast_grad_supported(), match
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((B, T_TEXT, 32)).astype(np.float32)
    lengths = np.array([T_TEXT, T_TEXT - 3, T_TEXT - 5, 4])
    mels = rng.standard_normal((B, 16, N_MELS)).astype(np.float32)
    ref = jax.jit(lambda p, e, m: jm.decoder.forward(
        p, v["state"]["decoder"], e, jnp.asarray(lengths), m, None, True, r=2)[:3])(
        v["params"]["decoder"], jnp.asarray(enc), jnp.asarray(mels))
    got = pm.train().decoder(torch.from_numpy(enc), torch.from_numpy(lengths),
                             torch.from_numpy(mels), 2)
    for a, b, name in zip(got, ref, ("frames", "alignments", "stops")):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=0,
                                   err_msg=f"{match}: {name}")


def test_windowing_trains_as_plain_location_attention():
    """Windowing acts at inference only (the JAX package's `_apply_windowing`
    with inference=False, and its teacher-forced scan): the teacher-forced
    pass of a windowing model equals the same weights' without windowing,
    and the JAX package's teacher-forced pass."""
    jm, v, win = models(dict(windowing=True), prenet_dropout=False)
    plain = Tacotron2(CHARS, ModelConfig(**dict(SMALL, prenet_dropout=False)), n_mels=N_MELS,
                      device="cpu")
    plain.load_state_dict(win.state_dict())
    rng = np.random.default_rng(9)
    text = rng.integers(1, CHARS, (2, 8))
    lengths = np.array([8, 6])
    mels = (0.5 * rng.standard_normal((2, 12, N_MELS))).astype(np.float32)
    args = (torch.from_numpy(text), torch.from_numpy(lengths), torch.from_numpy(mels))
    got, base = win.eval()(*args), plain.eval()(*args)
    for k in ("decoder_outputs", "postnet_outputs", "alignments", "stop_logits"):
        assert torch.equal(got[k], base[k]), k
    ref = jm.forward(v, jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(mels),
                     train=False)
    np.testing.assert_allclose(got["decoder_outputs"].detach().numpy(),
                               np.asarray(ref["decoder_outputs"]), atol=1e-4)
    np.testing.assert_allclose(got["alignments"].detach().numpy(),
                               np.asarray(ref["alignments"]), atol=1e-4)


def test_mask_and_window_follow_the_pallas_kernel():
    """The plain decode's window centre starts at 0 and is the first maximum:
    at step 0 only positions 0-3 of the default window (back 1, front 3)
    carry weight."""
    jm, v, pm = models(dict(windowing=True))
    enc, lengths, mask, pinp = memory(jm, v)
    got = tacotron2_decode(pm.decoder.decode_weights(torch.float32), torch.from_numpy(enc),
                           torch.from_numpy(pinp), torch.from_numpy(mask), r=2, max_steps=3,
                           windowing=True)
    assert float(got[1][0, :, 4:].abs().max()) == 0.0
    assert torch.allclose(got[1][0].sum(-1), torch.ones(B))


def test_held_steps_hold_a_window_fork_and_a_mask_tie():
    """How far a kernel decode is held against the plain one: every step
    without a maximum; a window's fork step too (it ran with the same
    centre); a forward mask's steps before its fork, with the plain
    version's tie gap there."""
    g = torch.Generator().manual_seed(0)
    ref = (torch.randn(5, 2, 6, generator=g),
           torch.softmax(torch.randn(5, 2, 6, generator=g), -1),
           torch.rand(5, 2, generator=g), torch.tensor([5, 5]))
    got = tuple(t.clone() for t in ref)
    assert held_steps(got, ref, windowing=True) == (5, None, None)
    row = got[1][2, 1]
    p = int(row.argmax())
    k = (p + 2) % 6
    row[k] = row[p] + 1e-4                   # the other side of a near tie
    assert held_steps(got, ref, forward_attn=True) == (5, None, None)
    assert held_steps(got, ref, windowing=True) == (3, 2, None)
    premask = list(ref[1])
    n, fork, gap = held_steps(got, ref, premask, forward_attn=True, forward_attn_mask=True)
    assert (n, fork) == (2, 2)
    assert gap == pytest.approx(float(ref[1][2, 1, p] - ref[1][2, 1, k]))
    with pytest.raises(TypeError, match="unknown attention options"):
        held_steps(got, ref, window=True)


def test_plain_decode_records_the_alignment_before_the_forward_mask():
    """`premask` leaves the decode as it is and gets a step's alignment
    before the mask, whose first maximum is the masked alignment's (the
    mask keeps it and what lies ahead of it)."""
    jm, v, pm = models(FORWARD_TA_MASK)
    enc, lengths, mask, pinp = memory(jm, v)
    args = (pm.decoder.decode_weights(torch.float32), torch.from_numpy(enc),
            torch.from_numpy(pinp), torch.from_numpy(mask))
    kw = dict(r=2, max_steps=STEPS, chunk=STEPS, **pm.decoder.attn_kernel_flags())
    premask = []
    got = tacotron2_decode(*args, premask=premask, **kw)
    assert len(premask) == STEPS
    for a, b in zip(tacotron2_decode(*args, **kw), got):
        assert torch.equal(a, b)
    pre = torch.stack(premask)
    assert torch.equal(pre.argmax(-1), got[1].argmax(-1))
    assert torch.allclose(pre.sum(-1), torch.ones(STEPS, B))
    assert not torch.allclose(pre, got[1])
