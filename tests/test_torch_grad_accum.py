"""Gradient accumulation (training.grad_accum_steps, the JAX package's
`train_step_accum`) in the port on the CPU: with a stand-in loss, two
micro-batches give the whole batch's step (tests/test_trainer.py:214-252
holds the JAX package so); with the real loss, the port's A = 2 step
against the JAX Trainer's compiled A = 2 step from the same weights and
batch (one training-kernel forward and backward a micro-batch); the
reference's four divisibility refusals with its messages; the CLI.

Dropout is off on both sides (the JAX Trainer's `_loss_fn` is given no
rng, the port's Trainer no generator). Tolerances: the stand-in step at
the JAX test's (loss 1e-6 relative, parameters rtol 2e-5 / atol 2e-6); the
real step's loss parts and gradient norm 1e-4 relative, each updated
parameter within one float32 spacing plus 1e-4 of its leaf's largest move
(or of 1e-2 of the largest move anywhere, the floor the gradient leaves
are held with; a move of ~1e-7 on a parameter of ~0.1 is read no finer
than that parameter's float32 spacing), the BatchNorm statistics threaded
through both micro-batches 1e-4 / 1e-6 (tests/test_torch_train.py's
whole-model tolerances).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import your_voice_tts_torch.models.decoder_grad as decoder_grad
from tests.test_torch_train_variants import corpus  # noqa: F401 (the shared fixture)
from tests.test_torch_train_variants import (assert_trained, batch_of, configs, port_trainer,
                                             write_config)
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_tpu.train.trainer import Trainer as JaxTrainer
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax, params_to_jax
from your_voice_tts_torch.train.trainer import Trainer

torch.set_num_threads(1)

ACCUM = (("grad_accum_steps", 2), ("batch_size", 4))


@pytest.fixture(scope="module")
def jax_trainer(corpus):
    """The JAX package's Trainer at A = 2, float32, its `_loss_fn` given no
    rng (dropout off)."""
    jcfg, _ = configs(corpus, training=ACCUM)
    jt = JaxTrainer(jcfg, verbose=False)
    loss_fn = jt._loss_fn
    jt._loss_fn = lambda params, state, batch, rng, step, r: loss_fn(params, state, batch,
                                                                     None, step, r)
    return jt


def test_accumulation_equals_the_whole_batch_on_a_stand_in_loss(corpus):
    """grad_accum_steps = 2 gives the step of the whole batch when the
    per-row terms average alike: a deterministic stand-in loss (every
    parameter's sum against each row's mean mel), micro-batches of equal
    size, the mean of their means the whole mean."""
    trainers = [port_trainer(corpus, batch_size=8, grad_accum_steps=a)
                for a in (1, 2)]
    trainers[1].model.load_state_dict(trainers[0].model.state_dict())
    for t in trainers:
        def stand_in(b, r, generator, t=t):
            s = sum(p.sum() for p in t.params)
            loss = ((b["mel"].mean(dim=(1, 2)) - s) ** 2).mean()
            return loss, {"loss": loss}, {}
        t._loss_fn = stand_in
    rng = np.random.default_rng(3)
    batch = {"text": np.ones((8, 6), np.int32), "text_lengths": np.full((8,), 6, np.int32),
             "mel": rng.standard_normal((8, 8, 20)).astype(np.float32),
             "mel_lengths": np.full((8,), 8, np.int32),
             "stop_targets": np.zeros((8, 4), np.float32)}
    whole, accum = (t.train_step(batch, 2) for t in trainers)
    assert accum["loss"] == pytest.approx(whole["loss"], rel=1e-6)
    for a, b in zip(*(t.params for t in trainers)):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=2e-5, atol=2e-6)
    assert all(t.step == 1 and t.optimizer.count == 1 for t in trainers)


def test_accumulated_step_matches_jax(corpus, jax_trainer, monkeypatch):
    """The real loss: the port Trainer's A = 2 step (two micro-batches of 2
    rows that keep the batch's padded lengths, gradients summed in float32
    and halved, one update) against the JAX Trainer's A = 2 step from the
    same weights and batch: the averaged loss parts, the gradient norm, each
    parameter's update and the BatchNorm statistics after both
    micro-batches. Each micro-batch runs the training kernels' forward and
    backward once (their plain versions here)."""
    jt = jax_trainer
    batch = batch_of()
    new_state, ref_parts = jt._get_train_step(2)(
        jt.state, {k: jnp.asarray(x) for k, x in batch.items()}, jax.random.PRNGKey(0))
    calls = {"fwd": 0, "bwd": 0}
    for name in ("fwd", "bwd"):
        fn = getattr(decoder_grad, f"taco2_train_{name}")
        monkeypatch.setattr(decoder_grad, f"taco2_train_{name}",
                            lambda *a, _fn=fn, _n=name, **k: calls.__setitem__(
                                _n, calls[_n] + 1) or _fn(*a, **k))
    trainer = port_trainer(corpus, **dict(ACCUM))
    trainer.generator = None
    before = {k: np.asarray(x, np.float64) for k, x in _flatten(jt.state.params).items()}
    pm = trainer.model
    pm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params),
                                       jax.tree_util.tree_map(np.asarray, jt.state.model_state),
                                       jax_layouts(pm)), strict=True)
    metrics = trainer.train_step(batch, 2)
    assert calls == {"fwd": 2, "bwd": 2} and trainer.step == 1
    assert set(metrics) == set(ref_parts)
    for k, x in ref_parts.items():
        np.testing.assert_allclose(metrics[k], float(x), rtol=1e-4, atol=1e-7, err_msg=k)
    got_params, got_state = params_to_jax(pm)
    after = {k: np.asarray(x) for k, x in _flatten(new_state.params).items()}
    assert set(got_params) == set(after)
    moves = {k: np.max(np.abs(p1 - before[k])) for k, p1 in after.items()}
    largest = max(moves.values())
    for k, p1 in after.items():
        # the parameters are float32: an update is read to within one
        # spacing of the parameter, plus 1e-4 of the leaf's largest move (or
        # of 1e-2 of the largest move anywhere, for a leaf that barely moves)
        spacing = np.spacing(np.abs(p1)).astype(np.float64)
        off = np.abs(got_params[k].astype(np.float64) - p1) - spacing
        assert np.max(off) <= 1e-4 * max(moves[k], 1e-2 * largest), (k, np.max(off), moves[k])
    ref_state = _flatten(new_state.model_state)
    assert set(got_state) == set(ref_state)
    for k, r in ref_state.items():
        np.testing.assert_allclose(got_state[k], r, rtol=1e-4, atol=1e-6, err_msg=k)


REFUSALS = {"batch_size": (("batch_size", 9), ("grad_accum_steps", 2)),
            "gradual_training": (("gradual_training", [[0, 2, 4], [100, 2, 6]]),
                                 ("batch_size", 8), ("grad_accum_steps", 4)),
            "tokens_per_batch": (("batch_size", 9), ("grad_accum_steps", 3)),
            "actual_batch": (("batch_size", 8), ("grad_accum_steps", 4))}


@pytest.mark.parametrize("which", sorted(REFUSALS))
def test_refusals_are_the_jax_packages(corpus, jax_trainer, tmp_path, which):
    """grad_accum_steps that does not divide a batch size the loader can
    emit: batch_size, a gradual_training row's, the token batching quantum
    (8); the port raises the JAX Trainer's ValueError with its message, and
    for those three before it reads any data (the dataset path does not
    exist). A batch whose actual size A does not divide is refused at its
    step, as the JAX package refuses it when it traces the step."""
    jt = jax_trainer
    jcfg, cfg = configs(str(tmp_path / "missing"), training=REFUSALS[which])
    if which == "tokens_per_batch":
        jcfg, cfg = (dataclasses.replace(c, data=dataclasses.replace(c.data, tokens_per_batch=64))
                     for c in (jcfg, cfg))
    kept = jt.cfg
    jt.cfg, jt._train_steps = jcfg, {}
    try:
        with pytest.raises(ValueError) as ref:
            step = jt._get_train_step(2)
            six = {k: jnp.asarray(x) for k, x in batch_of(B=6).items()}
            step(jt.state, six, jax.random.PRNGKey(0))
    finally:
        jt.cfg, jt._train_steps = kept, {}
    if which == "actual_batch":
        trainer = port_trainer(corpus, **dict(REFUSALS[which]))
        with pytest.raises(ValueError) as got:
            trainer.train_step(batch_of(B=6), 2)
        assert trainer.step == 0 and trainer.optimizer.count == 0
    else:
        with pytest.raises(ValueError) as got:
            Trainer(cfg, verbose=False, device="cpu")
    assert str(got.value) == str(ref.value)


def test_cli_trains_with_accumulation(tmp_path, capsys):
    """`bin/train.py --device cpu` on the smoke config (batch 8) with
    "grad_accum_steps": 2: 2 steps of two micro-batches on a generated
    corpus, finite losses, a checkpoint at step 2."""
    from your_voice_tts_torch.bin import train

    cfg_path = write_config(tmp_path, {"grad_accum_steps": 2})
    train.main(["--config_path", cfg_path, "--max_steps", "2", "--device", "cpu",
                "--output_path", str(tmp_path / "runs")])
    assert_trained(capsys.readouterr().out)
    (run,) = os.listdir(tmp_path / "runs")
    assert os.path.exists(tmp_path / "runs" / run / "checkpoint_2.npz")
