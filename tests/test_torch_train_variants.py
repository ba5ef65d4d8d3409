"""Tacotron2 training on the attention variants in the port against the JAX
package on the CPU: forward attention (u = 0.5), with the transition agent,
with the agent and the forward mask, and Graves attention train through
the step loop (`Decoder._scan`, the JAX package's `lax.scan` over
`Decoder._step`); plain location-sensitive attention through the training
kernels' custom backward, and the two routes agree; the route each config
takes; the CLI.

Weights come from the JAX `init` through the checkpoint bridge; inputs are
made with numpy from a seed; dropout is off (no rng, no generator). The
JAX side of each case is one jitted forward + loss under
jax.value_and_grad; the port side is the Trainer's own `_loss_fn`.
Tolerances: the teacher-forced pass (frames, alignments, stop logits)
1e-5 absolute, the one tests/test_decoder_grad.py holds between the JAX
package's own routes, and the postnet's frames (five convolutions on) 1e-4,
as tests/test_torch_train.py holds the whole model's forward; the loss and its parts 1e-4 relative, every
gradient leaf 1e-4 (its largest error over its own largest magnitude, or
over 1e-2 of the largest gradient anywhere for a leaf near zero) and the
BatchNorm statistics 1e-4 / 1e-6, as tests/test_torch_train.py holds the
whole model; mixed precision at tests/test_torch_taco1_train.py's MIX_*.

This module's helpers (`configs`, `batch_of`, `jax_step`, `port_step`,
`leaf_errors`, `rel_l2`) serve tests/test_torch_bidirectional.py and
tests/test_torch_grad_accum.py too.
"""

import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.models.losses import TacotronLoss as JaxTacotronLoss
from your_voice_tts_tpu.models.tacotron2 import Decoder as JaxDecoder
from your_voice_tts_tpu.nn.core import cast_f32_to_bf16
from your_voice_tts_tpu.text import symbols as jax_symbols
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_torch.config import ModelConfig, load_config
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.models.tacotron2 import Decoder
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax, params_to_jax
from your_voice_tts_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")
VARIANTS = {"forward": dict(use_forward_attn=True),
            "forward_ta": dict(use_forward_attn=True, transition_agent=True),
            "forward_ta_mask": dict(use_forward_attn=True, transition_agent=True,
                                    forward_attn_mask=True),
            "graves": dict(attention_type="graves")}
OUT_TOL, POSTNET_TOL, LOSS_TOL, LEAF_TOL, STATE_TOL = 1e-5, 1e-4, 1e-4, 1e-4, 1e-4
# tests/test_torch_taco1_train.py:59-63
MIX_LOSS_TOL, MIX_LEAF_TOL, MIX_GRAD_TOL, MIX_F32_RATIO, MIX_STATE_TOL = 1e-3, 0.25, 0.1, 1.25, 1e-2
OUTPUTS = ("decoder_outputs", "postnet_outputs", "alignments", "stop_logits")
# conv biases ahead of a batch-statistics BatchNorm (tests/test_torch_train_speakers.py):
# exact gradient ~0, both sides a cancelling sum's rounding noise, held as
# noise (5e-2 of the largest gradient) in mixed precision
CANCELLING = re.compile(r"\['(blocks|convs)'\]\[\d+\](\['conv'\])?\['b'\]$")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 12-item sr=8000 synthetic corpus, which the Trainers read (the
    steps themselves run on `batch_of`)."""
    return make_synthetic_corpus(str(tmp_path_factory.mktemp("variants")), n_items=12, sr=8000)


def configs(corpus_path, model=(), training=()):
    """(JAX config, port config): the smoke config on `corpus_path` with the
    model and training groups' fields `model` / `training` ((name, value)
    pairs) set, float32 unless `training` says otherwise."""
    training = {"mixed_precision": False, **dict(training)}
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(SMOKE)
        ds = dataclasses.replace(cfg.data.datasets[0], path=corpus_path)
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
            model=dataclasses.replace(cfg.model, **dict(model)),
            training=dataclasses.replace(cfg.training, **training)))
    return out


def batch_of(B: int = 4, seed: int = 0, n_symbols: int = 60):
    """B rows at the smoke shapes, text 16 and mel 24 frames (r = 2) with
    rows of their own lengths; the padding zero."""
    rng = np.random.default_rng(seed)
    tl = np.array([16, 12, 9, 14, 16, 10, 13, 11][:B], np.int32)
    ml = np.array([24, 19, 13, 22, 17, 24, 15, 20][:B], np.int32)
    text = np.where(np.arange(16)[None] < tl[:, None], rng.integers(1, n_symbols, (B, 16)), 0)
    mel = rng.normal(size=(B, 24, 20)) * (np.arange(24)[None, :, None] < ml[:, None, None])
    return {"text": text.astype(np.int32), "text_lengths": tl, "mel": mel.astype(np.float32),
            "mel_lengths": ml,
            "stop_targets": (np.arange(12)[None] >= ((ml + 1) // 2 - 1)[:, None]).astype(
                np.float32)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cast_up(out):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, out)


@functools.cache
def jax_step(corpus_path, model=(), mixed=False, outputs=OUTPUTS):
    """One teacher-forced step of the JAX model (init seed 0) on `batch_of`
    under jax.value_and_grad, jitted, cast as the JAX Trainer's `_loss_fn`
    casts under mixed precision: (variables, loss, its parts, gradients,
    new state, `outputs`)."""
    jcfg, _ = configs(corpus_path, model)
    jm = jax_setup_model(len(jax_symbols), 0, jcfg)
    v = jm.init(jax.random.PRNGKey(0))
    t = jcfg.training
    crit = JaxTacotronLoss("Tacotron2", t.loss_masking, t.seq_len_norm, jcfg.model.stopnet,
                           t.stopnet_pos_weight, t.ga_alpha, t.ga_sigma, t.ga_decay_steps,
                           t.decoder_loss_alpha, t.postnet_loss_alpha)
    b = {k: jnp.asarray(x) for k, x in batch_of().items()}

    def loss_fn(params, state):
        mel = b["mel"]
        if mixed:
            params, mel = cast_f32_to_bf16(params), mel.astype(jnp.bfloat16)
        out = cast_up(jm.forward({"params": params, "state": state}, b["text"],
                                 b["text_lengths"], mel, rng=None, train=True, r=2,
                                 mel_lengths=b["mel_lengths"]))
        total, parts = crit(out, b["mel"], b["mel_lengths"], b["stop_targets"],
                            b["text_lengths"], step=0, r=2)
        return total, (out["state"], parts, {k: out[k] for k in outputs})

    (loss, (state, parts, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["state"])
    return (np_tree(v), float(loss), {k: float(x) for k, x in parts.items()}, np_tree(grads),
            np_tree(state), np_tree(out))


def port_trainer(corpus_path, model=(), **training):
    _, cfg = configs(corpus_path, model, training.items())
    return Trainer(cfg, verbose=False, device="cpu")


def port_step(corpus_path, model, mixed, v, outputs=OUTPUTS):
    """The port Trainer's `_loss_fn` on `batch_of` with the JAX weights `v`:
    (loss, its parts, gradients and new BatchNorm state in the JAX layout,
    `outputs`)."""
    trainer = port_trainer(corpus_path, model, mixed_precision=mixed)
    pm = trainer.model
    pm.load_state_dict(params_from_jax(v["params"], v["state"], jax_layouts(pm)), strict=True)
    loss, parts, out = trainer._loss_fn(trainer._tensors(batch_of()), 2, None)
    names = [n for n, p in pm.named_parameters() if p.requires_grad]
    # allow_unused, zeros, as `Trainer.train_step` takes them: a backward
    # decoder's stopnet feeds no loss
    grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
    holder = dict(pm.named_parameters())
    with torch.no_grad():
        for n, g in zip(names, grads):
            holder[n].copy_(0.0 if g is None else g)
        got_grads, got_state = ({k: np.array(x) for k, x in tree.items()}
                                for tree in params_to_jax(pm))
    return (loss.item(), {k: float(x.detach()) for k, x in parts.items()}, got_grads, got_state,
            {k: out[k].detach().numpy() for k in outputs})


def rel_l2(a: dict, b: dict) -> float:
    keys = sorted(b)
    x, y = (np.concatenate([np.ravel(t[k]) for k in keys]) for t in (a, b))
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def leaf_errors(got: dict, ref: dict) -> dict:
    """Each leaf's largest error over its own largest magnitude, or over
    1e-2 of the largest gradient anywhere for a leaf near zero."""
    gscale = max(np.max(np.abs(v)) for v in ref.values())
    return {k: float(np.max(np.abs(got[k] - r)) / max(np.max(np.abs(r)), 1e-2 * gscale))
            for k, r in ref.items()}


def hold_step(corpus_path, model, mixed=False, outputs=OUTPUTS):
    """One step of each package on the same weights and batch, held at the
    module's tolerances (float32) or at MIX_* (mixed precision, where the
    outputs and the loss's parts are checked finite: the two packages
    round bf16 at other points inside; the CANCELLING leaves are held as
    noise, as tests/test_torch_train_speakers.py holds them). Returns the
    port's parts and the JAX gradients."""
    v, ref_loss, ref_parts, ref_grads, ref_state, ref_out = jax_step(corpus_path, model, mixed,
                                                                     outputs)
    loss, parts, got, got_state, out = port_step(corpus_path, model, mixed, v, outputs)
    for k in outputs:
        assert out[k].shape == ref_out[k].shape and np.isfinite(out[k]).all(), k
        if not mixed:
            np.testing.assert_allclose(out[k], ref_out[k], rtol=0, err_msg=k,
                                       atol=POSTNET_TOL if k == "postnet_outputs" else OUT_TOL)
    np.testing.assert_allclose(loss, ref_loss, rtol=MIX_LOSS_TOL if mixed else LOSS_TOL)
    assert set(parts) == set(ref_parts)
    for k, x in ref_parts.items():
        assert np.isfinite(parts[k]), k
        if not mixed:
            np.testing.assert_allclose(parts[k], x, rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    ref = {k: np.asarray(x, np.float64) for k, x in _flatten(ref_grads).items()}
    assert set(got) == set(ref)
    errs = leaf_errors(got, ref)
    worst = max(errs, key=errs.get)
    if mixed:
        gscale = max(np.max(np.abs(x)) for x in ref.values())
        cancelling = [k for k in ref if CANCELLING.search(k)]
        assert len(cancelling) == 8
        for k in cancelling:
            noise = max(np.max(np.abs(got[k])), np.max(np.abs(ref[k]))) / gscale
            assert noise <= 5e-2, (k, noise)
        worst = max((k for k in errs if k not in cancelling), key=errs.get)
        assert errs[worst] <= MIX_LEAF_TOL, (worst, errs[worst])
        f32 = {k: np.asarray(x, np.float64)
               for k, x in _flatten(jax_step(corpus_path, model, False, outputs)[3]).items()}
        assert rel_l2(got, ref) <= MIX_GRAD_TOL, rel_l2(got, ref)
        # a bf16 gradient: at least half as far from the float32 one as the
        # JAX mixed gradient, and no farther than MIX_F32_RATIO times
        assert 0.5 * rel_l2(ref, f32) <= rel_l2(got, f32) <= MIX_F32_RATIO * rel_l2(ref, f32), (
            rel_l2(got, f32), rel_l2(ref, f32))
    else:
        assert errs[worst] <= LEAF_TOL, (worst, errs[worst])
    ref_state = _flatten(ref_state)
    assert set(got_state) == set(ref_state)
    for k, r in ref_state.items():
        np.testing.assert_allclose(got_state[k], r, rtol=MIX_STATE_TOL if mixed else STATE_TOL,
                                   atol=1e-3 if mixed else 1e-6, err_msg=k)
    return parts, ref


CASES = [pytest.param(name, False, id=name) for name in VARIANTS] + [
    pytest.param("forward_ta_mask", True, id="forward_ta_mask-mixed")]


@pytest.mark.parametrize("variant, mixed", CASES)
def test_train_step_matches_jax(corpus, variant, mixed):
    """The teacher-forced pass (frames, postnet frames, alignments, stop
    logits: the JAX `Decoder.forward` on its scan route), the loss and its
    parts, every gradient leaf and the new BatchNorm statistics of one
    step: the port Trainer's `_loss_fn` against the JAX forward + criterion
    under jax.value_and_grad. The variant's own weights (the agent's `ta`,
    Graves's `l1` / `l2`) receive gradients on both sides."""
    model = tuple(VARIANTS[variant].items())
    _, ref = hold_step(corpus, model, mixed)
    own = "['l2']" if variant == "graves" else "['ta']" if "ta" in variant else "['v']"
    assert any(own in k and np.abs(g).max() > 0 for k, g in ref.items()), own


def port_decoder(fast_grad: bool, **flags):
    """A smoke-width port decoder (E = 32, r = 2) with seeded weights and
    its fast_grad switch set."""
    cfg = dataclasses.replace(load_config(SMOKE).model, **flags)
    torch.manual_seed(3)
    dec = Decoder(32, 20, 2, cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.uniform_(-0.3, 0.3)
    dec.fast_grad = fast_grad
    return dec.train()


def test_step_loop_equals_the_training_kernels_route():
    """Plain location-sensitive attention, dropout off: the step loop
    (fast_grad cleared) gives the frames, alignments and stop logits of the
    training kernels' route (DecoderCore, their plain versions here) within
    1e-5, and every weight's gradient of a loss over all three within 1e-4
    of its largest magnitude (tests/test_decoder_grad.py:124-140 holds the
    JAX package's two routes so)."""
    rng = np.random.default_rng(5)
    enc = torch.from_numpy(rng.standard_normal((3, 11, 32)).astype(np.float32))
    lens = torch.tensor([11, 8, 5])
    mels = torch.from_numpy(rng.standard_normal((3, 24, 20)).astype(np.float32))
    got = {}
    for fast in (True, False):
        dec = port_decoder(fast)
        assert dec.fast_grad_supported() is fast
        out = dec(enc, lens, mels, 2)
        loss = sum((o.float() ** 2).sum() for o in out)
        got[fast] = [o.detach() for o in out], torch.autograd.grad(loss, list(dec.parameters()))
    for a, b, name in zip(got[True][0], got[False][0], ("frames", "alignments", "stops")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0, err_msg=name)
    for (n, _), a, b in zip(port_decoder(True).named_parameters(), got[True][1], got[False][1]):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-6), n


@pytest.mark.parametrize("flags", [
    dict(use_forward_attn=True), dict(attention_type="graves"), dict(),
    dict(attention_norm="softmax"), dict(location_attn=False), dict(windowing=True),
    *VARIANTS.values()], ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()) or "default")
def test_route_choice_is_the_jax_packages(flags):
    """`Decoder.fast_grad_supported` answers as the JAX package's for the
    configs of tests/test_decoder_grad.py:143-159 (forward attention and
    Graves take the scan; the default takes the kernels), the softmax norm,
    location features off, windowing and the four variants of this module."""
    small = dict(r=2, prenet_dim=8, attention_rnn_dim=12, decoder_rnn_dim=20, attention_dim=10)
    ref = JaxDecoder(6, 5, 2, JaxModelConfig(**small, **flags)).fast_grad_supported()
    assert Decoder(6, 5, 2, ModelConfig(**small, **flags)).fast_grad_supported() is ref
    assert ref is not any(k in flags for k in ("use_forward_attn", "attention_type",
                                                "transition_agent"))


@pytest.mark.parametrize("variant", ["forward_ta", "graves"])
def test_cli_trains_a_variant(tmp_path, capsys, variant):
    """`bin/train.py --device cpu` on the smoke config with the variant's
    flags: 2 steps on a generated synthetic corpus, finite losses, a
    checkpoint that loads back into the variant's model."""
    from your_voice_tts_torch.bin import train
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.text import symbols
    from your_voice_tts_torch.train.checkpoint import load_checkpoint

    cfg_path = write_config(tmp_path, VARIANTS[variant])
    train.main(["--config_path", cfg_path, "--max_steps", "2", "--device", "cpu",
                "--output_path", str(tmp_path / "runs")])
    assert_trained(capsys.readouterr().out)
    (run,) = os.listdir(tmp_path / "runs")
    model = setup_model(len(symbols), load_config(cfg_path), device="cpu")
    load_checkpoint(model, str(tmp_path / "runs" / run / "checkpoint_2.npz"))


def write_config(tmp_path, fields: dict) -> str:
    """The smoke config with `fields` (flat keys, JSON values) added."""
    import json

    with open(SMOKE, encoding="utf-8") as f:
        text = f.read()
    extra = "".join(f"{json.dumps(k)}: {json.dumps(v)}, " for k, v in fields.items())
    path = tmp_path / "config.json"
    path.write_text(text.replace('"model": "Tacotron2",', f'"model": "Tacotron2", {extra}', 1))
    return str(path)


def assert_trained(printed: str) -> None:
    """Two steps printed with finite losses."""
    assert "GLOBAL_STEP: 2" in printed
    losses = [float(x.split(":")[1]) for x in printed.split("|") if x.strip().startswith("loss:")]
    assert losses and all(np.isfinite(losses))
