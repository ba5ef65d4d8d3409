"""Tacotron(1) with Graves attention and the location attention's options
(windowing, forward attention, the transition agent, the forward mask) in
the port against the JAX package on the CPU. The JAX package decodes and
trains these configs through its scan; the port through its step loop
(models/tacotron.py `TacotronDecoder._step`).

- one training step: the teacher-forced pass (decoder outputs, the linear
  head, alignments, stop logits), the loss and its parts, every gradient
  leaf and the BatchNorm statistics, the port Trainer's `_loss_fn` against
  the JAX forward + criterion under jax.value_and_grad, jitted, in float32
  at tests/test_torch_train_variants.py's tolerances (outputs
  1e-5 absolute, the linear head 1e-4, the loss and its parts 1e-4
  relative, each gradient leaf 1e-4 of its own largest magnitude, the
  statistics 1e-4 / 1e-6) and in mixed precision at
  tests/test_torch_taco1_train.py's MIX_* (the statistics also within
  twice the JAX mixed step's own distance from its float32 step, where
  that is larger: the step loop's bf16 recurrence rounds at other points
  than the scan's, and over the decoder's steps the PostCBHG's batch
  statistics move by as much as the JAX package's own bf16 rounding moves
  them);
- inference with dropout off against the JAX `inference` on its scan,
  1e-5 absolute (the linear head 1e-4), the lengths exact;
- the attention's windowing at inference and not in training, against the
  JAX `__call__(..., inference=True / False)`, 1e-6;
- the step loop forced onto a location config against kernel 8's plain
  version, dropout on, the same seed, 1e-5;
- the route each config takes against the JAX `taco1_supported`;
- `Synthesizer.tts_many`, `bin/train.py` and `bin/synthesize.py` on a
  Graves config, and its serving export.

Weights come from the JAX `init` through the checkpoint bridge; inputs are
made with numpy from a seed.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_taco1_train import corpus  # noqa: F401 (the shared fixture)
from tests.test_torch_taco1_train import (MIX_F32_RATIO, MIX_GRAD_TOL, MIX_LEAF_TOL,
                                          MIX_LOSS_TOL, MIX_STATE_TOL, OUTPUTS, SMOKE, TACO1,
                                          batch_of, cast_down, cast_up, leaf_errors, np_tree,
                                          rel_l2)
from tests.test_torch_taco1_train import configs as taco1_configs
from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.models.attention import AttentionState as JaxAttentionState
from your_voice_tts_tpu.models.losses import TacotronLoss as JaxTacotronLoss
from your_voice_tts_tpu.ops.pallas.taco1_decode import taco1_supported as jax_taco1_supported
from your_voice_tts_tpu.text import symbols as jax_symbols
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_torch.config import ModelConfig, load_config
from your_voice_tts_torch.models import setup_model
from your_voice_tts_torch.models.attention import AttentionState
from your_voice_tts_torch.models.tacotron import Tacotron, taco1_supported
from your_voice_tts_torch.text import symbols
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax, params_to_jax
from your_voice_tts_torch.train.trainer import Trainer

torch.set_num_threads(1)

VARIANTS = {"graves": dict(attention_type="graves"),
            "windowing": dict(windowing=True),
            "forward": dict(use_forward_attn=True),
            "forward_ta": dict(use_forward_attn=True, transition_agent=True),
            "forward_ta_mask": dict(use_forward_attn=True, transition_agent=True,
                                    forward_attn_mask=True)}
# tests/test_torch_train_variants.py's
OUT_TOL, POSTNET_TOL, LOSS_TOL, LEAF_TOL, STATE_TOL = 1e-5, 1e-4, 1e-4, 1e-4, 1e-4
NO_DVECS = {n: np.zeros(16, np.float32) for n in ("SYN00", "SYN03", "SYN01")}


def configs(corpus_path, variant, **training):
    """(JAX config, port config): the narrow Tacotron(1) smoke config of
    tests/test_torch_taco1_train.py with VARIANTS[variant]'s model fields
    (and `training`'s) set."""
    return [dataclasses.replace(c, model=dataclasses.replace(c.model, **VARIANTS[variant]))
            for c in taco1_configs(corpus_path, **training)]


def plain_batch():
    b = batch_of(NO_DVECS)
    b.pop("speaker_ids"), b.pop("speaker_embeddings")
    return b


@functools.cache
def jax_step(corpus_path, variant, mixed):
    """One teacher-forced step of the JAX model (init seed 0) on
    `plain_batch` under jax.value_and_grad, jitted, with the criterion the
    JAX Trainer builds for Tacotron(1) (the linear target and its priority
    band), cast as its `_loss_fn` casts under mixed precision: (variables,
    loss, its parts, gradients, new state, outputs)."""
    jcfg, _ = configs(corpus_path, variant)
    jm = jax_setup_model(len(jax_symbols), 0, jcfg)
    v = jm.init(jax.random.PRNGKey(0))
    t = jcfg.training
    crit = JaxTacotronLoss("Tacotron", t.loss_masking, t.seq_len_norm, jcfg.model.stopnet,
                           t.stopnet_pos_weight, t.ga_alpha, t.ga_sigma, t.ga_decay_steps,
                           t.decoder_loss_alpha, t.postnet_loss_alpha)
    band = int(3000 / (jcfg.audio.sample_rate / 2) * jcfg.audio.num_freq)
    b = {k: jnp.asarray(x) for k, x in plain_batch().items()}

    def loss_fn(params, state):
        params, mel, _ = cast_down(mixed, params, b["mel"], None)
        out = cast_up(jm.forward({"params": params, "state": state}, b["text"],
                                 b["text_lengths"], mel, rng=None, train=True, r=2,
                                 mel_lengths=b["mel_lengths"]))
        total, parts = crit(out, b["mel"], b["mel_lengths"], b["stop_targets"],
                            b["text_lengths"], step=0, r=2, linear_target=b["linear"],
                            n_priority_freq=band)
        return total, (out["state"], parts, {k: out[k] for k in OUTPUTS})

    (loss, (state, parts, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["state"])
    return (np_tree(v), float(loss), {k: float(x) for k, x in parts.items()}, np_tree(grads),
            np_tree(state), np_tree(out))


def port_step(corpus_path, variant, mixed, v):
    """The port Trainer's `_loss_fn` on `plain_batch` with the JAX weights
    `v`: (loss, its parts, gradients and new BatchNorm state in the JAX
    layout, outputs)."""
    _, cfg = configs(corpus_path, variant, mixed_precision=mixed)
    trainer = Trainer(cfg, verbose=False, device="cpu")
    pm = trainer.model
    assert not pm.decoder.kernel_supported()
    pm.load_state_dict(params_from_jax(v["params"], v["state"], jax_layouts(pm)), strict=True)
    loss, parts, out = trainer._loss_fn(trainer._tensors(plain_batch()), 2, None)
    names = [n for n, p in pm.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, trainer.params)
    holder = dict(pm.named_parameters())
    with torch.no_grad():
        for n, g in zip(names, grads):
            holder[n].copy_(g)
        got_grads, got_state = ({k: np.array(x) for k, x in tree.items()}
                                for tree in params_to_jax(pm))
    return (loss.item(), {k: float(x.detach()) for k, x in parts.items()}, got_grads, got_state,
            {k: out[k].detach().numpy() for k in OUTPUTS})


CASES = [pytest.param(name, False, id=name) for name in VARIANTS] + [
    pytest.param(name, True, id=f"{name}-mixed") for name in ("graves", "forward_ta_mask")]


@pytest.mark.parametrize("variant, mixed", CASES)
def test_train_step_matches_jax(corpus, variant, mixed):
    """The teacher-forced pass, the loss and its parts, every gradient leaf
    and the new BatchNorm statistics of one step: the port Trainer's
    `_loss_fn` (the step loop) against the JAX forward + criterion (its
    scan). Windowing trains as plain location attention on both sides (it
    acts at inference only). Mixed precision as
    tests/test_torch_taco1_train.py holds it: the two sides round bf16 at
    other points inside, so the outputs and parts are checked finite, the
    loss at MIX_LOSS_TOL, the gradients at MIX_*. The variant's own
    weights (the agent's `ta`, Graves's `l1` / `l2`) receive gradients on
    both sides."""
    path = corpus[0]
    v, ref_loss, ref_parts, ref_grads, ref_state, ref_out = jax_step(path, variant, mixed)
    loss, parts, got, got_state, out = port_step(path, variant, mixed, v)
    for k in OUTPUTS:
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
        assert errs[worst] <= MIX_LEAF_TOL, (worst, errs[worst])
        f32 = {k: np.asarray(x, np.float64)
               for k, x in _flatten(jax_step(path, variant, False)[3]).items()}
        assert rel_l2(got, ref) <= MIX_GRAD_TOL, rel_l2(got, ref)
        assert 0.5 * rel_l2(ref, f32) <= rel_l2(got, f32) <= MIX_F32_RATIO * rel_l2(ref, f32), (
            rel_l2(got, f32), rel_l2(ref, f32))
    else:
        assert errs[worst] <= LEAF_TOL, (worst, errs[worst])
    ref_state = _flatten(ref_state)
    assert set(got_state) == set(ref_state)
    f32_state = _flatten(jax_step(path, variant, False)[4]) if mixed else None
    for k, r in ref_state.items():
        if not mixed:
            np.testing.assert_allclose(got_state[k], r, rtol=STATE_TOL, atol=1e-6, err_msg=k)
            continue
        # two bf16 runs: MIX_STATE_TOL (atol 1e-3), or, where the JAX mixed
        # step's own statistics sit farther from its float32 ones, twice
        # that distance (a run as close to float32 as the JAX one is)
        own_noise = 2 * np.abs(r - f32_state[k]).max()
        bound = np.maximum(1e-3 + MIX_STATE_TOL * np.abs(r), own_noise)
        assert (np.abs(got_state[k] - r) <= bound).all(), (k, np.abs(got_state[k] - r).max())
    own = "['l2']" if variant == "graves" else "['ta']" if "ta" in variant else "['v']"
    assert any(own in k and np.abs(g).max() > 0 for k, g in ref.items()), own


@functools.cache
def models(variant, dropout: bool = False):
    """(JAX model, its variables, the port model with those weights): the
    narrow Tacotron(1) at r = 2, memory 5, with VARIANTS[variant] (None:
    the default location attention), prenet dropout as `dropout`."""
    flags = dict(VARIANTS.get(variant, {}), prenet_dropout=dropout, max_decoder_steps=24)
    jcfg, cfg = (dataclasses.replace(c, model=dataclasses.replace(c.model, **flags))
                 for c in taco1_configs("unused"))
    jm = jax_setup_model(len(jax_symbols), 0, jcfg)
    v = jm.init(jax.random.PRNGKey(1))
    pm = setup_model(len(symbols), cfg, device="cpu")
    pm.load_state_dict(params_from_jax(np_tree(v["params"]), np_tree(v["state"]),
                                       jax_layouts(pm)), strict=True)
    return jm, v, pm


def text_batch(B: int = 3, seed: int = 2):
    rng = np.random.default_rng(seed)
    lens = np.array([14, 9, 11, 6][:B], np.int32)
    text = np.where(np.arange(14)[None] < lens[:, None], rng.integers(1, 60, (B, 14)), 0)
    return text.astype(np.int32), lens


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_inference_matches_the_jax_scan(variant):
    """Dropout off: `Tacotron.inference` (the step loop, float32) against
    the JAX `Tacotron.inference` on its scan, 24 steps (no early exit on
    either side): frames, alignments and stop probabilities 1e-5, the
    linear head 1e-4, the lengths exact."""
    jm, v, pm = models(variant)
    assert not pm.decoder.kernel_supported()
    text, lens = text_batch()
    ref = jm.inference(v, jnp.asarray(text), jnp.asarray(lens), max_decoder_steps=24,
                       use_pallas=False)
    got = pm.inference(torch.from_numpy(text), torch.from_numpy(lens), max_decoder_steps=24)
    for k in ("decoder_outputs", "postnet_outputs", "alignments", "stop_probs"):
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0, err_msg=k,
                                   atol=POSTNET_TOL if k == "postnet_outputs" else OUT_TOL)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(ref["mel_lengths"]))


@pytest.mark.parametrize("norm", ["sigmoid", "softmax"])
def test_windowing_acts_at_inference_only(norm):
    """`LocationSensitiveAttention.forward` with windowing (win_back 1,
    win_front 3) from a state whose window centre is not 0, against the
    JAX `__call__` with inference=True (the energies outside the window
    dropped) and False (untouched), 1e-6; the two differ."""
    from your_voice_tts_tpu.models.attention import init_attn as jax_init_attn
    from your_voice_tts_torch.models.attention import init_attn

    small = dict(attention_dim=10, attention_location_filters=4,
                 attention_location_kernel_size=5, attention_norm=norm, windowing=True)
    jcfg, cfg = JaxModelConfig(**small), ModelConfig(**small)
    ja = jax_init_attn(jcfg.attention_type, 12, 8, 10, True, 4, 5, True, norm, False, False,
                       False, win_back=jcfg.win_back, win_front=jcfg.win_front)
    p = ja.init(jax.random.PRNGKey(3))
    holder = torch.nn.Module()
    holder.attention = init_attn(cfg, 12, 8)
    holder.load_state_dict(params_from_jax({"attention": np_tree(p)}, {}), strict=True)
    a = holder.attention
    rng = np.random.default_rng(8)
    B, T = 3, 11
    q = rng.standard_normal((B, 12)).astype(np.float32)
    enc = rng.standard_normal((B, T, 8)).astype(np.float32)
    att = rng.uniform(0, 1, (B, T)).astype(np.float32)
    cum = att + rng.uniform(0, 1, (B, T)).astype(np.float32)
    win = np.array([4, 0, 9], np.int32)
    mask = np.arange(T)[None] < np.array([[11], [7], [10]])
    jstate = JaxAttentionState(jnp.asarray(att), jnp.asarray(cum), jnp.zeros((B, T)),
                               jnp.asarray(win), jnp.zeros((B, 1)))
    state = AttentionState(torch.from_numpy(att), torch.from_numpy(cum), torch.zeros(B, T),
                           torch.from_numpy(win).long(), torch.zeros(B, 1))
    pinp = ja.preprocess_inputs(p, jnp.asarray(enc))
    got = {}
    for inference in (True, False):
        _, jctx, jal = ja(p, jnp.asarray(q), jnp.asarray(enc), pinp, jstate,
                          mask=jnp.asarray(mask), inference=inference)
        with torch.no_grad():
            st, ctx, al = a(torch.from_numpy(q), torch.from_numpy(enc),
                            a.preprocess_inputs(torch.from_numpy(enc)), state,
                            torch.from_numpy(mask), inference=inference)
        np.testing.assert_allclose(al.numpy(), np.asarray(jal), atol=1e-6, rtol=0)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=1e-6, rtol=0)
        got[inference] = al.numpy()
    outside = (np.abs(np.arange(T)[None] - win[:, None] - 1) > 2)
    assert (got[True][outside] == 0).all() and not np.allclose(got[True], got[False])


@pytest.mark.parametrize("prenet_type", ["original", "bn"])
def test_step_loop_on_a_location_config_is_kernel_8s_plain_version(prenet_type):
    """The route's own check: the step loop forced onto a default
    (location-sensitive) decoder gives `tacotron1_decode_plain`'s frames,
    alignments, stop probabilities and lengths in float32 with prenet
    dropout on and the same seed (the hash PRNG's draws, salts 21 and
    22), within 1e-5; a BN prenet folds its statistics and draws
    nothing on both routes."""
    _, _, pm = models(None, dropout=True)
    dec = pm.decoder
    if prenet_type == "bn":
        cfg = dataclasses.replace(pm.cfg, prenet_type="bn")
        pm = Tacotron(len(symbols), cfg, n_mels=20, num_freq=129, device="cpu", seed=4)
        dec = pm.decoder
    rng = np.random.default_rng(5)
    enc = torch.from_numpy(rng.standard_normal((4, 13, dec.attention.inputs.in_features))
                           .astype(np.float32))
    lens = torch.tensor([13, 9, 11, 5])
    assert dec.kernel_supported()
    with torch.no_grad():
        kernel = dec.inference(enc, lens, 30, 2, seed=7, dtype=torch.float32)
        frames, aligns, stops, steps = dec._decode_loop(enc, lens, 30, 2, seed=7)
        dropped = dec.inference(enc, lens, 30, 2, seed=8, dtype=torch.float32)
    loop = (frames.transpose(0, 1).reshape(4, 60, -1), aligns.transpose(0, 1),
            stops.transpose(0, 1), steps * 2)
    for a, b, name in zip(loop[:3], kernel[:3], ("frames", "alignments", "stops")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_array_equal(loop[3].numpy(), kernel[3].numpy())
    assert torch.equal(dropped[0], kernel[0]) == (prenet_type == "bn")


# (model fields, the port's route); r = 2 within memory 5 unless set
ROUTES = [dict(), dict(attention_type="graves"), dict(windowing=True),
          dict(use_forward_attn=True), dict(use_forward_attn=True, transition_agent=True),
          dict(transition_agent=True), dict(location_attn=False), dict(attention_norm="softmax"),
          dict(prenet_type="bn"), dict(forward_attn_mask=True), dict(r=7, memory_size=5)]


@pytest.mark.parametrize("flags", ROUTES,
                         ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()) or "default")
def test_route_choice_is_the_jax_packages(flags):
    """`taco1_supported` answers as the JAX package's for each config, the
    decoder takes the route it names, and r past the memory size keeps
    kernel 8 (the recorded departure: the JAX package sends it to its
    scan)."""
    full = dict(dict(r=2, memory_size=5), **flags)
    jcfg = JaxModelConfig(**full)
    cfg = ModelConfig(model="Tacotron", tacotron_width=32, attention_dim=24, **full)
    ref = jax_taco1_supported(jcfg, jcfg.memory_size, jcfg.r)
    got = taco1_supported(cfg)
    assert got == (ref or full["r"] > full["memory_size"])
    dec = Tacotron(len(symbols), cfg, n_mels=20, num_freq=33, device="cpu").decoder
    assert dec.kernel_supported() is got


def write_config(tmp_path, fields: dict) -> str:
    """The smoke config with the narrow Tacotron(1) and `fields` set."""
    with open(SMOKE, encoding="utf-8") as f:
        raw = json.loads("\n".join(line for line in f if not line.strip().startswith("//")))
    raw.update(TACO1, batch_size=4, **fields)
    path = tmp_path / "taco1_variant.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_graves_trains_and_serves_through_the_clis(tmp_path, capsys):
    """A Graves Tacotron(1): `bin/train.py --device cpu` trains 2 steps on a
    generated corpus; its checkpoint serves through `Synthesizer.tts_many`
    (the step loop, then Griffin-Lim) and `bin/synthesize.py --device
    cpu`; the serving export carries its step loop as the registered op
    `yvt::taco1_step_decode`, and the program serves it."""
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.bin import synthesize, train
    from your_voice_tts_torch.infer.export import make_serving_fn
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    cfg_path = write_config(tmp_path, dict(attention_type="graves", max_decoder_steps=30))
    train.main(["--config_path", cfg_path, "--max_steps", "2", "--device", "cpu",
                "--output_path", str(tmp_path / "runs")])
    assert "GLOBAL_STEP: 2" in capsys.readouterr().out
    (run,) = os.listdir(tmp_path / "runs")
    ckpt = str(tmp_path / "runs" / run / "checkpoint_2.npz")
    synth = Synthesizer(cfg_path, ckpt, device="cpu")
    assert not synth.model.decoder.kernel_supported()
    wavs = synth.tts_many(["Hello there.", "A second one, longer than the first."])
    assert len(wavs) == 2 and all(w.ndim == 1 and w.size and np.isfinite(w).all() for w in wavs)
    synthesize.main(["Hi there.", cfg_path, ckpt, str(tmp_path / "out"), "--device", "cpu"])
    assert os.listdir(tmp_path / "out") == ["out_000.wav"]
    cfg = load_config(cfg_path)
    program = make_serving_fn(synth.model, cfg, AudioProcessor(cfg.audio, "cpu"))
    assert program.traced.kind == "taco1_step"
    with torch.no_grad():
        wav, lengths = program(torch.ones(2, 8, dtype=torch.int64), torch.tensor([8, 5]),
                               torch.tensor([0]))
    assert wav.shape[0] == 2 and np.isfinite(wav.numpy()).all() and (lengths > 0).all()
