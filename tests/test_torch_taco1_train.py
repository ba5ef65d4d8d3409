"""Tacotron(1) training in the port against the JAX package on the CPU: the
teacher-forced pass (decoder outputs, the linear head, alignments, stop
logits and the BatchNorm statistics it moves), the loss with the linear
target and its priority band through each Trainer's own `_loss_fn`, every
gradient leaf, the conditioned variants (a speaker table, d-vectors, GST),
each in float32 and in mixed precision, the dataset's linear targets, one
`Trainer.train_step` and the CLI.

Weights come from the JAX `init` through the checkpoint bridge; inputs are
made with numpy from a seed; dropout is off (no rng, no generator). One
JAX Trainer a precision (a Tacotron(1) smoke config on a 16-item corpus)
gives the dataset and the loss; each conditioned variant is one jitted JAX
forward + loss under jax.value_and_grad, cast for mixed precision as the
JAX Trainer's `_loss_fn` casts. Tolerances in float32 (sum order only):
the forward's outputs 1e-5 absolute (magnitudes ~1), the loss 1e-5
relative, the gradients 1e-4 relative L2 over all leaves, the BatchNorm
statistics 1e-5; in mixed precision those that
tests/test_torch_train_speakers.py holds Tacotron2's mixed step to (see
`test_train_step_matches_jax`); the dataset's spectrograms as MEL_TOL and
LIN_* below state.
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

from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.models.losses import TacotronLoss as JaxTacotronLoss
from your_voice_tts_tpu.nn.core import cast_f32_to_bf16
from your_voice_tts_tpu.text import symbols as jax_symbols
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_tpu.train.trainer import Trainer as JaxTrainer
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax, params_to_jax
from your_voice_tts_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")
TACO1 = dict(model="Tacotron", tacotron_width=32, memory_size=5, attention_dim=24)
SPK_DIM, N_SPK = 16, 4
# the conditioned variants, two models (a JAX compile each): a speaker
# table, and d-vectors with Global Style Tokens
KINDS = {"table": dict(use_speaker_embedding=True),
         "dvec+gst": dict(use_speaker_embedding=True, use_external_speaker_embedding_file=True,
                          speaker_embedding_dim=SPK_DIM, use_gst=True,
                          gst=dict(gst_embedding_dim=32, gst_num_heads=4, gst_style_tokens=6))}
OUT_TOL, LOSS_TOL, GRAD_TOL, STATE_TOL = 1e-5, 1e-5, 1e-4, 1e-5
# mixed precision, as tests/test_torch_train_speakers.py holds Tacotron2's
# mixed step: the loss rel 1e-3, each gradient leaf 0.25 (over its own
# largest magnitude, or 1e-2 of the largest gradient), all leaves rel L2
# 0.1 and no farther from the float32 gradient than 1.25 times the JAX
# package's mixed gradient, the running statistics rel 1e-2 (atol 1e-3)
MIX_LOSS_TOL, MIX_LEAF_TOL, MIX_GRAD_TOL, MIX_F32_RATIO, MIX_STATE_TOL = 1e-3, 0.25, 0.1, 1.25, 1e-2
# the dataset's spectrograms: the mel at the 1e-4 the port's mel tests hold
# (tests/test_torch_train.py); the linear in amplitude at 1e-5 of its
# frame's peak, and its normalized values at 1e-4 on bins within 60 dB of
# the frame's peak (float32 FFT rounding is relative to the frame's
# energy: a bin 75 dB below the peak moves by up to 2e-4 in the normalized
# range on either side)
MEL_TOL, LIN_AMP_TOL, LIN_DB_RANGE = 1e-4, 1e-5, 60.0
OUTPUTS = ("decoder_outputs", "postnet_outputs", "alignments", "stop_logits")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 16-item, 4-speaker sr=8000 corpus (the generator both packages
    share) and each speaker's d-vector, drawn from a seed."""
    path = make_synthetic_corpus(str(tmp_path_factory.mktemp("taco1")), n_items=16, sr=8000,
                                 n_speakers=N_SPK)
    rng = np.random.default_rng(7)
    return path, {f"SYN{i:02d}": rng.standard_normal(SPK_DIM).astype(np.float32)
                  for i in range(N_SPK)}


def configs(corpus_path, kind=None, **training):
    """(JAX config, port config): the smoke config on `corpus_path` with a
    narrow Tacotron(1), conditioned as KINDS[kind], in float32 unless
    `training` says otherwise."""
    training = {"mixed_precision": False, **training}
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(SMOKE)
        ds = dataclasses.replace(cfg.data.datasets[0], path=corpus_path)
        sp = dict(KINDS.get(kind, {}))
        if "gst" in sp:
            sp["gst"] = dataclasses.replace(cfg.speakers.gst, **sp["gst"])
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
            model=dataclasses.replace(cfg.model, **TACO1),
            speakers=dataclasses.replace(cfg.speakers, **sp),
            training=dataclasses.replace(cfg.training, **training)))
    return out


def batch_of(dvecs, num_freq=129):
    """3 rows of the smoke shapes with linear targets: speakers SYN00,
    SYN03, SYN01."""
    rng = np.random.default_rng(0)
    tl, ml = np.array([16, 12, 9], np.int32), np.array([24, 19, 13], np.int32)
    valid = np.arange(24)[None, :, None] < ml[:, None, None]
    text = np.where(np.arange(16)[None] < tl[:, None], rng.integers(1, 60, (3, 16)), 0)
    return {"text": text.astype(np.int32), "text_lengths": tl,
            "mel": (rng.normal(size=(3, 24, 20)) * valid).astype(np.float32),
            "linear": (rng.normal(size=(3, 24, num_freq)) * valid).astype(np.float32),
            "mel_lengths": ml,
            "stop_targets": (np.arange(12)[None] >= ((ml + 1) // 2 - 1)[:, None]).astype(
                np.float32),
            "speaker_ids": np.array([0, 3, 1], np.int32),
            "speaker_embeddings": np.stack([dvecs[n] for n in ("SYN00", "SYN03", "SYN01")])}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.cache
def jax_trainer(corpus_path, mixed=False):
    """The JAX package's Trainer on the unconditioned Tacotron(1) config:
    its dataset, its model (init seed 0) and its `_loss_fn` (mixed: its
    bf16 casts)."""
    jcfg, _ = configs(corpus_path, mixed_precision=mixed)
    return JaxTrainer(jcfg, verbose=False)


def cast_down(mixed, params, mel, spk):
    """The JAX Trainer's `_loss_fn` casts under mixed precision: the
    parameters, the teacher mels and the d-vectors to bf16."""
    if not mixed:
        return params, mel, spk
    return (cast_f32_to_bf16(params), mel.astype(jnp.bfloat16),
            None if spk is None else spk.astype(jnp.bfloat16))


def cast_up(out):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, out)


@functools.cache
def jax_step(corpus_path, kind, mixed, dvecs_key):
    """One teacher-forced step on `batch_of` under jax.value_and_grad,
    jitted: (variables, loss, its parts, gradients, new state, outputs).
    The unconditioned model goes through the JAX Trainer's own `_loss_fn`
    (its linear target, priority band and mixed-precision casts); a
    conditioned one through its forward and the criterion the JAX Trainer
    builds for Tacotron(1), cast as that `_loss_fn` casts."""
    b = {k: jnp.asarray(x) for k, x in batch_of(dict(dvecs_key)).items()}
    if kind is None:
        jt = jax_trainer(corpus_path, mixed)
        v = {"params": jt.state.params, "state": jt.state.model_state}
        b.pop("speaker_ids"), b.pop("speaker_embeddings")

        def loss_fn(params, state):
            total, (new_state, parts) = jt._loss_fn(params, state, b, None, 0, 2)
            cp, mel, _ = cast_down(mixed, params, b["mel"], None)
            out = jt.model.forward({"params": cp, "state": state}, b["text"],
                                   b["text_lengths"], mel, rng=None, train=True, r=2,
                                   mel_lengths=b["mel_lengths"])
            return total, (new_state, parts, cast_up({k: out[k] for k in OUTPUTS}))
    else:
        jcfg, _ = configs(corpus_path, kind)
        sp = jcfg.speakers
        n_spk = N_SPK if sp.use_speaker_embedding else 0
        spk_dim = SPK_DIM if sp.use_external_speaker_embedding_file else 0
        jm = jax_setup_model(len(jax_symbols), n_spk, jcfg, spk_dim)
        v = jm.init(jax.random.PRNGKey(0))
        t = jcfg.training
        crit = JaxTacotronLoss("Tacotron", t.loss_masking, t.seq_len_norm, jcfg.model.stopnet,
                               t.stopnet_pos_weight, t.ga_alpha, t.ga_sigma, t.ga_decay_steps,
                               t.decoder_loss_alpha, t.postnet_loss_alpha)
        band = int(3000 / (jcfg.audio.sample_rate / 2) * jcfg.audio.num_freq)

        def loss_fn(params, state):
            params, mel, spk = cast_down(mixed, params, b["mel"],
                                         b["speaker_embeddings"] if spk_dim else None)
            out = jm.forward({"params": params, "state": state}, b["text"], b["text_lengths"],
                             mel, rng=None, train=True, r=2, mel_lengths=b["mel_lengths"],
                             speaker_ids=b["speaker_ids"] if n_spk and not spk_dim else None,
                             speaker_embeddings=spk)
            out = cast_up(out)
            total, parts = crit(out, b["mel"], b["mel_lengths"], b["stop_targets"],
                                b["text_lengths"], step=0, r=2, linear_target=b["linear"],
                                n_priority_freq=band)
            return total, (out["state"], parts, {k: out[k] for k in OUTPUTS})

    (loss, (state, parts, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["state"])
    return (np_tree(v), float(loss), {k: float(x) for k, x in parts.items()}, np_tree(grads),
            np_tree(state), np_tree(out))


def port_trainer(corpus, kind=None, **training):
    path, dvecs = corpus
    _, cfg = configs(path, kind, **training)
    return Trainer(cfg, verbose=False, device="cpu",
                   speaker_embeddings=dvecs if kind == "dvec+gst" else None)


def port_step(corpus, kind, mixed, v):
    """The port Trainer's `_loss_fn` on `batch_of` with the JAX weights `v`
    (mixed: its bf16 casts): (loss, its parts, gradients and new BatchNorm
    state in the JAX layout, outputs)."""
    trainer = port_trainer(corpus, kind, mixed_precision=mixed)
    pm = trainer.model
    pm.load_state_dict(params_from_jax(v["params"], v["state"], jax_layouts(pm)), strict=True)
    nb = batch_of(corpus[1])
    if kind != "dvec+gst":
        nb.pop("speaker_embeddings")
    b = trainer._tensors(nb)
    assert "linear" in b and (("speaker_ids" in b) == (kind is not None))
    loss, parts, out = trainer._loss_fn(b, 2, None)
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


# the float32 cases keep their ids (the kind alone); the mixed ones add "mixed"
CASES = [pytest.param(kind, mixed, id=f"{kind}-mixed" if mixed else str(kind))
         for mixed in (False, True) for kind in (None, "table", "dvec+gst")]


@pytest.mark.parametrize("kind, mixed", CASES)
def test_train_step_matches_jax(corpus, kind, mixed):
    """The teacher-forced pass, the loss and its parts, every gradient leaf
    and the new BatchNorm statistics of one step, the port Trainer's
    `_loss_fn` against the JAX Trainer's (kind None: the priority band of
    the JAX Trainer, 96 of 129 bins at 8 kHz) or against the JAX forward
    and criterion (the conditioned variants).

    Float32 at the module's tolerances. Mixed precision: both sides cast
    the parameters, the teacher mels and the d-vectors to bf16 and the
    outputs back to float32 before the loss, but round inside at other
    points (XLA's scan and convolutions, the port's `decoder_step`
    rounding each product's inputs), so the outputs and the loss's parts
    are not held (a table model's stopnet loss moves by ~1.2e-3, each side
    as far from its float32 value as the other), the total loss is held at
    MIX_LOSS_TOL, and the gradients at MIX_*: each leaf, all leaves
    together, and the port's mixed gradient no farther from the JAX
    float32 gradient than the JAX mixed one is, by the ratio."""
    path, dvecs = corpus
    key = tuple((k, tuple(x)) for k, x in dvecs.items())
    v, ref_loss, ref_parts, ref_grads, ref_state, ref_out = jax_step(path, kind, mixed, key)
    loss, parts, got, got_state, out = port_step(corpus, kind, mixed, v)
    for k in OUTPUTS:
        assert out[k].shape == ref_out[k].shape, k
        assert np.isfinite(out[k]).all(), k
        if not mixed:
            np.testing.assert_allclose(out[k], ref_out[k], atol=OUT_TOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(loss, ref_loss, rtol=MIX_LOSS_TOL if mixed else LOSS_TOL)
    assert set(parts) == set(ref_parts)
    for k, x in ref_parts.items():
        assert np.isfinite(parts[k]), k
        if not mixed:
            np.testing.assert_allclose(parts[k], x, rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    ref = {k: np.asarray(x, np.float64) for k, x in _flatten(ref_grads).items()}
    assert set(got) == set(ref)
    cond = [k for k in ref if k.startswith(("['speaker_embedding']", "['gst']"))]
    assert {k.split("']")[0][2:] for k in cond} == {
        None: set(), "table": {"speaker_embedding"}, "dvec+gst": {"gst"}}[kind]
    if mixed:
        errs = leaf_errors(got, ref)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= MIX_LEAF_TOL, (worst, errs[worst])
        f32 = {k: np.asarray(x, np.float64)
               for k, x in _flatten(jax_step(path, kind, False, key)[3]).items()}
        assert rel_l2(got, ref) <= MIX_GRAD_TOL, rel_l2(got, ref)
        # and it is a bf16 gradient: at least half as far from the float32
        # one as the JAX mixed gradient (a float32 step would sit at ~1e-6)
        assert 0.5 * rel_l2(ref, f32) <= rel_l2(got, f32) <= MIX_F32_RATIO * rel_l2(ref, f32), (
            rel_l2(got, f32), rel_l2(ref, f32))
    else:
        assert rel_l2(got, ref) <= GRAD_TOL
    ref_state = _flatten(ref_state)
    assert set(got_state) == set(ref_state)
    for k, r in ref_state.items():
        np.testing.assert_allclose(got_state[k], r, rtol=MIX_STATE_TOL if mixed else STATE_TOL,
                                   atol=1e-3 if mixed else 1e-6, err_msg=k)


def test_priority_band_is_the_jax_trainers(corpus):
    """The band below 3 kHz: the JAX Trainer's count (96 of 129 bins at
    8 kHz), Tacotron(1) only."""
    trainer = port_trainer(corpus)
    assert trainer.n_priority_freq == jax_trainer(corpus[0])._n_priority_freq == 96
    _, cfg = configs(corpus[0])
    t2 = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                    model="Tacotron2")),
                 verbose=False, device="cpu")
    assert t2.n_priority_freq == 0 and "linear" not in next(t2.train_data.batches(4, 2))


def range_db(c):
    """Range-normalized values -> dB (the audio config c's inverse)."""
    return lambda s: (np.clip(s, -c.max_norm, c.max_norm) + c.max_norm) / (
        2 * c.max_norm) * -c.min_level_db + c.min_level_db


def hold_linear(got, ref, to_db):
    """Normalized linear spectrograms [..., T, F] (`to_db` maps them to dB)
    at LIN_AMP_TOL in amplitude of each frame's peak, and at MEL_TOL in
    their normalized values on the bins within LIN_DB_RANGE dB of the
    frame's peak."""
    amp = lambda s: 10.0 ** (to_db(s) / 20.0)  # noqa: E731
    peak = amp(ref).max(-1, keepdims=True)
    assert (np.abs(amp(got) - amp(ref)) <= LIN_AMP_TOL * peak).all()
    near = to_db(ref) >= to_db(ref).max(-1, keepdims=True) - LIN_DB_RANGE
    assert near.mean() > 0.3
    np.testing.assert_allclose(got[near], ref[near], atol=MEL_TOL, rtol=0)


def test_linear_batches_match_jax(corpus, tmp_path):
    """need_linear: every batch of the port's dataset (linear [B, T_mel,
    num_freq] padded like the mel) against the JAX Trainer's dataset; the
    linear spectrograms are cached apart from the mels and read back."""
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.data import TTSDataset

    trainer = port_trainer(corpus)
    jds = jax_trainer(corpus[0]).train_data
    assert trainer.train_data.need_linear and jds.need_linear
    for b, jb in zip(trainer.train_data.batches(5, 2, shuffle=True, seed=3),
                     jds.batches(5, 2, shuffle=True, seed=3)):
        assert set(b) == set(jb) and b["linear"].shape[2] == 129
        assert b["linear"].shape[:2] == b["mel"].shape[:2]
        for k in b:
            if k == "mel":
                np.testing.assert_allclose(b[k], jb[k], atol=MEL_TOL, rtol=0)
            elif k == "linear":
                hold_linear(b[k], jb[k], range_db(trainer.cfg.audio))
            else:
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        assert not b["linear"][int(b["n_real"]):].any()
    cfg = trainer.cfg
    items = [[e["text"], e["wav"], e["speaker"]] for e in trainer.train_data.entries[:3]]
    ds = TTSDataset(items, cfg, AudioProcessor(cfg.audio), cache_dir=str(tmp_path))
    files = sorted(os.listdir(tmp_path))
    assert sum(f.startswith("mel_") for f in files) == 3
    assert sum(f.startswith("lin_") for f in files) == 3
    again = TTSDataset(items, cfg, None, cache_dir=str(tmp_path))    # reads the cache only
    for e, f in zip(ds.entries, again.entries):
        np.testing.assert_array_equal(e["linear"], f["linear"])
        np.testing.assert_array_equal(e["mel"], f["mel"])


def test_train_step_moves_the_parameters(corpus):
    """One Trainer.train_step on a dataset batch: finite metrics, every
    decoder and PostCBHG weight moved, the BatchNorm running statistics
    moved, the step counted."""
    trainer = port_trainer(corpus)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    batch = next(trainer.train_data.batches(4, 2, shuffle=False))
    metrics = trainer.train_step(batch, 2)
    assert trainer.step == 1
    assert all(np.isfinite(metrics[k]) for k in ("loss", "postnet_loss", "grad_norm"))
    after = trainer.model.state_dict()
    for k in ("decoder.attention_rnn.weight_ih", "decoder.decoder_rnns.1.weight_hh",
              "decoder.proj_mel.weight", "last_linear.weight", "post_cbhg.gru.weight_ih_l0",
              "post_cbhg.bank_bn.running_mean", "encoder_cbhg.bank_bn.running_var"):
        assert not torch.equal(after[k], before[k]), k


def test_cli_trains_a_tacotron1_config(tmp_path, capsys):
    """bin/train.py --device cpu --max_steps 2 on a Tacotron(1) config: it
    generates its synthetic corpus, trains two steps and writes a
    checkpoint the port's Tacotron(1) loads strictly."""
    from your_voice_tts_torch.bin import train
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.text import symbols
    from your_voice_tts_torch.train.checkpoint import load_checkpoint

    with open(SMOKE, encoding="utf-8") as f:
        text = "\n".join(line for line in f if not line.strip().startswith("//"))
    raw = json.loads(text)
    raw.update(TACO1, batch_size=4)
    cfg_path = tmp_path / "taco1.json"
    cfg_path.write_text(json.dumps(raw))
    train.main(["--config_path", str(cfg_path), "--max_steps", "2", "--device", "cpu",
                "--output_path", str(tmp_path / "runs")])
    assert "GLOBAL_STEP: 2" in capsys.readouterr().out
    (run,) = os.listdir(tmp_path / "runs")
    ckpt = tmp_path / "runs" / run / "checkpoint_2.npz"
    model = setup_model(len(symbols), load_config(str(cfg_path)), device="cpu")
    assert load_checkpoint(model, str(ckpt))["step"] == 2
