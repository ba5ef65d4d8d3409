"""Speaker-conditioned and GST Tacotron2 training in the port against the
JAX package on the CPU: one teacher-forced step (loss, every gradient
leaf, the BatchNorm running statistics the GST reference encoder moves)
for a speaker table, d-vectors, GST and d-vectors + GST, in float32 and in
mixed precision; the dataset's speaker map, its refusal of an unknown
speaker and its d-vector batches; `Trainer.fit` on a 4-speaker corpus for
each conditioning; conditioned checkpoints both ways; the CLI.

Weights come from the JAX `init` through the checkpoint bridge, inputs
from numpy with a seed, dropout off (no rng, no generator). The JAX side
runs once a case, jitted (a compile of a few seconds; its Trainer is not
used: it compiles the whole step). The port side is the Trainer's own
`_loss_fn` on its plain route. Tolerances: float32 1e-4 (a leaf's max
error over its own largest magnitude, or over 1e-2 of the largest
gradient anywhere for a leaf near zero; sum order only); mixed precision
as test_conditioned_train_step_matches_jax states them (both sides round
the same bf16 casts, at other points inside).
"""

import dataclasses
import functools
import json
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.audio import AudioProcessor as JaxAudioProcessor
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.data import TTSDataset as JaxTTSDataset
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.models.losses import TacotronLoss as JaxTacotronLoss
from your_voice_tts_tpu.nn.core import cast_f32_to_bf16
from your_voice_tts_tpu.text import symbols as jax_symbols
from your_voice_tts_tpu.train.checkpoint import _flatten, restore_partial
from your_voice_tts_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.data import TTSDataset, load_meta_data
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax, params_to_jax
from your_voice_tts_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")
SPK_DIM, N_SPK = 16, 4
KINDS = {"table": dict(use_speaker_embedding=True),
         "dvec": dict(use_speaker_embedding=True, use_external_speaker_embedding_file=True,
                      speaker_embedding_dim=SPK_DIM),
         "gst": dict(use_gst=True),
         "dvec+gst": dict(use_speaker_embedding=True, use_external_speaker_embedding_file=True,
                          speaker_embedding_dim=SPK_DIM, use_gst=True)}
F32_TOL, BF16_TOL = 1e-4, 0.08


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 16-item, 4-speaker sr=8000 corpus (the generator both packages
    share) and each speaker's d-vector, drawn from a seed."""
    path = make_synthetic_corpus(str(tmp_path_factory.mktemp("corpus4")), n_items=16, sr=8000,
                                 n_speakers=N_SPK)
    rng = np.random.default_rng(7)
    return path, {f"SYN{i:02d}": rng.standard_normal(SPK_DIM).astype(np.float32)
                  for i in range(N_SPK)}


def configs(kind, corpus_path, mixed=False, **training):
    """(JAX config, port config): the smoke config on `corpus_path`,
    conditioned as KINDS[kind]."""
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(SMOKE)
        ds = dataclasses.replace(cfg.data.datasets[0], path=corpus_path)
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
            speakers=dataclasses.replace(cfg.speakers, **KINDS[kind]),
            training=dataclasses.replace(cfg.training, mixed_precision=mixed, **training)))
    return out


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batch_of(dvecs):
    """3 rows of the smoke shapes: speakers SYN00, SYN03, SYN01."""
    rng = np.random.default_rng(0)
    tl, ml = np.array([16, 12, 9], np.int32), np.array([24, 19, 13], np.int32)
    text = np.where(np.arange(16)[None] < tl[:, None], rng.integers(1, 60, (3, 16)), 0)
    mel = (rng.normal(size=(3, 24, 20)) * (np.arange(24)[None, :, None] < ml[:, None, None]))
    names = ["SYN00", "SYN03", "SYN01"]
    return {"text": text.astype(np.int32), "text_lengths": tl, "mel": mel.astype(np.float32),
            "mel_lengths": ml,
            "stop_targets": (np.arange(12)[None] >= ((ml + 1) // 2 - 1)[:, None]).astype(
                np.float32),
            "speaker_ids": np.array([0, 3, 1], np.int32),
            "speaker_embeddings": np.stack([dvecs[n] for n in names])}


@functools.cache
def jax_step(kind, mixed, corpus_path, dvecs_key):
    """The JAX package's conditioned Tacotron2 (init seed 0) and one
    teacher-forced step as its Trainer's `_loss_fn` takes it, under
    jax.value_and_grad, jitted: (variables, loss, gradients, new state)."""
    jcfg, _ = configs(kind, corpus_path, mixed)
    dvecs = dict(dvecs_key)
    n_spk = N_SPK if jcfg.speakers.use_speaker_embedding else 0
    spk_dim = SPK_DIM if jcfg.speakers.use_external_speaker_embedding_file else 0
    jm = jax_setup_model(len(jax_symbols), n_spk, jcfg, spk_dim)
    v = jm.init(jax.random.PRNGKey(0))
    b = {k: jnp.asarray(x) for k, x in batch_of(dvecs).items()}
    t = jcfg.training
    crit = JaxTacotronLoss("Tacotron2", t.loss_masking, t.seq_len_norm, jcfg.model.stopnet,
                           t.stopnet_pos_weight, t.ga_alpha, t.ga_sigma, t.ga_decay_steps,
                           t.decoder_loss_alpha, t.postnet_loss_alpha)

    def loss_fn(params, state):
        mel, spk = b["mel"], b["speaker_embeddings"] if spk_dim else None
        if mixed:
            params, mel = cast_f32_to_bf16(params), mel.astype(jnp.bfloat16)
            spk = None if spk is None else spk.astype(jnp.bfloat16)
        out = jm.forward({"params": params, "state": state}, b["text"], b["text_lengths"], mel,
                         rng=None, train=True, r=2, mel_lengths=b["mel_lengths"],
                         speaker_ids=b["speaker_ids"] if n_spk else None,
                         speaker_embeddings=spk)
        out = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, out)
        total, _ = crit(out, b["mel"], b["mel_lengths"], b["stop_targets"], b["text_lengths"],
                        step=0, r=2)
        return total, out["state"]

    (loss, state), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["state"])
    return np_tree(v), float(loss), np_tree(grads), np_tree(state)


def port_trainer(kind, corpus, mixed=False, **training):
    """A port Trainer (CPU) on the corpus for `kind`, with the d-vectors
    where it takes them."""
    path, dvecs = corpus
    _, cfg = configs(kind, path, mixed, **training)
    return Trainer(cfg, verbose=False, device="cpu",
                   speaker_embeddings=dvecs if cfg.speakers.use_external_speaker_embedding_file
                   else None)


def leaf_errors(got: dict, ref: dict) -> dict:
    gscale = max(np.max(np.abs(v)) for v in ref.values())
    return {k: float(np.max(np.abs(got[k] - r)) / max(np.max(np.abs(r)), 1e-2 * gscale))
            for k, r in ref.items()}


# conv biases ahead of a batch-statistics BatchNorm: the BatchNorm takes the
# bias out, so their exact gradient is 0 (or, where padded frames reach the
# next convolution, nearly so), and both sides return a cancelling sum's
# rounding noise
CANCELLING = re.compile(r"\['(blocks|convs)'\]\[\d+\](\['conv'\])?\['b'\]$")


def port_step(kind, corpus, mixed, v):
    """The port Trainer's `_loss_fn` on `batch_of` with the JAX weights `v`:
    (loss, gradients and new BatchNorm state in the JAX layout)."""
    path, dvecs = corpus
    trainer = port_trainer(kind, corpus, mixed)
    pm = trainer.model
    pm.load_state_dict(params_from_jax(v["params"], v["state"], jax_layouts(pm)), strict=True)
    E = pm.decoder.attention_rnn.weight_ih.shape[1] - 24
    assert E == 32 + {"table": 512, "dvec": SPK_DIM, "gst": 0, "dvec+gst": SPK_DIM}[kind]
    loss, _, _ = trainer._loss_fn(trainer._tensors(batch_of(dvecs)), 2, None)
    names = [n for n, p in pm.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, trainer.params)
    holder = dict(pm.named_parameters())
    with torch.no_grad():
        for p in holder.values():
            p.zero_()
        for n, g in zip(names, grads):
            holder[n].copy_(g)
        # copies: params_to_jax's arrays may share the parameters' storage
        got_grads, got_state = ({k: np.array(x) for k, x in tree.items()}
                                for tree in params_to_jax(pm))
    return loss.item(), got_grads, got_state


def rel_l2(a: dict, b: dict) -> float:
    keys = sorted(b)
    x, y = (np.concatenate([np.ravel(t[k]) for k in keys]) for t in (a, b))
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_conditioned_train_step_matches_jax(corpus, kind, mixed):
    """The loss, every gradient leaf (the speaker table's and the GST's
    among them) and every new BatchNorm running statistic (the GST
    reference encoder's: batch statistics in training mode) of one step,
    through the port Trainer's `_loss_fn` (its casts under mixed
    precision), against the JAX package's forward + loss under
    jax.value_and_grad.

    Float32: the loss at rel 1e-4, each leaf 1e-4 (over its own largest
    magnitude, or 1e-2 of the largest gradient), the cancelling conv
    biases within 1e-5 of the largest gradient on both sides.
    Mixed precision: both sides cast the same parameters and mels to bf16
    but round inside at other points (the JAX package's XLA scan and
    convolutions, the port's kernel rounding points), so a GST model's
    style moves by ~0.5% and a leaf by up to ~17%: the loss at rel 1e-3,
    each leaf 0.25, all leaves together rel L2 0.1, the cancelling biases
    under 5e-2 of the largest gradient on both sides, and the port's
    gradient no farther (rel L2) from the float32 one than 1.25 times the
    JAX package's mixed-precision gradient is. The running statistics:
    rel 1e-4 in float32, 1e-2 (atol 1e-3) in mixed precision."""
    path, dvecs = corpus
    key = tuple((k, tuple(x)) for k, x in dvecs.items())
    v, ref_loss, ref_grads, ref_state = jax_step(kind, mixed, path, key)
    loss, got, got_state = port_step(kind, corpus, mixed, v)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-3 if mixed else 1e-4)
    ref = {k: np.asarray(x, np.float64) for k, x in _flatten(ref_grads).items()}
    assert set(got) == set(ref)
    cond = [k for k in ref if k.startswith(("['speaker_embedding']", "['gst']"))]
    assert bool(cond) == (kind != "dvec")
    gscale = max(np.max(np.abs(x)) for x in ref.values())
    cancelling = [k for k in ref if CANCELLING.search(k)]
    assert len(cancelling) == (14 if "gst" in kind else 8)
    for k in cancelling:
        noise = max(np.max(np.abs(got[k])), np.max(np.abs(ref[k]))) / gscale
        assert noise <= (5e-2 if mixed else 1e-5), (k, noise)
    errs = leaf_errors(got, ref)
    worst = max((k for k in errs if k not in cancelling), key=errs.get)
    assert errs[worst] <= (0.25 if mixed else 1e-4), (worst, errs[worst])
    if mixed:
        f32 = {k: np.asarray(x, np.float64)
               for k, x in _flatten(jax_step(kind, False, path, key)[2]).items()}
        assert rel_l2(got, ref) <= 0.1
        assert rel_l2(got, f32) <= 1.25 * rel_l2(ref, f32), (rel_l2(got, f32), rel_l2(ref, f32))
    ref_state = _flatten(ref_state)
    assert set(got_state) == set(ref_state)
    for k, r in ref_state.items():
        np.testing.assert_allclose(got_state[k], r, rtol=1e-2 if mixed else 1e-4,
                                   atol=1e-3 if mixed else 1e-6, err_msg=k)


def test_dataset_takes_the_trainers_speaker_map_and_refuses_others(corpus):
    """The speaker map handed in numbers the speakers (not the dataset's
    own sorted order); without one the dataset builds its own; a speaker
    outside the map raises KeyError as in the JAX package; d-vectors come
    as speaker_embeddings [B, D] float32, zero on phantom rows; every
    batch equals the JAX dataset's (mels within 1e-4)."""
    path, dvecs = corpus
    jcfg, cfg = configs("dvec", path)
    items, _ = load_meta_data(cfg.data.datasets, eval_split=False)
    ap, jap = AudioProcessor(cfg.audio), JaxAudioProcessor(jcfg.audio)
    own = TTSDataset(items[:8], cfg, ap)
    assert own.speakers == {f"SYN{i:02d}": i for i in range(N_SPK)}
    mapping = {"SYN03": 0, "SYN02": 1, "SYN01": 2, "SYN00": 3}
    ds = TTSDataset(items, cfg, ap, speakers=mapping, speaker_embeddings=dvecs)
    jds = JaxTTSDataset(items, jcfg, jap, speakers=mapping, speaker_embeddings=dvecs)
    for b, jb in zip(ds.batches(6, 2, shuffle=True, seed=1), jds.batches(6, 2, shuffle=True,
                                                                         seed=1)):
        assert set(b) == set(jb)
        for k in b:
            if k == "mel":
                np.testing.assert_allclose(b[k], jb[k], atol=1e-4, rtol=0)
            else:
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        assert b["speaker_embeddings"].dtype == np.float32
        assert b["speaker_embeddings"].shape == (6, SPK_DIM)
        assert not b["speaker_embeddings"][int(b["n_real"]):].any()
    partial = TTSDataset(items, cfg, ap, speakers={"SYN00": 0, "SYN01": 1})
    with pytest.raises(KeyError, match="missing from the speaker mapping"):
        list(partial.batches(16, 2, shuffle=False))


@pytest.mark.parametrize("kind", list(KINDS))
def test_trainer_fits_each_conditioning(corpus, kind, tmp_path):
    """Trainer.fit(max_steps=2) on the 4-speaker corpus: finite losses, one
    sorted speaker map over train and eval items in both datasets, the
    table or the GST moved, a checkpoint whose optimizer moments cover
    them; a fresh Trainer restores it strictly."""
    trainer = port_trainer(kind, corpus, run_eval=True)
    trainer.output_path = str(tmp_path)
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    metrics = trainer.fit(max_steps=2)
    assert trainer.step == 2 and np.isfinite(metrics["loss"])
    if kind != "gst":
        assert trainer.train_data.speakers == {f"SYN{i:02d}": i for i in range(N_SPK)}
        assert trainer.eval_data.speakers is trainer.train_data.speakers
    cond = [n for n in names if n.startswith(("speaker_embedding", "gst."))]
    assert bool(cond) == (kind != "dvec")
    assert all(not torch.equal(trainer.model.state_dict()[n], before[n])
               for n in cond if n in ("speaker_embedding.weight", "gst.style.tokens"))
    if "gst" in kind:
        assert float(trainer.model.gst.ref.convs[0].bn.running_mean.abs().max()) > 0
    fresh = port_trainer(kind, corpus)
    (ckpt,) = [f for f in os.listdir(tmp_path) if f.startswith("checkpoint_")]
    fresh.restore(str(tmp_path / ckpt))
    for (k, x), y in zip(trainer.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip(trainer.optimizer.mu + trainer.optimizer.nu,
                    fresh.optimizer.mu + fresh.optimizer.nu):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["table", "dvec+gst"])
def test_conditioned_checkpoints_cross_both_ways(corpus, kind, tmp_path):
    """A port-written conditioned checkpoint loads in the JAX package's
    restore_partial leaf for leaf, without a warning (the table, the GST
    and its BatchNorm state included), and a JAX-written one restores into
    the port's Trainer strictly."""
    from your_voice_tts_torch.train.checkpoint import save_checkpoint

    path, dvecs = corpus
    jcfg, _ = configs(kind, path)
    trainer = port_trainer(kind, corpus)
    trainer.train_step(batch_of(dvecs), 2)
    out = save_checkpoint(str(tmp_path / "port.npz"), trainer.model, trainer.optimizer,
                          step=1, epoch=0, r=2)
    spk_dim = SPK_DIM if "dvec" in kind else 0
    jm = jax_setup_model(len(jax_symbols), N_SPK, jcfg, spk_dim)
    v = jm.init(jax.random.PRNGKey(3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params, state, meta = restore_partial(out, params=v["params"], model_state=v["state"])
    got_p, got_s = params_to_jax(trainer.model)
    for ref, got in ((_flatten(params), got_p), (_flatten(state), got_s)):
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ref[k]), got[k], err_msg=k)
    jpath = jax_save_checkpoint(str(tmp_path / "jax.npz"), params=v["params"],
                                model_state=v["state"], opt_state={}, step=7, epoch=0, r=2)
    assert trainer.restore(jpath)["step"] == 7
    sd = params_from_jax(np_tree(v["params"]), np_tree(v["state"]), jax_layouts(trainer.model))
    for k, x in trainer.model.state_dict().items():
        assert torch.equal(x, sd[k]), k


@pytest.mark.parametrize("kind", ["table", "dvec+gst"])
def test_cli_trains_a_conditioned_config(tmp_path, capsys, kind):
    """bin/train --device cpu on a conditioned smoke config: the synthetic
    corpus comes with 4 speakers, d-vectors from the config's external
    speakers.json (bin/compute_embeddings' layout), 2 finite steps and a
    checkpoint with the conditioning's leaves."""
    from your_voice_tts_torch.bin import train

    text = open(SMOKE, encoding="utf-8").read()
    extra = {"use_speaker_embedding": True}
    if kind != "table":
        spk = tmp_path / "speakers.json"
        rng = np.random.default_rng(1)
        spk.write_text(json.dumps({f"SYN{i:02d}": {"clip": {"embedding": rng.standard_normal(
            SPK_DIM).tolist()}} for i in range(N_SPK)}))
        extra.update(use_external_speaker_embedding_file=True, speaker_embedding_dim=SPK_DIM,
                     external_speaker_embedding_file=str(spk), use_gst=True)
    fields = ", ".join(f'"{k}": {json.dumps(x)}' for k, x in extra.items())
    cfg_path = tmp_path / "cond.json"
    cfg_path.write_text(text.replace('"run_name": "smoke",', f'"run_name": "smoke", {fields},'))
    train.main(["--config_path", str(cfg_path), "--max_steps", "2", "--device", "cpu",
                "--output_path", str(tmp_path / "runs")])
    printed = capsys.readouterr().out
    (run,) = os.listdir(tmp_path / "runs")
    assert run.startswith("smoke-")
    losses = [float(x.split(":")[1]) for x in printed.split("|") if x.strip().startswith("loss:")]
    assert losses and all(np.isfinite(losses))
    with np.load(tmp_path / "runs" / run / "checkpoint_2.npz") as z:
        keys = set(z.files)
    assert ("params::['speaker_embedding']['table']" in keys) == (kind == "table")
    assert ("params::['gst']['style']['tokens']" in keys) == (kind != "table")


def test_dvector_config_without_dvectors_is_refused():
    """A config conditioned on external d-vectors needs them: the Trainer
    raises before reading data, the JAX package would fail at its first
    step."""
    _, cfg = configs("dvec", "/nonexistent")
    with pytest.raises(ValueError, match="speaker_embeddings"):
        Trainer(cfg, verbose=False, device="cpu")
