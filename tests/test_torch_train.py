"""The port's training path against the JAX package's: losses, the whole
model's loss, gradients and BatchNorm state, the optimizer, the data
pipeline, and checkpoints the JAX package loads.

Inputs are made with numpy from a seed (or by the synthetic-corpus
generator both packages share) and handed to both sides. Dropout is off
(no rng / no generator): JAX's threefry masks cannot be reproduced.
"""

import dataclasses
import inspect
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from your_voice_tts_tpu.audio import AudioProcessor as JaxAudioProcessor
from your_voice_tts_tpu.config import TrainingConfig as JaxTrainingConfig
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.data import TTSDataset as JaxTTSDataset
from your_voice_tts_tpu.data import load_meta_data as jax_load_meta_data
from your_voice_tts_tpu.data.synthetic import make_synthetic_corpus as jax_make_corpus
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.models.losses import TacotronLoss as JaxTacotronLoss
from your_voice_tts_tpu.text import symbols as jax_symbols
from your_voice_tts_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from your_voice_tts_tpu.train.checkpoint import restore_partial
from your_voice_tts_tpu.train.optim import build_optimizer as jax_build_optimizer
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.config import TrainingConfig, load_config
from your_voice_tts_torch.data import TTSDataset, load_meta_data
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.models import setup_model
from your_voice_tts_torch.models.losses import TacotronLoss
from your_voice_tts_torch.text import symbols
from your_voice_tts_torch.train.checkpoint import load_checkpoint, params_to_jax
from your_voice_tts_torch.train.optim import RAdamStack
from your_voice_tts_torch.train.trainer import gradual_schedule

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")
CKPT = os.path.join(ROOT, "assets/bench_trained_smoke.npz")


def smoke_batch(B=3, T=16, T_mel=24, n_mels=20, r=2, seed=0):
    rng = np.random.default_rng(seed)
    tl = np.array([16, 12, 9][:B], np.int32)
    text = np.where(np.arange(T)[None] < tl[:, None],
                    rng.integers(1, len(symbols), (B, T)), 0).astype(np.int32)
    ml = np.array([24, 19, 13][:B], np.int32)
    mel = (rng.normal(size=(B, T_mel, n_mels)) * (np.arange(T_mel)[None, :, None]
                                                    < ml[:, None, None])).astype(np.float32)
    steps = (ml + r - 1) // r
    stop = (np.arange(T_mel // r)[None] >= (steps - 1)[:, None]).astype(np.float32)
    return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml,
            "stop_targets": stop}


def t_(x, dtype=None):
    x = torch.from_numpy(np.array(x))
    return x if dtype is None else x.to(dtype)


# --- losses -------------------------------------------------------------

@pytest.mark.parametrize("model,seq_len_norm,masking,step,extra", [
    ("Tacotron2", False, True, 0, None), ("Tacotron2", True, True, 12345, None),
    ("Tacotron2", False, False, None, "backward"), ("Tacotron", False, True, 500, "linear")])
def test_tacotron_loss_matches_jax(model, seq_len_norm, masking, step, extra):
    """Same outputs on both sides: every component and the total (MSE or
    L1, stop pos_weight 10, guided attention decayed by step, the
    bidirectional decoder's terms, Tacotron's linear target with a priority
    band), f32 rel 1e-5."""
    rng = np.random.default_rng(1)
    b = smoke_batch()
    out = {"decoder_outputs": rng.normal(size=b["mel"].shape),
           "postnet_outputs": rng.normal(size=b["mel"].shape),
           "stop_logits": 3 * rng.normal(size=b["stop_targets"].shape),
           "alignments": rng.random((3, 12, 16))}
    kw_call = {}
    if extra == "backward":
        out["decoder_backward_outputs"] = rng.normal(size=b["mel"].shape)
    if extra == "linear":
        out["postnet_outputs"] = rng.normal(size=b["mel"].shape[:2] + (33,))
        kw_call = {"linear_target": rng.normal(size=out["postnet_outputs"].shape).astype(
            np.float32), "n_priority_freq": 12}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    kw = dict(loss_masking=masking, seq_len_norm=seq_len_norm, stopnet_pos_weight=10.0,
              ga_alpha=5.0, ga_decay_steps=1000)
    _, ref = JaxTacotronLoss(model, **kw)(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(b["mel"]),
        jnp.asarray(b["mel_lengths"]), jnp.asarray(b["stop_targets"]),
        jnp.asarray(b["text_lengths"]), step=step, r=2,
        **{k: jnp.asarray(v) if k == "linear_target" else v for k, v in kw_call.items()})
    _, got = TacotronLoss(model, **kw)(
        {k: t_(v) for k, v in out.items()}, t_(b["mel"]), t_(b["mel_lengths"]),
        t_(b["stop_targets"]), t_(b["text_lengths"]), step=step, r=2,
        **{k: t_(v) if k == "linear_target" else v for k, v in kw_call.items()})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


# --- whole model ----------------------------------------------------------

def models_from_checkpoint():
    jcfg, cfg = jax_load_config(SMOKE), load_config(SMOKE)
    jm = jax_setup_model(len(jax_symbols), 0, jcfg)
    v = jm.init(jax.random.PRNGKey(0))
    params, state, _, _ = jax_load_checkpoint(CKPT, params=v["params"], model_state=v["state"])
    pm = setup_model(len(symbols), cfg, device="cpu")
    load_checkpoint(pm, CKPT)
    return jcfg, jm, params, state, pm


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_whole_model_loss_grads_and_bn_state_match_jax():
    """The trained smoke checkpoint, one teacher-forced training pass with
    dropout off: the loss, every gradient leaf and every new BatchNorm
    running statistic against jax.value_and_grad of the JAX package's
    forward + loss; rel 1e-4 in float32 (a leaf's error over its own
    largest magnitude, or 1e-2 of the largest gradient for near-zero
    leaves)."""
    jcfg, jm, params, state, pm = models_from_checkpoint()
    b = smoke_batch()
    crit_kw = dict(stopnet_pos_weight=10.0, ga_alpha=5.0, ga_decay_steps=1000)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params, state):
        out = jm.forward({"params": params, "state": state}, jb["text"], jb["text_lengths"],
                         jb["mel"], rng=None, train=True, r=2, mel_lengths=jb["mel_lengths"])
        total, _ = JaxTacotronLoss("Tacotron2", **crit_kw)(
            out, jb["mel"], jb["mel_lengths"], jb["stop_targets"], jb["text_lengths"],
            step=3, r=2)
        return total, out["state"]

    (ref_loss, ref_state), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params, state)

    pm.train()
    out = pm(t_(b["text"]).long(), t_(b["text_lengths"]), t_(b["mel"]),
             mel_lengths=t_(b["mel_lengths"]), r=2)
    loss, _ = TacotronLoss("Tacotron2", **crit_kw)(
        out, t_(b["mel"]), t_(b["mel_lengths"]), t_(b["stop_targets"]), t_(b["text_lengths"]),
        step=3, r=2)
    names = [n for n, p in pm.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for p in pm.parameters() if p.requires_grad])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)

    gm = setup_model(len(symbols), load_config(SMOKE), device="cpu")
    with torch.no_grad():
        own = dict(gm.named_parameters())
        for p in own.values():
            p.zero_()
        for n, g in zip(names, grads):
            own[n].copy_(g)
    got_grads, _ = params_to_jax(gm)
    ref = flat(ref_grads)
    assert set(got_grads) == set(ref)
    gscale = max(np.max(np.abs(v)) for v in ref.values())
    for k, r in ref.items():
        rel = np.max(np.abs(got_grads[k] - r)) / max(np.max(np.abs(r)), 1e-2 * gscale)
        assert rel < 1e-4, (k, rel)

    _, got_state = params_to_jax(pm)
    ref_state = flat(ref_state)
    assert set(got_state) == set(ref_state)
    for k, r in ref_state.items():
        np.testing.assert_allclose(got_state[k], r, rtol=1e-4, atol=1e-6, err_msg=k)


# --- optimizer --------------------------------------------------------------

def test_optimizer_matches_optax_chain():
    """8 updates from fixed gradients (the 4th non-finite, so skipped),
    Noam warmup, global-norm clipping that triggers on some steps, weight
    decay, and RAdam's rectified branch from its 6th applied update on:
    parameters within atol 1e-6 of optax's after every update."""
    kw = dict(lr=1e-2, wd=1e-2, warmup_steps=4, noam_schedule=True, grad_clip=1.0)
    jopt = jax_build_optimizer(JaxTrainingConfig(**kw))
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in p0]
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt = RAdamStack(tp, TrainingConfig(**kw))
    applied = []
    for i in range(8):
        scale = 0.1 if i % 2 else 2.0
        g = [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
        if i == 3:
            g[1][2] = np.nan
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        applied.append(opt.step([torch.from_numpy(x) for x in g]))
        for a, r in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    assert applied == [True, True, True, False, True, True, True, True]
    assert opt.count == 7 and opt.total_notfinite == 1


@pytest.mark.parametrize("step,expect", [(0, (7, 64)), (9999, (7, 64)), (10000, (5, 64)),
                                         (200000, (2, 32))])
def test_gradual_schedule(step, expect):
    sched = [[0, 7, 64], [10000, 5, 64], [50000, 3, 32], [130000, 2, 32]]
    assert gradual_schedule(step, sched, 2, 16) == expect
    assert gradual_schedule(step, None, 2, 16) == (2, 16)


# --- data -------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """A 12-item sr=8000 corpus made by the port's copy of the generator;
    the JAX package's own generator writes the same bytes."""
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic_corpus(str(root / "port"), n_items=12, sr=8000, n_speakers=2)
    jax_make_corpus(str(root / "jax"), n_items=12, sr=8000, n_speakers=2)
    return root


def test_synthetic_corpus_is_the_jax_one(tiny_corpus):
    for rel in ["metadata.csv"] + [os.path.join("wavs", f) for f in
                                   sorted(os.listdir(tiny_corpus / "jax" / "wavs"))]:
        with open(tiny_corpus / "port" / rel, "rb") as a, open(tiny_corpus / "jax" / rel,
                                                               "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("cfg_path", ["configs/smoke_synthetic.json",
                                      "configs/ljspeech_tacotron2.json"])
def test_melspectrogram_matches_jax(cfg_path):
    """Forward DSP mels (pre-emphasis, reflect-padded STFT, mel, dB,
    normalization) against the JAX AudioProcessor within 1e-4, for clips
    shorter and longer than a length bucket."""
    jc, pc = jax_load_config(os.path.join(ROOT, cfg_path)), load_config(
        os.path.join(ROOT, cfg_path))
    rng = np.random.default_rng(2)
    wavs = [(0.3 * np.sin(0.05 * np.arange(n)) + 0.05 * rng.standard_normal(n)).astype(
        np.float32) for n in (700, 7777, 40001)]
    jap, ap = JaxAudioProcessor(jc.audio), AudioProcessor(pc.audio)
    for r, g in zip(jap.melspectrogram_batch(wavs), ap.melspectrogram_batch(wavs)):
        assert r.shape == g.shape
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ap.melspectrogram(wavs[1]), jap.melspectrogram(wavs[1]),
                               atol=1e-4, rtol=0)
    w = np.concatenate([np.zeros(900), wavs[1], np.zeros(1300)]).astype(np.float32)
    np.testing.assert_array_equal(ap.trim_silence(w), jap.trim_silence(w))


def test_dataset_batches_match_jax(tiny_corpus):
    """TTSDataset.batches on the tiny corpus, shuffled, with a short final
    batch (phantom rows) and batch groups: text, lengths and stop targets
    exact, mel within 1e-4."""
    path = str(tiny_corpus / "port")

    def with_data(cfg, ds_cls):
        ds = ds_cls(name="synthetic", path=path, meta_file_train="metadata.csv")
        return dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, datasets=(ds,), batch_group_size=2))

    jcfg = jax_load_config(SMOKE)
    jcfg = with_data(jcfg, type(jcfg.data.datasets[0]))
    cfg = load_config(SMOKE)
    cfg = with_data(cfg, type(cfg.data.datasets[0]))
    j_items, j_eval = jax_load_meta_data(jcfg.data.datasets)
    items, ev = load_meta_data(cfg.data.datasets)
    assert items == j_items and ev == j_eval
    jds = JaxTTSDataset(j_items, jcfg, JaxAudioProcessor(jcfg.audio))
    ds = TTSDataset(items, cfg, AudioProcessor(cfg.audio))
    assert len(ds) == len(jds)
    rows = []
    for jb, b in zip(jds.batches(4, 2, shuffle=True, seed=3), ds.batches(4, 2, shuffle=True,
                                                                        seed=3)):
        assert set(b) == set(jb) - {"speaker_embeddings"}
        for k in b:
            if k == "mel":
                np.testing.assert_allclose(b[k], jb[k], atol=1e-4, rtol=0)
            else:
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        rows.append(int(b["n_real"]))
    assert sorted(rows) == [3, 4, 4]


# --- checkpoints and the CLI ------------------------------------------------

def test_cli_trains_and_saves_a_checkpoint_jax_loads(tmp_path, capsys):
    """`bin.train --device cpu` on the smoke config: 2 steps on a generated
    synthetic corpus, finite losses, a checkpoint that the JAX package's
    restore_partial loads leaf for leaf; the JAX eval-mode forward on it
    equals the port's within 1e-4."""
    from your_voice_tts_torch.bin import train

    train.main(["--config_path", SMOKE, "--max_steps", "2", "--device", "cpu",
                "--output_path", str(tmp_path)])
    printed = capsys.readouterr().out
    (run,) = os.listdir(tmp_path)
    path = os.path.join(tmp_path, run, "checkpoint_2.npz")
    assert os.path.exists(path) and "GLOBAL_STEP: 2" in printed
    losses = [float(x.split(":")[1]) for x in printed.split("|") if x.strip().startswith("loss:")]
    assert losses and all(np.isfinite(losses))

    jcfg = jax_load_config(SMOKE)
    jm = jax_setup_model(len(jax_symbols), 0, jcfg)
    v = jm.init(jax.random.PRNGKey(0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params, state, meta = restore_partial(path, params=v["params"], model_state=v["state"])
    assert meta["step"] == 2 and meta["r"] == 2
    pm = setup_model(len(symbols), load_config(SMOKE), device="cpu")
    load_checkpoint(pm, path)
    pm.eval()
    b = smoke_batch()
    ref = jm.forward({"params": params, "state": state}, jnp.asarray(b["text"]),
                     jnp.asarray(b["text_lengths"]), jnp.asarray(b["mel"]), rng=None,
                     train=False, r=2, mel_lengths=jnp.asarray(b["mel_lengths"]))
    with torch.no_grad():
        got = pm(t_(b["text"]).long(), t_(b["text_lengths"]), t_(b["mel"]),
                 mel_lengths=t_(b["mel_lengths"]), r=2)
    for k in ("decoder_outputs", "postnet_outputs", "alignments", "stop_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=0,
                                   err_msg=k)


def test_inference_after_a_train_step_uses_running_stats(tiny_corpus):
    """A train step leaves the model in training mode; inference still
    normalizes with the BatchNorm running statistics, leaves them as they
    are, and gives what it gives in eval mode."""
    from your_voice_tts_torch.train.trainer import Trainer

    cfg = load_config(SMOKE)
    ds = dataclasses.replace(cfg.data.datasets[0], name="synthetic",
                             path=str(tiny_corpus / "port"), meta_file_train="metadata.csv")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)))
    trainer = Trainer(cfg, verbose=False, device="cpu")
    trainer.train_step(smoke_batch(), 2)
    model = trainer.model
    assert model.training
    b = smoke_batch()
    kept = {k: v.clone() for k, v in model.named_buffers()}
    got = model.inference(b["text"], b["text_lengths"], max_decoder_steps=6, r=2,
                          decode_dtype=torch.float32)
    assert model.training
    for k, v in model.named_buffers():
        assert torch.equal(v, kept[k]), k
    model.eval()
    ref = model.inference(b["text"], b["text_lengths"], max_decoder_steps=6, r=2,
                          decode_dtype=torch.float32)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_trainer_restores_its_own_checkpoint(tmp_path):
    """Train 2 steps, save, restore into a fresh Trainer: parameters,
    BatchNorm state, optimizer moments and the step come back."""
    from your_voice_tts_torch.train.trainer import Trainer

    cfg = load_config(SMOKE)
    corpus = make_synthetic_corpus(str(tmp_path / "c"), n_items=12, sr=8000)
    ds = dataclasses.replace(cfg.data.datasets[0], path=corpus)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
                              training=dataclasses.replace(cfg.training, run_eval=False))
    a = Trainer(cfg, output_path=str(tmp_path / "run"), verbose=False, device="cpu")
    a.fit(max_steps=2)
    b = Trainer(cfg, verbose=False, device="cpu")
    meta = b.restore(str(tmp_path / "run" / "checkpoint_2.npz"))
    assert meta["step"] == 2 and b.step == 2 and b.optimizer.count == 2
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip(a.optimizer.mu + a.optimizer.nu, b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)


def test_trainer_refuses_tacotron1_before_reading_data(tmp_path):
    """A Tacotron(1) config raises in the constructor, before the audio
    processor or the dataset is built: the dataset path does not exist."""
    from your_voice_tts_torch.train.trainer import Trainer

    cfg = load_config(SMOKE)
    ds = dataclasses.replace(cfg.data.datasets[0], path=str(tmp_path / "missing"))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
                              model=dataclasses.replace(cfg.model, model="Tacotron"))
    with pytest.raises(NotImplementedError, match="Tacotron\\(1\\) training arrives"):
        Trainer(cfg, verbose=False, device="cpu")


@pytest.mark.parametrize("group,match", [("use_speaker_embedding", "multi-speaker training"),
                                         ("use_gst", "GST training")])
def test_trainer_refuses_conditioning_before_reading_data(tmp_path, group, match):
    """Conditioned training is Tacotron2's now, not yet Tacotron(1)'s: a
    multi-speaker or GST Tacotron(1) config raises in the constructor,
    before the audio processor or the dataset is built (the dataset path
    does not exist); the same conditioning on Tacotron2 gets past every
    refusal and fails only at the missing dataset."""
    from your_voice_tts_torch.train.trainer import Trainer

    cfg = load_config(SMOKE)
    ds = dataclasses.replace(cfg.data.datasets[0], path=str(tmp_path / "missing"))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
                              speakers=dataclasses.replace(cfg.speakers, **{group: True}))
    with pytest.raises(FileNotFoundError):
        Trainer(cfg, verbose=False, device="cpu")
    taco1 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model="Tacotron"))
    with pytest.raises(NotImplementedError, match="Tacotron\\(1\\) training arrives"):
        Trainer(taco1, verbose=False, device="cpu")
    # the refusal and its message are gone
    assert match not in inspect.getsource(Trainer.__init__)
