"""Data-parallel training in the port (parallel/mesh.py, the trainers under a
process group, bin/distribute.py) against the JAX package on the CPU.

Two gloo ranks (tests/torch_dp_worker.py, one spawn of both for every case
of the family) each take 4 rows of a global batch of 8, so that the JAX
side's 8 virtual CPU devices (tests/conftest.py) shard it with no phantom
rows; each case's JAX reference is the JAX step on that global batch,
sharded over its mesh (`shard_batch`) where the step takes a sharded batch.
The rows on rank 0 are the long ones, so every count a loss or a BatchNorm
divides by differs between the ranks: a step that averaged the ranks'
local losses, or normalized by local statistics, would miss the reference.

- Tacotron2 (BatchNorm masked by lengths in the postnet), float32: the
  summed loss parts and the gradient norm 1e-4 relative, every updated
  parameter within one float32 spacing plus 1e-4 of its leaf's largest
  move (tests/test_torch_grad_accum.py's rule), the BatchNorm running
  statistics 1e-4 / 1e-6; both ranks hold the same parameters;
- the same in mixed precision: the total loss at MIX_LOSS_TOL (1e-3),
  the gradient norm and the parameters' moves at MIX_MOVE_TOL rel L2 (0.1,
  the taco1 file's total gradient gate; RAdam's first update is the
  clipped gradient times the rate) against the JAX mixed step; every loss
  part 1e-4 against the port's own single-process mixed step on the
  global batch, and its gradients within a quarter of the bf16 spread
  (their distance from that step's float32 gradients) (whose parts differ
  from the JAX mixed step's by up to ~2e-3 here: the two packages round
  bf16 at other points);
- gradient accumulation (A = 2): each rank splits its own rows, so
  micro-batch i is the ranks' i-th slices together (the departure in
  ROADMAP C), pinned against the port's single-process A = 2 step on the
  global batch reordered that way, 1e-5 relative on the loss parts and
  the float32 rule on the parameters (the single-process A = 2 step is
  held against the JAX one in tests/test_torch_grad_accum.py);
- one MelGAN step (generator then discriminator), one WaveRNN step, one
  GE2E speaker-encoder step (2 of 4 speakers a rank) and one ParallelTTS
  step (bin/train_parallel.py's `local_rows` over a global
  batch of 7, padded to 8 with one phantom row as the reference's mesh pads
  it), at their single-device tests' tolerances;
- `sync_batch_shapes` over the two ranks.

`bin/distribute.py --device cpu` with two launcher processes (two hosts of
one gloo rank each) trains 2 steps, as tests/test_multihost.py checks the
JAX launcher: equal per-rank item counts, the same losses on both ranks, a
checkpoint from rank 0 only, which the JAX package restores.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel_tts import config as ptts_config
from tests.test_torch_parallel_tts import pair as ptts_pair
from tests.test_torch_train_variants import configs as tts_configs
from tests.test_torch_vocoder_train import jax_gan_step, voc_configs
from your_voice_tts_tpu.models import parallel_tts as jpt
from your_voice_tts_tpu.parallel.mesh import pad_batch_to_devices as jax_pad_batch_to_devices
from your_voice_tts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_tpu.train.trainer import Trainer as JaxTrainer
from your_voice_tts_tpu.vocoder.train_gan import GANTrainer as JaxGANTrainer
from your_voice_tts_tpu.vocoder.train_wavernn import WaveRNNTrainer as JaxWaveRNNTrainer
from your_voice_tts_torch.data.formatters import ljspeech
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.text import symbols
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax, params_to_jax
from your_voice_tts_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
WORLD = 2
LOSS_TOL, STATE_TOL = 1e-4, (1e-4, 1e-6)
MIX_LOSS_TOL, MIX_MOVE_TOL, MIX_SELF_RATIO = 1e-3, 0.1, 0.25


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tts_batch(B: int = 8, seed: int = 0) -> dict:
    """B rows at the smoke shapes (text 16, mel 24, r = 2); the first half
    long, the second short, so the halves' counts differ."""
    rng = np.random.default_rng(seed)
    tl = np.array([16, 15, 14, 16, 9, 7, 10, 6][:B], np.int32)
    ml = np.array([24, 23, 22, 24, 13, 9, 11, 7][:B], np.int32)
    text = np.where(np.arange(16)[None] < tl[:, None], rng.integers(1, 60, (B, 16)), 0)
    mel = rng.normal(size=(B, 24, 20)) * (np.arange(24)[None, :, None] < ml[:, None, None])
    return {"text": text.astype(np.int32), "text_lengths": tl, "mel": mel.astype(np.float32),
            "mel_lengths": ml,
            "stop_targets": (np.arange(12)[None] >= ((ml + 1) // 2 - 1)[:, None]).astype(
                np.float32)}


def ptts_batch(B: int = 7, seed: int = 1) -> dict:
    """B ParallelTTS rows (text 12, 40 frames), long ones first."""
    rng = np.random.default_rng(seed)
    tl = np.array([12, 11, 12, 10, 5, 4, 6][:B])
    ml = np.array([40, 36, 38, 33, 14, 12, 17][:B])
    text = np.zeros((B, 12), np.int64)
    dur = np.zeros((B, 12), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, len(symbols), n)
        d = rng.integers(1, 6, n)
        d[-1] += max(0, ml[i] - d.sum())
        dur[i, :n] = d
    mel = (rng.standard_normal((B, 40, 20)) * 0.5).astype(np.float32)
    return {"text": text, "text_lengths": tl.astype(np.int64), "durations": dur, "mel": mel,
            "mel_lengths": ml.astype(np.int64)}


def reorder_for_accumulation(batch: dict, A: int = 2) -> dict:
    """The global batch as one process's A-way split must see it to give
    the ranks' rank-local split: micro-batch i = every rank's i-th slice,
    in rank order."""
    B = len(batch["text"])
    n, m = B // WORLD, B // WORLD // A
    idx = [r * n + i * m + j for i in range(A) for r in range(WORLD) for j in range(m)]
    return {k: v[idx] for k, v in batch.items()}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(TTS corpus path, vocoder corpus items for the JAX and the port
    formatter): 12 and 4 items at sr 8000."""
    from your_voice_tts_tpu.data.formatters import ljspeech as jax_ljspeech

    tts = make_synthetic_corpus(str(tmp_path_factory.mktemp("dp_tts")), n_items=12, sr=8000)
    voc = make_synthetic_corpus(str(tmp_path_factory.mktemp("dp_voc")), n_items=4, sr=8000)
    return tts, jax_ljspeech(voc, "metadata.csv"), ljspeech(voc, "metadata.csv")


def jax_tts_trainer(corpus, **training):
    """The JAX Trainer of the smoke Tacotron2 with `training` set, its
    `_loss_fn` given no rng (dropout off)."""
    jcfg, _ = tts_configs(corpus, training=tuple(training.items()))
    jt = JaxTrainer(jcfg, verbose=False)
    loss_fn = jt._loss_fn
    jt._loss_fn = lambda params, state, batch, rng, step, r: loss_fn(params, state, batch,
                                                                     None, step, r)
    return jt


def port_state(model, jparams, jstate) -> dict:
    return params_from_jax(np_tree(jparams), np_tree(jstate), jax_layouts(model))


@pytest.fixture(scope="module")
def family(corpora, tmp_path_factory):
    """Every case's inputs, both ranks run once on them, and what each
    case's reference needs: {name: (case inputs, [rank 0 result, rank 1
    result], reference context)}."""
    tts, jitems, items = corpora
    job, ctx = {}, {}
    batch = tts_batch()
    for name, mixed in (("tts", False), ("tts_mixed", True)):
        jt = jax_tts_trainer(tts, mixed_precision=mixed)
        _, cfg = tts_configs(tts, training=(("mixed_precision", mixed),))
        model = Trainer(cfg, verbose=False, device="cpu").model
        job[name] = dict(kind="tts", cfg=cfg, batch=batch, r=2,
                         state=port_state(model, jt.state.params, jt.state.model_state))
        ctx[name] = jt
    _, cfg = tts_configs(tts, training=(("grad_accum_steps", 2), ("batch_size", 8)))
    job["tts_accum"] = dict(job["tts"], cfg=cfg)

    jg = JaxGANTrainer(voc_configs("melgan", steps_to_start_discriminator=0)[0], jitems,
                       verbose=False)
    _, gcfg = voc_configs("melgan", steps_to_start_discriminator=0)
    from your_voice_tts_torch.vocoder.train_gan import GANTrainer
    pg = GANTrainer(gcfg, items, verbose=False, device="cpu")
    mel, audio = pg.dataset.sample_batch(8, np.random.default_rng(4))
    state0 = jg.state
    ref, before, after, g_after = jax_gan_step(jg, mel, audio, True)
    job["gan"] = dict(kind="gan", cfg=gcfg, items=items, mel=mel, audio=audio, g_after=g_after,
                      g_state=params_from_jax(np_tree(state0.g_params), {},
                                              jax_layouts(pg.generator)),
                      d_state=params_from_jax(np_tree(state0.d_params), {},
                                              jax_layouts(pg.discriminator)))
    ctx["gan"] = (ref, before, after, jg.state)

    jw = JaxWaveRNNTrainer(voc_configs("wavernn")[0], jitems, verbose=False)
    _, wcfg = voc_configs("wavernn")
    from your_voice_tts_torch.vocoder.train_wavernn import WaveRNNTrainer
    pw = WaveRNNTrainer(wcfg, items, verbose=False, device="cpu")
    wmel, waudio = pw.dataset.sample_batch(8, np.random.default_rng(3))
    wbefore = np_tree(jw.state.params)
    jw_state, wloss = jw._step_fn(jw.state, jnp.asarray(wmel), jnp.asarray(waudio))
    job["wavernn"] = dict(kind="wavernn", cfg=wcfg, items=items, mel=wmel, audio=waudio,
                          state=params_from_jax(wbefore, {}, jax_layouts(pw.model)))
    ctx["wavernn"] = (float(wloss), wbefore, jw_state)

    _, v, pm = ptts_pair("shared")
    job["ptts"] = dict(kind="ptts", cfg=ptts_config("port", "shared"), batch=ptts_batch(),
                       state={k: t.clone() for k, t in pm.state_dict().items()})
    ctx["ptts"] = v

    from tests.test_torch_speaker_encoder_train import trainer_pair

    mels = (3 * np.random.default_rng(0).standard_normal((4, 4, 12, 20))).astype(np.float32)
    je, pe = trainer_pair(True, mels)
    job["ge2e"] = dict(kind="ge2e", mels=mels, dims=(20, 16, 32, 2), lr=1e-2,
                       state={k: t.clone() for k, t in pe.model.state_dict().items()})
    ctx["ge2e"] = je

    rng = np.random.default_rng(9)
    two = [dict(tts_batch(4, seed=s)) for s in (5, 6)]
    two[1] = {"text": two[1]["text"][:, :12], "text_lengths": np.minimum(two[1]["text_lengths"],
                                                                         12),
              "mel": two[1]["mel"][:, :18], "mel_lengths": np.minimum(two[1]["mel_lengths"], 18),
              "stop_targets": two[1]["stop_targets"][:, :9],
              "linear": rng.normal(size=(4, 18, 33)).astype(np.float32)}
    two[0]["linear"] = rng.normal(size=(4, 24, 33)).astype(np.float32)
    job["sync"] = dict(kind="sync", batches=two, r=2)

    job_dir = str(tmp_path_factory.mktemp("dp_job"))
    torch.save(job, os.path.join(job_dir, "job.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, job_dir, str(r), str(WORLD)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the data-parallel workers timed out")
        outs.append((p.returncode, out.decode()))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    results = [torch.load(os.path.join(job_dir, f"result{r}.pt"), weights_only=False)
               for r in range(WORLD)]
    return {name: (job[name], [res[name] for res in results], ctx.get(name)) for name in job}


def hold_params(got: dict, before: dict, after: dict, tol: float = 1e-4):
    """tests/test_torch_grad_accum.py's rule: each updated parameter within
    one float32 spacing plus `tol` of its leaf's largest move (or of 1e-2
    of the largest move anywhere)."""
    assert set(got) == set(after)
    moves = {k: np.max(np.abs(p1 - before[k])) for k, p1 in after.items()}
    largest = max(moves.values())
    assert largest > 0
    for k, p1 in after.items():
        spacing = np.spacing(np.abs(p1)).astype(np.float64)
        off = np.abs(got[k].astype(np.float64) - p1) - spacing
        assert np.max(off) <= tol * max(moves[k], 1e-2 * largest), (k, np.max(off), moves[k])


def same_on_every_rank(results: list, key: str):
    ref = results[0][key]
    for res in results[1:]:
        assert set(res[key]) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(res[key][k], v, err_msg=k)


def jax_tts_step(jt, batch):
    """The JAX Trainer's compiled step on the global batch, sharded over its
    mesh: (parameters before, after, new BatchNorm state, parts)."""
    before = {k: np.asarray(x, np.float64) for k, x in _flatten(jt.state.params).items()}
    sharded = jax_shard_batch({k: np.asarray(v) for k, v in batch.items()}, jt.mesh)
    new, parts = jt._get_train_step(2)(jt.state, sharded, jax.random.PRNGKey(0))
    return before, {k: np.asarray(x) for k, x in _flatten(new.params).items()}, \
        _flatten(new.model_state), {k: float(x) for k, x in parts.items()}


def test_tacotron2_step_matches_the_jax_data_parallel_step(family):
    """Float32: the two ranks' step against the JAX step on the global
    batch: the summed loss parts and the gradient norm, every parameter,
    the BatchNorm statistics over the global batch."""
    case, results, jt = family["tts"]
    before, after, ref_state, ref_parts = jax_tts_step(jt, case["batch"])
    for res in results:
        assert res["step"] == 1 and set(res["metrics"]) == set(ref_parts)
        for k, x in ref_parts.items():
            np.testing.assert_allclose(res["metrics"][k], x, rtol=LOSS_TOL, atol=1e-7,
                                       err_msg=k)
    same_on_every_rank(results, "params")
    same_on_every_rank(results, "state")
    hold_params(results[0]["params"], before, after)
    assert set(results[0]["state"]) == set(ref_state)
    for k, r in ref_state.items():
        np.testing.assert_allclose(results[0]["state"][k], r, rtol=STATE_TOL[0],
                                   atol=STATE_TOL[1], err_msg=k)


def moves(params: dict, before: dict) -> np.ndarray:
    keys = sorted(before)
    return np.concatenate([(np.asarray(params[k], np.float64) - before[k]).ravel()
                           for k in keys])


def port_step(cfg, state, batch):
    """The port's single-process Trainer step on the whole global batch,
    dropout off: (metrics, the gradients it applied, the parameters
    after), in the JAX layout."""
    from tests.torch_dp_worker import capture_grads

    one = Trainer(cfg, verbose=False, device="cpu")
    one.generator = None
    one.model.load_state_dict(state, strict=True)
    seen = capture_grads(one)
    metrics = one.train_step(batch, 2)
    return metrics, seen["grads"], params_to_jax(one.model)[0]


def flat(d: dict) -> np.ndarray:
    return np.concatenate([np.ravel(d[k]).astype(np.float64) for k in sorted(d)])


def test_mixed_tacotron2_step_matches(family, corpora):
    """Mixed precision: against the JAX mixed step on the global batch, the
    total loss at MIX_LOSS_TOL, the gradient norm and the parameters'
    moves at MIX_MOVE_TOL; against the port's single-process mixed step on
    the same global batch (which rounds bf16 where the two ranks do), every
    loss part 1e-4 relative, and the gradients within MIX_SELF_RATIO of the
    bf16 spread, the distance of that step's gradients from its float32
    step's (measured: 0.012 against a spread of 0.073, where permuting the
    rows of one process's batch moves them by 4e-4). The gradient norm is
    held as a gradient. The ranks round to bf16 at the same points as one
    process, but a bf16 backward sums over the batch before it rounds: the
    gradient of a BatchNorm's bf16 mean is each rank's partial sum rounded
    to bf16 and then summed, where one process rounds the whole sum once,
    and the sum cancels, so its rounding reaches every element behind it
    (the float32 step on the same ranks is within 1.4e-6 of its single
    process)."""
    case, results, jt = family["tts_mixed"]
    before, after, _, ref_parts = jax_tts_step(jt, case["batch"])
    got_parts = results[0]["metrics"]
    np.testing.assert_allclose(got_parts["loss"], ref_parts["loss"], rtol=MIX_LOSS_TOL)
    np.testing.assert_allclose(got_parts["grad_norm"], ref_parts["grad_norm"],
                               rtol=MIX_MOVE_TOL)
    same_on_every_rank(results, "params")
    assert rel_l2(moves(results[0]["params"], before), moves(after, before)) <= MIX_MOVE_TOL
    own, own_grads, _ = port_step(case["cfg"], case["state"], case["batch"])
    _, f32_grads, _ = port_step(family["tts"][0]["cfg"], case["state"], case["batch"])
    assert set(own) == set(got_parts) == set(ref_parts)
    for k, x in own.items():
        if k != "grad_norm":
            np.testing.assert_allclose(got_parts[k], x, rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    spread = rel_l2(flat(own_grads), flat(f32_grads))
    dp = rel_l2(flat(results[0]["grads"]), flat(own_grads))
    assert dp <= MIX_SELF_RATIO * spread, (dp, spread)
    np.testing.assert_allclose(got_parts["grad_norm"], own["grad_norm"], rtol=MIX_SELF_RATIO
                               * spread)


def test_accumulation_splits_each_ranks_rows(family):
    """grad_accum_steps 2 on two ranks: each rank splits its own 4 rows
    into two micro-batches of 2; the step equals one process's A = 2 step
    on the global batch reordered so that its micro-batch i holds every
    rank's i-th slice (loss parts 1e-5 relative, the parameters by the
    float32 rule against that step's update)."""
    case, results, _ = family["tts_accum"]
    one = Trainer(case["cfg"], verbose=False, device="cpu")
    one.generator = None
    one.model.load_state_dict(case["state"], strict=True)
    before = {k: v.astype(np.float64) for k, v in params_to_jax(one.model)[0].items()}
    ref = one.train_step(reorder_for_accumulation(case["batch"]), 2)
    for k, x in ref.items():
        np.testing.assert_allclose(results[0]["metrics"][k], x, rtol=1e-5, err_msg=k)
    same_on_every_rank(results, "params")
    hold_params(results[0]["params"], before, params_to_jax(one.model)[0])
    # the reference's own split (contiguous halves of the global batch)
    # gives another step: the choice is visible
    other = Trainer(case["cfg"], verbose=False, device="cpu")
    other.generator = None
    other.model.load_state_dict(case["state"], strict=True)
    contiguous = other.train_step(case["batch"], 2)
    assert abs(contiguous["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"])


def hold_adam(got: dict, got_moments: dict, before: dict, after: dict, ref_adam,
              leaf_tol: dict | None = None):
    """tests/test_torch_vocoder_train.py's `hold_update` on the ranks'
    results: Adam's moments 1e-3 rel L2 a leaf (or leaf_tol[kind][leaf]), each
    parameter by the float32 rule where Adam's denominator is at least 100
    eps and 1e-2 of the leaf's largest (or neither side moved it)."""
    for kind in ("mu", "nu"):
        ref = _flatten(np_tree(getattr(ref_adam, kind)))
        assert set(got_moments[kind]) == set(ref)
        for k, r in ref.items():
            tol = 1e-3 if leaf_tol is None else leaf_tol[kind][k]
            assert rel_l2(got_moments[kind][k], r) <= tol, (kind, k, rel_l2(
                got_moments[kind][k], r), tol)
    bc2 = 1.0 - np.float32(0.9) ** np.float32(int(ref_adam.count))
    nu = _flatten(np_tree(ref_adam.nu))
    mv = {k: np.max(np.abs(p1 - before[k])) for k, p1 in after.items()}
    largest = max(mv.values())
    for k, p1 in after.items():
        spacing = np.spacing(np.abs(p1)).astype(np.float64)
        off = np.abs(got[k].astype(np.float64) - p1) - spacing
        denom = np.sqrt(nu[k] / bc2)
        held = (denom >= max(100 * 1e-8, 1e-2 * denom.max())) | (p1 == before[k])
        assert np.max(off[held], initial=0.0) <= 1e-4 * max(mv[k], 1e-2 * largest), k


def test_gan_step_matches_the_jax_step(family):
    """One MelGAN step (generator, then discriminator on the reference's
    updated generator) on two ranks against the JAX trainer's steps on the
    global batch of 8: the summed loss parts 1e-4 relative, each side's
    Adam moments and parameters by `hold_adam`. The generator's gradient
    runs through the STFT loss, ill-conditioned in float32
    (tests/test_torch_vocoder_train.py): at 8 rows the port's own
    single-process step sits up to 2e-3 (rel L2, a leaf) from the JAX one,
    so each generator leaf is held within 1e-3 or 1.25 times that step's
    distance, whichever is larger, and within 1e-3 of that step."""
    from tests.test_torch_vocoder_train import port_gan_step
    from tests.torch_dp_worker import moments
    from your_voice_tts_torch.vocoder.train_gan import GANTrainer

    case, results, (ref, before, after, jstate) = family["gan"]
    for res in results:
        assert res["global_batch"] == 2     # batch_size 2, a multiple of 2 ranks
        assert set(res["parts"]) == set(ref) - {"step_time"}
        for k, v in res["parts"].items():
            np.testing.assert_allclose(v, ref[k], rtol=LOSS_TOL, err_msg=k)
    same_on_every_rank(results, "g")
    same_on_every_rank(results, "d")
    one = GANTrainer(case["cfg"], case["items"], verbose=False, device="cpu")
    one.generator.load_state_dict(case["g_state"], strict=True)
    one.discriminator.load_state_dict(case["d_state"], strict=True)
    port_gan_step(one, case["mel"], case["audio"], case["g_after"])
    own = moments(one.generator, one.g_opt)
    leaf_tol = {kind: {k: max(1e-3, 1.25 * rel_l2(own[kind][k], r)) for k, r in
                       _flatten(np_tree(getattr(jstate.g_opt[1][0], kind))).items()}
                for kind in ("mu", "nu")}
    for kind in ("mu", "nu"):
        for k, v in own[kind].items():
            assert rel_l2(results[0]["g_moments"][kind][k], v) <= 1e-3, (kind, k)
    hold_adam(results[0]["g"], results[0]["g_moments"], before["g"], after["g"],
              jstate.g_opt[1][0], leaf_tol)
    hold_adam(results[0]["d"], results[0]["d_moments"], before["d"], after["d"],
              jstate.d_opt[1][0])


def test_wavernn_step_matches_the_jax_step(family):
    """One WaveRNN step (mu-law, float32) on two ranks against the JAX
    trainer's `_step_fn` on the global batch of 8: the loss 1e-4 relative,
    the moments and parameters by `hold_adam`."""
    case, results, (ref_loss, before, jstate) = family["wavernn"]
    for res in results:
        np.testing.assert_allclose(res["loss"], ref_loss, rtol=LOSS_TOL)
    same_on_every_rank(results, "params")
    hold_adam(results[0]["params"], results[0]["moments"], _flatten(before),
              _flatten(np_tree(jstate.params)), jstate.opt_state[1][0])


def test_parallel_tts_step_matches_the_jax_mesh(family):
    """bin/train_parallel.py's step on two ranks (a global batch of 7,
    padded to 8 with one phantom row, 4 rows a rank) against the JAX
    forward + loss under jax.value_and_grad on the same batch padded by
    the JAX `pad_batch_to_devices` for its 8 devices: the summed loss
    parts 1e-5 relative, the summed gradients rel L2 1e-4 over all
    parameters and for each but the conv biases ahead of BatchNorm
    (rounding noise), tests/test_torch_parallel_tts.py's tolerances."""
    from tests.test_torch_parallel_tts import _ahead_of_bn

    case, results, v = family["ptts"]
    jm = ptts_pair("shared")[0]
    b = {k: jnp.asarray(x) for k, x in jax_pad_batch_to_devices(case["batch"], 8).items()}

    def loss(params):
        out = jm.forward({"params": params, "state": v["state"]}, b["text"], b["text_lengths"],
                         b["durations"], rng=None, train=True, max_frames=40)
        return jpt.ParallelTTSLoss()(out, b["mel"], b["durations"], b["text_lengths"])

    (_, parts), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    assert [res["rows"] for res in results] == [4, 4]
    for k, r in parts.items():
        for res in results:
            assert abs(res["parts"][k] - float(r)) <= 1e-5 * abs(float(r)), k
    pm = ptts_pair("shared")[2]
    sd = params_from_jax(np_tree(grads), {}, jax_layouts(pm))
    names = list(results[0]["grads"])
    ref = {n: sd[n].numpy() for n in names}
    got = results[0]["grads"]
    np.testing.assert_array_equal(np.concatenate([got[n].ravel() for n in names]),
                                  np.concatenate([results[1]["grads"][n].ravel() for n in names]))
    flat = lambda d: np.concatenate([np.ravel(d[n]) for n in names])  # noqa: E731
    assert rel_l2(flat(got), flat(ref)) <= 1e-4
    noise = _ahead_of_bn(pm)
    for n in names:
        if np.linalg.norm(ref[n]) and n not in noise:
            assert rel_l2(got[n], ref[n]) <= 1e-4, n


def test_speaker_encoder_step_matches_jax(family):
    """One GE2E step on two ranks (4 speakers, 2 embedded a rank, the batch
    gathered by the all-reduce) against the JAX trainer's step on its mesh
    (gcd(4, 8) = 4 devices) from the same weights on the same batch, at
    tests/test_torch_speaker_encoder_train.py's tolerances: the loss 1e-5
    relative, every parameter, w and Adam's first moment 1e-5 / 1e-6
    absolute (clipping at 3.0 triggers)."""
    case, results, jt = family["ge2e"]
    ref_loss = jt.fit(1)["loss"]
    ref = _flatten(jt.state.params)
    adam = jt.state.opt_state[1][0]
    ref_mu = _flatten({"model": adam.mu["model"], "loss": adam.mu["loss"]})
    for res in results:
        np.testing.assert_allclose(res["loss"], ref_loss, rtol=1e-5)
        assert set(res["params"]) == set(ref)
        for k in ref:
            np.testing.assert_allclose(res["params"][k], ref[k], atol=1e-5, err_msg=k)
        np.testing.assert_allclose(res["w"], float(jt.state.loss_params["w"]), atol=1e-5)
        for k in ref_mu:
            np.testing.assert_allclose(res["mu"][k], ref_mu[k], atol=1e-6, err_msg=k)
    same_on_every_rank(results, "params")


def test_sync_batch_shapes_over_two_ranks(family):
    """Rank 1's shorter batch (text 12, mel 18) is padded to rank 0's text
    16 and mel 24 frames: text, mel and linear with zeros, the stop targets
    with 1s to 12 steps; rank 0's batch comes back as it was."""
    case, results, _ = family["sync"]
    b0, b1 = case["batches"]
    for k, v in b0.items():
        np.testing.assert_array_equal(results[0][k], v, err_msg=k)
    got = results[1]
    assert got["text"].shape == (4, 16) and got["mel"].shape == (4, 24, 20)
    assert got["linear"].shape == (4, 24, 33) and got["stop_targets"].shape == (4, 12)
    np.testing.assert_array_equal(got["text"][:, :12], b1["text"])
    assert not got["text"][:, 12:].any() and not got["mel"][:, 18:].any()
    assert not got["linear"][:, 18:].any() and (got["stop_targets"][:, 9:] == 1).all()
    np.testing.assert_array_equal(got["stop_targets"][:, :9], b1["stop_targets"])
    np.testing.assert_array_equal(got["mel_lengths"], b1["mel_lengths"])


# ------------------------------------------------------------- the launcher

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distribute_trains_on_two_cpu_ranks(tmp_path):
    """`bin/distribute.py --device cpu` as two hosts of one rank each
    (--num_processes 2, --process_id 0 / 1, one coordinator address), 2
    steps of the smoke config at batch 4 a rank on a generated corpus:
    each says it is up, both ranks hold the same number of items (half of
    the training split each), print the same losses, rank 0 alone writes
    the checkpoint, and the JAX package's `restore_partial` loads it."""
    from your_voice_tts_tpu.config import load_config as jax_load_config
    from your_voice_tts_tpu.models import setup_model as jax_setup_model
    from your_voice_tts_tpu.text import symbols as jax_symbols
    from your_voice_tts_tpu.train.checkpoint import restore_partial

    with open(os.path.join(ROOT, "configs/smoke_synthetic.json"), encoding="utf-8") as f:
        raw = json.loads("\n".join(line for line in f if not line.strip().startswith("//")))
    raw.update(batch_size=4, run_eval=False)
    cfg_path = tmp_path / "smoke_dp.json"
    cfg_path.write_text(json.dumps(raw))
    address = f"localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "your_voice_tts_torch.bin.distribute", "--config_path",
         str(cfg_path), "--coordinator_address", address, "--num_processes", "2",
         "--process_id", str(i), "--device", "cpu", "--max_steps", "2", "--output_path",
         str(tmp_path / "runs"), "--rendezvous_timeout", "120"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the launcher timed out")
        outs.append(out.decode())
        assert p.returncode == 0, outs[-1][-4000:]
    counts, losses = [], []
    for i, out in enumerate(outs):
        assert f" > process {i}/2 up, 1 local / 2 global devices (gloo)" in out
        (n,) = re.findall(rf" > Rank {i}/2: (\d+) of \d+ training items", out)
        counts.append(int(n))
        losses.append(re.findall(r"GLOBAL_STEP: \d+\S* \| loss: ([0-9.]+)", out))
    assert counts[0] == counts[1] > 0
    assert losses[0] and losses[0] == losses[1]
    assert "CHECKPOINT" in outs[0] and "CHECKPOINT" not in outs[1]
    (run,) = os.listdir(tmp_path / "runs")
    path = tmp_path / "runs" / run / "checkpoint_2.npz"
    assert path.exists()
    jcfg = jax_load_config(str(cfg_path))
    v = jax_setup_model(len(jax_symbols), 0, jcfg).init(jax.random.PRNGKey(0))
    params, _, meta = restore_partial(str(path), params=v["params"], model_state=v["state"])
    assert int(meta["step"]) == 2
    assert any(not np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(v["params"])))
