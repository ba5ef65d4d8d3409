"""GE2E speaker-encoder training in the port against the JAX package on the
CPU: the similarity matrix and the loss with their gradients, the N x M
window sampler under one seed, one trainer step of both recurrences from
the same weights on the same batch, checkpoints each package's trainer and
`load_encoder` read, and bin/train_speaker_encoder.

Inputs are made with numpy from a seed and handed to both sides; weights
come from the JAX `init` through the checkpoint bridge. Tolerances:
float32 1e-5 for values and gradients (sum order only), Adam's moments
1e-6; parameters after Adam steps within 1e-3 of the learning rate:
Adam's first update is lr g / (|g| + 1e-8), which for a gradient element
near 1e-8 moves with that element's rounding.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.audio import AudioProcessor as JaxAudioProcessor
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.data.formatters import synthetic as jax_synthetic
from your_voice_tts_tpu.speaker_encoder.dataset import \
    SpeakerEncoderDataset as JaxSpeakerEncoderDataset
from your_voice_tts_tpu.speaker_encoder.losses import ge2e_loss as jax_ge2e_loss
from your_voice_tts_tpu.speaker_encoder.losses import ge2e_similarity as jax_ge2e_similarity
from your_voice_tts_tpu.speaker_encoder.model import SpeakerEncoder as JaxSpeakerEncoder
from your_voice_tts_tpu.speaker_encoder.model import load_encoder as jax_load_encoder
from your_voice_tts_tpu.speaker_encoder.train import \
    SpeakerEncoderTrainer as JaxSpeakerEncoderTrainer
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.data.formatters import synthetic
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.speaker_encoder.dataset import SpeakerEncoderDataset
from your_voice_tts_torch.speaker_encoder.losses import (ge2e_loss, ge2e_similarity,
                                                         init_ge2e_params)
from your_voice_tts_torch.speaker_encoder.model import SpeakerEncoder, load_encoder, params_to_jax
from your_voice_tts_torch.speaker_encoder.train import SpeakerEncoderTrainer
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs/smoke_synthetic.json")


@pytest.mark.parametrize("N,M", [(3, 4), (4, 2), (2, 3)])
def test_ge2e_similarity_and_loss_match_jax(N, M):
    """The scaled similarity matrix (leave-one-out own centroids) and the
    softmax loss, with the loss's gradients in the embeddings, w and b,
    against jax.grad (jitted: one compile a shape)."""
    e = np.random.default_rng(N * 10 + M).standard_normal((N, M, 8)).astype(np.float32)
    w, b = np.float32(7.5), np.float32(-3.0)
    ref_sim = np.asarray(jax.jit(jax_ge2e_similarity)(jnp.asarray(e), w, b))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_ge2e_loss, argnums=(0, 1, 2)))(
        jnp.asarray(e), jnp.asarray(w), jnp.asarray(b))
    te, tw, tb = (torch.tensor(x, requires_grad=True) for x in (e, w, b))
    np.testing.assert_allclose(ge2e_similarity(te, tw, tb).detach().numpy(), ref_sim, atol=1e-5)
    loss = ge2e_loss(te, tw, tb)
    grads = torch.autograd.grad(loss, (te, tw, tb))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    assert {k: float(x) for k, x in init_ge2e_params().items()} == {"w": 10.0, "b": -5.0}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 12-item, 3-speaker sr=8000 corpus."""
    return make_synthetic_corpus(str(tmp_path_factory.mktemp("se")), n_items=12, sr=8000,
                                 n_speakers=3)


def test_sample_batch_draws_the_reference_windows(corpus):
    """The same items give mels within 1e-4 of the JAX dataset's, with an
    augmentation hook's extra views after each clip; with the same mels in
    place, one seed draws the same speakers, clips and starts, window for
    window, over several batches."""
    cfg, jcfg = load_config(SMOKE), jax_load_config(SMOKE)

    def halve(wav):
        return [0.5 * wav]

    ds = SpeakerEncoderDataset(synthetic(corpus), AudioProcessor(cfg.audio), num_frames=24,
                               augment_wav_fn=halve)
    jds = JaxSpeakerEncoderDataset(jax_synthetic(corpus), JaxAudioProcessor(jcfg.audio),
                                   num_frames=24, augment_wav_fn=halve)
    assert ds.speakers == jds.speakers == ["SYN00", "SYN01", "SYN02"]
    for spk in ds.speakers:
        assert len(ds.by_speaker[spk]) == len(jds.by_speaker[spk]) == 8
        for a, b in zip(ds.by_speaker[spk], jds.by_speaker[spk]):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    ds.by_speaker = jds.by_speaker
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for N, M in ((2, 3), (3, 4), (5, 2)):
        got, ref = ds.sample_batch(N, M, rng), jds.sample_batch(N, M, jrng)
        assert got.shape == (min(N, 3), M, 24, 20)
        np.testing.assert_array_equal(got, ref)


class _Fixed:
    """A dataset whose every batch is `mels`."""

    def __init__(self, mels):
        self.mels = mels

    def sample_batch(self, N, M, rng):
        return self.mels


def trainer_pair(recur_on_proj, mels, lr=1e-2):
    """(JAX trainer, port trainer) on the same init (the JAX package's,
    loaded into the port) and the same fixed batch: 20 mels, LSTMs of 32
    units projected to 16, two layers."""
    jt = JaxSpeakerEncoderTrainer(JaxSpeakerEncoder(20, 16, 32, 2, recur_on_proj=recur_on_proj),
                                  _Fixed(mels), lr=lr, num_speakers_per_batch=mels.shape[0],
                                  num_utters_per_speaker=mels.shape[1], verbose=False)
    pm = SpeakerEncoder(20, 16, 32, 2, recur_on_proj=recur_on_proj, device="cpu")
    pm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params), {},
                                       jax_layouts(pm)), strict=True)
    pt = SpeakerEncoderTrainer(pm, _Fixed(mels), lr=lr, num_speakers_per_batch=mels.shape[0],
                               num_utters_per_speaker=mels.shape[1], verbose=False, device="cpu")
    return jt, pt


@pytest.mark.parametrize("recur_on_proj", [True, False])
def test_trainer_step_matches_jax(recur_on_proj):
    """One step on the same batch from the same weights: the loss before
    it, and every parameter, w and b, and Adam's moments after it (global
    norm clipping at 3.0 triggers: the gradient's norm is above it)."""
    mels = (3 * np.random.default_rng(0).standard_normal((3, 4, 12, 20))).astype(np.float32)
    jt, pt = trainer_pair(recur_on_proj, mels)
    ref_loss = jt.fit(1)["loss"]
    got_loss = pt.fit(1)["loss"]
    np.testing.assert_allclose(got_loss, ref_loss, rtol=1e-5)
    assert pt.step == int(jt.state.step) == 1
    ref = _flatten(jt.state.params)
    got = params_to_jax(dict(pt.model.named_parameters()))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(pt.loss_params["w"].item(), float(jt.state.loss_params["w"]),
                               atol=1e-5)
    # b shifts every logit alike, so the softmax's gradient in it is 0 but
    # for rounding, and Adam's first step moves it by up to lr either way
    assert abs(pt.loss_params["b"].item() + 5.0) <= 1e-2 + 1e-6
    adam = jt.state.opt_state[1][0]
    ref_mu = _flatten({"model": adam.mu["model"], "loss": adam.mu["loss"]})
    got_mu = pt._jax_trees(pt.mu)
    for k in ref_mu:
        np.testing.assert_allclose(got_mu[k], ref_mu[k], atol=1e-6, err_msg=k)


def test_checkpoints_cross_both_ways(tmp_path):
    """The port's checkpoint restores into the JAX trainer strictly (its
    optax state included) and into both packages' load_encoder; the JAX
    trainer's restores into the port's trainer strictly; either way the
    next step matches."""
    mels = np.random.default_rng(1).standard_normal((3, 2, 10, 20)).astype(np.float32)
    jt, pt = trainer_pair(True, mels)
    pt.fit(2)
    path = pt.save(str(tmp_path / "port.npz"))
    jt.restore(path)
    assert int(jt.state.step) == 2
    enc, params = jax_load_encoder(path, default_input_dim=20)
    ref = _flatten(params)
    got = params_to_jax(dict(load_encoder(path, device="cpu").named_parameters()))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    jt.fit(1)
    jpath = str(tmp_path / "jax.npz")
    jt.save(jpath)
    fresh = trainer_pair(True, mels)[1]
    fresh.restore(jpath)
    assert fresh.step == 3
    for k, x in _flatten(jt.state.params).items():
        np.testing.assert_allclose(params_to_jax(dict(fresh.model.named_parameters()))[k], x,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(fresh.fit(1)["loss"], jt.fit(1)["loss"], rtol=1e-5)


def test_cli_trains_and_both_packages_load_it(corpus, tmp_path, capsys):
    """bin/train_speaker_encoder --device cpu on the corpus (the default
    widths, 80 -> 3 x 768 / 256 but 20 mels: the config's): final.npz in
    the run folder, which each package's load_encoder reads to the same
    weights."""
    from your_voice_tts_torch.bin import train_speaker_encoder

    train_speaker_encoder.main(["--config", SMOKE, "--data_path", corpus, "--formatter",
                                "synthetic", "--output_path", str(tmp_path), "--max_steps", "2",
                                "--num_frames", "16", "--num_speakers_per_batch", "2",
                                "--num_utters_per_speaker", "2", "--device", "cpu"])
    (run,) = os.listdir(tmp_path)
    assert run.startswith("speaker-encoder-")
    path = os.path.join(tmp_path, run, "final.npz")
    assert "speaker encoder saved" in capsys.readouterr().out
    enc = load_encoder(path, device="cpu")
    assert enc.proj_dim == 256 and len(enc.layers) == 3
    _, params = jax_load_encoder(path)
    ref = _flatten(params)
    got = params_to_jax(dict(enc.named_parameters()))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
