"""Vocoder training in the port against the JAX package on the CPU: the
WaveRNN losses (`distribs`), the teacher-forced `WaveRNN.forward` and
`loss` in its three modes, `GANDataset`'s segments, both discriminators,
the STFT / LSGAN / feature-matching losses, one step of each trainer
against the JAX trainer's jitted step on the same batch, the trained MelGAN
asset resumed in both trainers, checkpoints both ways and the CLI.

Weights come from the JAX `init` through the checkpoint bridge; inputs are
made with numpy from a seed. Tolerances: the losses, logits, scores and
feature maps 1e-5 (absolute, of values ~1, or relative for a loss);
gradients 1e-4 relative L2 a leaf; a trainer step's loss parts 1e-4
relative and each updated parameter within one float32 spacing plus 1e-4
of its leaf's largest move (or of 1e-2 of the largest move anywhere),
tests/test_torch_grad_accum.py's rule; the dataset's audio exact
and its mels at the 1e-4 the port's mel tests hold. A mixed-precision
step is held at tests/test_torch_taco1_train.py's MIX_* rule (below).
"""

import copy
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.audio import AudioProcessor as JaxAP
from your_voice_tts_tpu.config import AudioConfig as JaxAudioConfig
from your_voice_tts_tpu.data.formatters import ljspeech as jax_ljspeech
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_tpu.vocoder import config as jvc
from your_voice_tts_tpu.vocoder import losses as jlosses
from your_voice_tts_tpu.vocoder.dataset import GANDataset as JaxGANDataset
from your_voice_tts_tpu.vocoder.models import distribs as jdistribs
from your_voice_tts_tpu.vocoder.models.melgan import \
    MelganMultiscaleDiscriminator as JaxMelganDisc
from your_voice_tts_tpu.vocoder.models.pwgan import ParallelWaveganDiscriminator as JaxPWGANDisc
from your_voice_tts_tpu.vocoder.models.wavernn import WaveRNN as JaxWaveRNN
from your_voice_tts_tpu.vocoder.train_gan import GANTrainer as JaxGANTrainer
from your_voice_tts_tpu.vocoder.train_wavernn import WaveRNNTrainer as JaxWaveRNNTrainer
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.config import AudioConfig
from your_voice_tts_torch.data.formatters import ljspeech
from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
from your_voice_tts_torch.train.checkpoint import (_swapped, jax_layouts, params_from_jax,
                                                  params_to_jax)
from your_voice_tts_torch.vocoder import config as vc
from your_voice_tts_torch.vocoder import losses
from your_voice_tts_torch.vocoder.dataset import GANDataset
from your_voice_tts_torch.vocoder.models import distribs
from your_voice_tts_torch.vocoder.models.melgan import MelganMultiscaleDiscriminator
from your_voice_tts_torch.vocoder.models.pwgan import ParallelWaveganDiscriminator
from your_voice_tts_torch.vocoder.models.wavernn import WaveRNN
from your_voice_tts_torch.vocoder.train_gan import GANTrainer
from your_voice_tts_torch.vocoder.train_wavernn import WaveRNNTrainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "assets/bench_trained_melgan.npz")
MELGAN_SMOKE = os.path.join(ROOT, "configs/melgan_smoke.json")
AUDIO = dict(num_mels=20, fft_size=256, sample_rate=8000, hop_length=64, win_length=256,
             preemphasis=0.98, mel_fmax=None, do_trim_silence=False)
# narrow models at the smoke audio (hop 64 = 4 x 4 x 4)
GROUPS = {"melgan": dict(upsample_factors=(4, 4, 4), base_channels=32, num_res_blocks=2,
                         num_scales=2, disc_base_channels=8),
          "pwgan": dict(upsample_factors=(4, 4, 4), num_layers=6, stacks=2,
                        residual_channels=8, gate_channels=16, skip_channels=8, disc_layers=4,
                        disc_channels=8),
          "wavernn": dict(bits=9, rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
                          num_res_blocks=2, upsample_factors=(4, 4, 4), target=96,
                          overlap=16)}
WAVERNN = dict(n_mels=20, bits=9, rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
               num_res_blocks=2, pad=2, upsample_factors=(4, 4, 4))
# a mixed-precision step (`hold_mixed`): the loss rel 1e-3, as
# tests/test_torch_taco1_train.py's MIX_LOSS_TOL; the gradients against the
# JAX package's own bf16 spread, its mixed gradient's distance from the
# float32 one. That spread is wide here: 0.048 / 0.118 / 0.064 rel L2 for
# WaveRNN's mu-law / MoL / Gaussian step (the reference's scan sums each
# step's share of a bf16 parameter's gradient in bf16) and 0.232 / 0.011
# for MelGAN's generator / discriminator (a 1% change in the generated
# signal moves the STFT loss's gradient by several times its size), so
# tests/test_torch_taco1_train.py's absolute leaf (0.25) and total (0.1)
# gates cannot hold against it. The readings, as fractions of the
# spread: the port's distance from the JAX gradient 0.94 / 0.78 / 0.97 /
# 1.12 / 1.18, from the float32 one 0.35 / 0.55 / 0.23 / 0.72 / 1.24; the
# worst leaf 1.66 of its own spread (floored at 0.05)
MIX_LOSS_TOL, MIX_SPREAD_RATIO = 1e-3, 1.5
MIX_LEAF_RATIO, MIX_LEAF_FLOOR, MIX_BF16_FLOOR = 2.0, 0.05, 0.1


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 4-item sr=8000 synthetic corpus in the LJSpeech layout and its
    items as each package's formatter reads them."""
    path = make_synthetic_corpus(str(tmp_path_factory.mktemp("voc")), n_items=4, sr=8000)
    return path, jax_ljspeech(path, "metadata.csv"), ljspeech(path, "metadata.csv")


@pytest.fixture(scope="module")
def jax_trainers(corpus):
    """get(model, mixed=False, mode=None) -> (a JAX trainer of voc_configs'
    `model`, its WaveRNN `mode` or mixed precision set, built once for the
    module and handed back at its initial state; a dict its users keep its
    compiled steps in)."""
    built: dict = {}

    def get(model: str, mixed: bool = False, mode: str | None = None):
        key = (model, mixed, mode)
        if key not in built:
            jcfg, _ = voc_configs(model, **mixed_kw(model, mixed, mode))
            cls = JaxWaveRNNTrainer if model == "wavernn" else JaxGANTrainer
            jt = cls(jcfg, corpus[1], verbose=False)
            built[key] = (jt, jt.state, {})
        jt, state0, steps = built[key]
        jt.state = state0
        return jt, steps

    return get


def mixed_kw(model: str, mixed: bool, mode: str | None) -> dict:
    """voc_configs' arguments for a WaveRNN `mode` and mixed precision."""
    kw = {"gan_mixed_precision" if model != "wavernn" else "mixed_precision": mixed}
    if mode is not None:
        kw["group"] = {**GROUPS[model], "mode": mode}
    return kw


def voc_configs(model: str, group=None, **training):
    """(JAX VocoderConfig, port VocoderConfig) for `model` at the smoke
    audio with GROUPS[model] (or `group`) and a batch of 2 x 512 samples."""
    group = GROUPS[model] if group is None else group
    out = []
    for mod, audio_cls in ((jvc, JaxAudioConfig), (vc, AudioConfig)):
        sub = {"melgan": mod.MelganConfig, "pwgan": mod.PWGANConfig,
               "wavernn": mod.WaveRNNConfig}[model](**group)
        t = mod.VocoderTrainingConfig(**{"batch_size": 2, "seq_len": 512,
                                         "mixed_precision": False, **training})
        out.append(mod.VocoderConfig(model=model, audio=audio_cls(**AUDIO), training=t,
                                     **{model: sub}))
    return out


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------- the losses


def test_distribution_losses_match_jax():
    """The discretized mixture of logistics (16-bit bins, both edge bins'
    tails, the narrow-bin switch to the centre's density, log-scales below
    the floor) and the Gaussian: the mean 1e-5 relative, each element 1e-4
    (a log-scale near the floor scales exp's last-bit difference between
    the two by up to 1e7 inside the logistic), the gradients 1e-4 rel
    L2."""
    rng = np.random.default_rng(0)
    y_hat = rng.normal(size=(3, 40, 30)).astype(np.float32)
    y_hat[..., 20:] = rng.uniform(-20, 1, (3, 40, 10))          # log-scales, some floored
    y = np.tanh(rng.normal(size=(3, 40)) * 1.5).astype(np.float32)
    y[0, :4] = [-1.0, 1.0, -0.9995, 0.9995]                      # the edge bins
    y[1, :10] = y_hat[1, :10, 10]                                # at a mean: narrow bins
    for fn, jfn, yh in ((distribs.discretized_mix_logistic_loss,
                         jdistribs.discretized_mix_logistic_loss, y_hat),
                        (distribs.gaussian_loss, jdistribs.gaussian_loss, y_hat[..., :2])):
        got = fn(t(yh), t(y), reduce=False).numpy()
        ref = np.asarray(jax.jit(functools.partial(jfn, reduce=False))(jnp.asarray(yh),
                                                                       jnp.asarray(y)))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        x = t(yh).requires_grad_(True)
        loss = fn(x, t(y))
        (g,) = torch.autograd.grad(loss, x)
        ref_loss, ref_g = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(yh), jnp.asarray(y))
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
        assert rel_l2(g.numpy(), ref_g) <= 1e-4


@functools.cache
def wavernn_pair(mode: str):
    jm = JaxWaveRNN(**WAVERNN, mode=mode)
    p = np_tree(jm.init(jax.random.PRNGKey(2)))
    pm = WaveRNN(**WAVERNN, mode=mode, device="cpu")
    pm.load_state_dict(params_from_jax(p, {}, jax_layouts(pm)), strict=True)
    return jm, p, pm


@pytest.mark.parametrize("mode", ["mulaw", "mol", "gauss"])
def test_wavernn_forward_and_loss_match_jax(mode):
    """Teacher-forced logits over 512 samples (the two whole-sequence GRU
    calls against the JAX sample scan) 1e-5, the NLL 1e-5 relative and its
    gradients over all leaves as the comment below states."""
    jm, p, pm = wavernn_pair(mode)
    rng = np.random.default_rng(1)
    mels = rng.normal(size=(2, 12, 20)).astype(np.float32)
    audio = np.tanh(rng.normal(size=(2, 512)) * 0.4).astype(np.float32)
    x = np.tanh(rng.normal(size=(2, 512))).astype(np.float32)
    got = pm.train()(t(x), t(mels))
    ref = np.asarray(jax.jit(jm.forward)(p, jnp.asarray(x), jnp.asarray(mels)))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=0)
    got_g = {}
    for dt in (torch.float32, torch.float64):
        m = copy.deepcopy(pm).to(dt)
        loss = m.loss(t(mels).to(dt), t(audio).to(dt))
        if dt == torch.float32:
            loss32 = loss.item()
        grads = torch.autograd.grad(loss, list(m.parameters()))
        with _swapped(pm, [g.float() for g in grads]):
            got_g[dt] = {k: v.astype(np.float64) for k, v in params_to_jax(pm)[0].items()}
    ref_loss, ref_g = jax.jit(jax.value_and_grad(jm.loss))(p, jnp.asarray(mels),
                                                           jnp.asarray(audio))
    np.testing.assert_allclose(loss32, float(ref_loss), rtol=1e-5)
    ref_g = _flatten(np_tree(ref_g))
    assert set(got_g[torch.float32]) == set(ref_g)
    keys = sorted(ref_g)
    cat = lambda d: np.concatenate([np.ravel(d[k]) for k in keys])  # noqa: E731
    exact = cat(got_g[torch.float64])
    # the gradient through 512 GRU steps in float32 (~1e-4 from float64 for
    # MoL): the port's float64 gradient within 1e-3 of the JAX one, the
    # port's float32 one 1e-4 from it or no farther than the JAX float32
    # gradient is, by 1.25 (tests/test_torch_taco1_train.py's MIX_F32_RATIO)
    assert rel_l2(cat(ref_g), exact) <= 1e-3
    assert rel_l2(cat(got_g[torch.float32]), exact) <= max(1e-4,
                                                          1.25 * rel_l2(cat(ref_g), exact))


def test_gan_dataset_segments_match_jax(corpus):
    """Six draws from one seed (WaveRNN's pad 2, a 512-sample segment):
    the same clips and starts, the audio exact, the mels 1e-4."""
    path, jitems, items = corpus
    cfg = AudioConfig(**AUDIO)
    ref = JaxGANDataset(jitems, JaxAP(JaxAudioConfig(**AUDIO)), seq_len=512, pad=2)
    got = GANDataset(items, AudioProcessor(cfg), seq_len=512, pad=2)
    (rm, ra), (gm, ga) = (d.sample_batch(6, np.random.default_rng(5)) for d in (ref, got))
    assert gm.shape == rm.shape == (6, 12, 20) and ga.shape == ra.shape == (6, 512)
    np.testing.assert_array_equal(ga, ra)
    np.testing.assert_allclose(gm, rm, atol=1e-4, rtol=0)


def disc_pairs():
    jm = JaxMelganDisc(3, 4)
    pm_ = MelganMultiscaleDiscriminator(3, 4, device="cpu")
    jp = JaxPWGANDisc(5, 8)
    pp = ParallelWaveganDiscriminator(5, 8, device="cpu")
    out = {}
    for name, j, m, n in (("melgan", jm, pm_, 1021), ("pwgan", jp, pp, 300)):
        p = np_tree(j.init(jax.random.PRNGKey(4)))
        m.load_state_dict(params_from_jax(p, {}, jax_layouts(m)), strict=True)
        out[name] = (j, p, m, n)
    return out


@pytest.mark.parametrize("name", ["melgan", "pwgan"])
def test_discriminators_match_jax(name):
    """The multi-scale MelGAN discriminator (3 scales, base 4, grouped
    strided convs) on an odd length (1,021: the SAME pooling pads 1 and 2)
    and the PWGAN discriminator (5 layers, 8 channels): scores and every
    feature map 1e-5, the gradients of a loss over all of them with
    respect to every weight and the input 1e-4 rel L2 each."""
    j, p, m, n = disc_pairs()[name]
    x = np.tanh(np.random.default_rng(6).normal(size=(2, n))).astype(np.float32)
    jcall = (lambda q, a: j(q, a)) if name == "melgan" else (lambda q, a: [j(q, a)])
    mcall = (lambda a: m(a)) if name == "melgan" else (lambda a: [m(a)])

    def jloss(q, a):
        return sum(jnp.mean(s ** 2) + sum(jnp.mean(f ** 3) for f in fs) for s, fs in jcall(q, a))

    xt = t(x).requires_grad_(True)
    outs = mcall(xt)
    for (s, fs), (rs, rfs) in zip(outs, jax.jit(jcall)(p, jnp.asarray(x))):
        np.testing.assert_allclose(s.detach().numpy(), np.asarray(rs), atol=1e-5, rtol=0)
        assert len(fs) == len(rfs)
        for f, rf in zip(fs, rfs):
            np.testing.assert_allclose(f.detach().numpy(), np.asarray(rf), atol=1e-5, rtol=0)
    loss = sum((s ** 2).mean() + sum((f ** 3).mean() for f in fs) for s, fs in outs)
    grads = torch.autograd.grad(loss, [xt] + list(m.parameters()))
    ref_p, ref_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    assert rel_l2(grads[0].numpy(), ref_x) <= 1e-4
    holder = dict(m.named_parameters())
    with torch.no_grad():
        for (nme, _), g in zip(m.named_parameters(), grads[1:]):
            holder[nme].copy_(g)
    got_g, ref_g = params_to_jax(m)[0], _flatten(np_tree(ref_p))
    assert set(got_g) == set(ref_g)
    for k in ref_g:
        assert rel_l2(got_g[k], ref_g[k]) <= 1e-4, k


@pytest.mark.parametrize("n", [512, 1100])
def test_vocoder_losses_match_jax(n):
    """At a 512-sample segment (shorter than the 2,048 resolution's pad of
    1,024) and an odd 1,100: each resolution's spectral convergence and
    log-magnitude, the multi-resolution loss and its gradient (held
    against the float64 gradient as the comment says); the LSGAN losses and
    feature matching over two scales."""
    rng = np.random.default_rng(n)
    y, y_hat = (np.tanh(rng.normal(size=(3, n))).astype(np.float32) for _ in range(2))
    for res in jlosses.DEFAULT_RESOLUTIONS:
        got = losses.stft_loss(t(y_hat), t(y), *res)
        ref = jax.jit(functools.partial(jlosses.stft_loss, n_fft=res[0], hop=res[1],
                                        win=res[2]))(jnp.asarray(y_hat), jnp.asarray(y))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)
    grads = []
    for dt in (torch.float32, torch.float64):
        yt = torch.from_numpy(y_hat).to(dt).requires_grad_(True)
        got = losses.multi_scale_stft_loss(yt, torch.from_numpy(y).to(dt))
        grads.append(torch.autograd.grad(got, yt)[0].numpy())
        if dt == torch.float32:
            loss32 = got.item()
    ref, ref_g = jax.jit(jax.value_and_grad(jlosses.multi_scale_stft_loss))(
        jnp.asarray(y_hat), jnp.asarray(y))
    np.testing.assert_allclose(loss32, float(ref), rtol=1e-5)
    # the gradient in float32 sits 0.7-3.7e-4 (rel L2) from its float64
    # value on either side (the L1's signs and 1 / |STFT|): both float32
    # gradients within 1e-3 of the port's float64 one
    assert rel_l2(ref_g, grads[1]) <= 1e-3 and rel_l2(grads[0], grads[1]) <= 1e-3
    scores = [rng.normal(size=(3, k, 1)).astype(np.float32) for k in (9, 5)]
    fakes = [rng.normal(size=(3, k, 1)).astype(np.float32) for k in (9, 5)]
    feats = [[rng.normal(size=(3, k, c)).astype(np.float32) for c in (4, 8)] for k in (9, 5)]
    feats2 = [[rng.normal(size=(3, k, c)).astype(np.float32) for c in (4, 8)] for k in (9, 5)]
    tt = lambda xs: [t(a) for a in xs]  # noqa: E731
    jj = lambda xs: [jnp.asarray(a) for a in xs]  # noqa: E731
    for got, ref in ((losses.gen_adv_loss(tt(scores)), jlosses.gen_adv_loss(jj(scores))),
                     (losses.disc_adv_loss(tt(scores), tt(fakes)),
                      jlosses.disc_adv_loss(jj(scores), jj(fakes))),
                     (losses.feature_match_loss([tt(f) for f in feats], [tt(f) for f in feats2]),
                      jlosses.feature_match_loss([jj(f) for f in feats],
                                                 [jj(f) for f in feats2]))):
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


# ---------------------------------------------------------- the trainer steps


def hold_update(got_model, before: dict, after: dict, adam, ref_adam, got=None):
    """The step's update, the port's against the JAX trainer's. Adam's
    moments (mu and nu, linear and quadratic in the step's gradient) 1e-3
    rel L2 a leaf (a gradient through a whole generator is read to ~1e-4
    in float32 on either side); and each parameter within one float32
    spacing plus 1e-4 of its leaf's largest move (or of 1e-2 of the
    largest move anywhere), tests/test_torch_grad_accum.py's rule,
    wherever Adam's denominator sqrt(nu_hat) is at least 100 eps and 1e-2
    of the leaf's largest, or neither side moved it: below that the update
    mu_hat / (sqrt(nu_hat) + eps) divides the gradient's rounding (~1e-4
    of the leaf's largest gradient) by a number near eps or near the
    element's own small gradient (a fresh state's first step moves an
    element by lr * g / (|g| + eps)), and the moments hold it."""
    got = params_to_jax(got_model)[0] if got is None else got
    assert set(got) == set(after)
    for kind in ("mu", "nu"):
        with _swapped(got_model, getattr(adam, kind)):
            mom = params_to_jax(got_model)[0]
        ref = _flatten(np_tree(getattr(ref_adam, kind)))
        assert set(mom) == set(ref)
        for k, r in ref.items():
            assert rel_l2(mom[k], r) <= 1e-3, (kind, k, rel_l2(mom[k], r))
    bc2 = 1.0 - np.float32(adam.b2) ** np.float32(int(ref_adam.count))
    nu = _flatten(np_tree(ref_adam.nu))
    moves = {k: np.max(np.abs(p1 - before[k])) for k, p1 in after.items()}
    largest = max(moves.values())
    assert largest > 0
    for k, p1 in after.items():
        spacing = np.spacing(np.abs(p1)).astype(np.float64)
        off = np.abs(got[k].astype(np.float64) - p1) - spacing
        denom = np.sqrt(nu[k] / bc2)
        held = (denom >= max(100 * adam.eps, 1e-2 * denom.max())) | (p1 == before[k])
        assert np.max(off[held], initial=0.0) <= 1e-4 * max(moves[k], 1e-2 * largest), (
            k, np.max(off[held]), moves[k])


def adam_mu(model, adam) -> dict:
    """The port's Adam first moment in the JAX layout: after one step from
    a fresh state, (1 - b1) times the clipped gradient."""
    with _swapped(model, adam.mu):
        return {k: v.astype(np.float64) for k, v in params_to_jax(model)[0].items()}


def jax_mu(adam_state) -> dict:
    return {k: np.asarray(v, np.float64) for k, v in _flatten(np_tree(adam_state.mu)).items()}


def hold_mixed(got: dict, ref: dict, f32: dict):
    """A mixed-precision step's gradient (read from Adam's first moment),
    the port's (got) against the JAX package's (ref), measured against the
    reference's own bf16 spread, the distance of its mixed gradient from
    the float32 one (f32): all leaves together no farther from ref than
    MIX_SPREAD_RATIO times that spread, and each leaf (rel L2) no farther
    than MIX_LEAF_RATIO times its own or MIX_LEAF_FLOOR; the port's mixed
    gradient at least MIX_BF16_FLOOR and at most MIX_SPREAD_RATIO times as
    far from the float32 one as ref is (a float32 step would sit ~1e-3 of
    the spread from it)."""
    assert set(got) == set(ref) == set(f32)
    for k in ref:
        spread = max(rel_l2(ref[k], f32[k]), MIX_LEAF_FLOOR)
        assert rel_l2(got[k], ref[k]) <= MIX_LEAF_RATIO * spread, (k, rel_l2(got[k], ref[k]),
                                                                   spread)
    keys = sorted(ref)
    got, ref, f32 = (np.concatenate([d[k].ravel() for k in keys]) for d in (got, ref, f32))
    spread = rel_l2(ref, f32)
    assert rel_l2(got, ref) <= MIX_SPREAD_RATIO * spread, (rel_l2(got, ref), spread)
    assert MIX_BF16_FLOOR * spread <= rel_l2(got, f32) <= MIX_SPREAD_RATIO * spread, (
        rel_l2(got, f32), spread)


def hold_parts(got: dict, ref: dict):
    assert set(got) == set(ref) - {"step_time"}
    for k in got:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, err_msg=k)


def test_wavernn_trainer_step_matches_jax(corpus, jax_trainers):
    """One WaveRNNTrainer step (mu-law, float32) against the JAX trainer's
    jitted `_step_fn` from the same weights on the same batch: the loss and
    every updated parameter."""
    _, jitems, items = corpus
    _, cfg = voc_configs("wavernn")
    jt, _ = jax_trainers("wavernn")
    pt = WaveRNNTrainer(cfg, items, verbose=False, device="cpu")
    before = np_tree(jt.state.params)
    pt.model.load_state_dict(params_from_jax(before, {}, jax_layouts(pt.model)), strict=True)
    mel, audio = pt.dataset.sample_batch(2, np.random.default_rng(3))
    jt.state, ref_loss = jt._step_fn(jt.state, jnp.asarray(mel), jnp.asarray(audio))
    loss = pt.train_step(mel, audio)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-4)
    hold_update(pt.model, _flatten(before), _flatten(np_tree(jt.state.params)), pt.optimizer,
                jt.state.opt_state[1][0])
    assert pt.step == int(jt.state.step) == 1


@pytest.mark.parametrize("mode", ["mulaw", "mol", "gauss"])
def test_wavernn_mixed_step_matches_jax(corpus, jax_trainers, mode):
    """One mixed-precision WaveRNNTrainer step against the JAX trainer's
    mixed `_step_fn` (bf16 casts of the parameters, the mels and the input
    samples; the GRU states, and so the recurrences and the layers after
    them, float32 on both sides) from the same weights on the same batch:
    the loss at MIX_LOSS_TOL and the step's gradient, read from Adam's
    first moment, by `hold_mixed`, the float32 gradient the port's float32
    step's from the same weights (held to the JAX package's float32
    gradient at 1e-4 by the tests above). The port's mixed gradient sits
    nearer the float32 one than the reference's: its whole-sequence GRU
    sums each weight's gradient over the sequence in float32."""
    _, _, items = corpus
    jt, _ = jax_trainers("wavernn", True, mode)
    state = params_from_jax(np_tree(jt.state.params), {},
                            jax_layouts(WaveRNN(**WAVERNN, mode=mode, device="cpu")))
    mel, audio = GANDataset(items, AudioProcessor(AudioConfig(**AUDIO)), 512,
                            pad=2).sample_batch(2, np.random.default_rng(3))
    ref_state, ref_loss = jt._step_fn(jt.state, jnp.asarray(mel), jnp.asarray(audio))
    got = {}
    for mixed in (True, False):
        _, cfg = voc_configs("wavernn", **mixed_kw("wavernn", mixed, mode))
        pt = WaveRNNTrainer(cfg, items, verbose=False, device="cpu")
        pt.model.load_state_dict(state, strict=True)
        got[mixed] = pt.train_step(mel, audio), adam_mu(pt.model, pt.optimizer)
    np.testing.assert_allclose(got[True][0], float(ref_loss), rtol=MIX_LOSS_TOL)
    hold_mixed(got[True][1], jax_mu(ref_state.opt_state[1][0]), got[False][1])


class Injected:
    """A JAX PWGAN generator whose noise is fixed (`noise`), whatever key
    its trainer hands it."""

    def __init__(self, gen, noise):
        self.gen, self.noise = gen, noise

    def init(self, key):
        return self.gen.init(key)

    def __call__(self, p, mel, key=None):
        return self.gen(p, mel, noise=self.noise)


def load_jax_state(pt, jt):
    """The JAX trainer's generator and discriminator weights into the
    port's (the Adam states both start at zero)."""
    for mod, tree in ((pt.generator, jt.state.g_params), (pt.discriminator, jt.state.d_params)):
        mod.load_state_dict(params_from_jax(np_tree(tree), {}, jax_layouts(mod)), strict=True)


def jax_gan_step(jt, mel, audio, use_disc: bool, noise=None, steps=None):
    """The JAX trainer's jitted generator step (and discriminator step), PWGAN's
    noise injected (one draw a side); `steps` keeps the compiled steps by
    use_disc (not with injected noise, which is traced in). Returns (parts,
    weights before each side's step, after them, the generator after its
    step)."""
    key = jax.random.PRNGKey(9)
    before = {s: _flatten(np_tree(getattr(jt.state, f"{s}_params"))) for s in "gd"}
    m, a = jnp.asarray(mel), jnp.asarray(audio)
    gen = jt.generator
    if noise is not None:
        jt.generator = Injected(gen, jnp.asarray(noise[0]))
        g_step, d_step = jt._build_steps(use_disc)
    else:
        steps = {} if steps is None else steps
        if use_disc not in steps:
            steps[use_disc] = jt._build_steps(use_disc)
        g_step, d_step = steps[use_disc]
    jt.state, ref = g_step(jt.state, m, a, key)
    g_after = np_tree(jt.state.g_params)
    if use_disc:
        if noise is not None:
            jt.generator = Injected(gen, jnp.asarray(noise[1]))
        jt.state, d_parts = d_step(jt.state, m, a, key)
        ref = {**ref, **d_parts}
    jt.generator = gen
    after = {s: _flatten(np_tree(getattr(jt.state, f"{s}_params"))) for s in "gd"}
    return {k: float(v) for k, v in ref.items()}, before, after, g_after


def port_gan_step(pt, mel, audio, g_after, noise=None):
    """The port's `train_step`, its discriminator step regenerating its
    fake from `g_after` (the JAX step's updated generator, loaded into the
    port's as that step starts) so that it is held on the same input; the
    port's own updated generator is read just before. Returns (parts, the
    port's updated generator in the JAX layout)."""
    seen = {}
    d_loss = pt.d_loss

    def from_the_same_generator(*args, **kwargs):
        seen["g"] = {k: v.copy() for k, v in params_to_jax(pt.generator)[0].items()}
        pt.generator.load_state_dict(params_from_jax(g_after, {}, jax_layouts(pt.generator)),
                                     strict=True)
        return d_loss(*args, **kwargs)

    pt.d_loss = from_the_same_generator
    got = pt.train_step(mel, audio, noise=tuple(t(x) for x in noise) if noise else (None, None))
    del pt.d_loss
    return got, seen.get("g", params_to_jax(pt.generator)[0])


def gan_port_trainer(model: str, corpus, start_disc: int, jt, mixed: bool = False):
    """The port's GANTrainer of voc_configs' `model` with the JAX trainer's
    weights."""
    _, cfg = voc_configs(model, steps_to_start_discriminator=start_disc,
                         **mixed_kw(model, mixed, None))
    pt = GANTrainer(cfg, corpus[2], verbose=False, device="cpu")
    load_jax_state(pt, jt)
    return pt


@pytest.mark.parametrize("model, use_disc", [("melgan", False), ("melgan", True),
                                             ("pwgan", True)],
                         ids=["melgan-g", "melgan-gd", "pwgan-gd"])
def test_gan_trainer_step_matches_jax(corpus, jax_trainers, model, use_disc):
    """One GANTrainer step against the JAX trainer's jitted `_build_steps`
    on one batch of 2 x 512 samples: the generator alone (before
    steps_to_start_discriminator; the discriminator does not move) or the
    generator step then the discriminator step (which regenerates with the
    updated generator); PWGAN with its noise injected on both sides, one
    draw each. Every loss part and every updated parameter of both
    networks (the discriminator step held on the JAX step's updated
    generator, see `port_gan_step`)."""
    jt, steps = jax_trainers(model)
    pt = gan_port_trainer(model, corpus, 0 if use_disc else 10, jt)
    mel, audio = pt.dataset.sample_batch(2, np.random.default_rng(4))
    noise = None
    if model == "pwgan":
        r = np.random.default_rng(7)
        noise = [r.standard_normal(audio.shape).astype(np.float32) for _ in range(2)]
    ref, before, after, g_after = jax_gan_step(jt, mel, audio, use_disc, noise, steps)
    got, got_g = port_gan_step(pt, mel, audio, g_after, noise)
    assert ("disc_loss" in got) == use_disc
    hold_parts(got, ref)
    hold_update(pt.generator, before["g"], after["g"], pt.g_opt, jt.state.g_opt[1][0], got_g)
    if use_disc:
        hold_update(pt.discriminator, before["d"], after["d"], pt.d_opt, jt.state.d_opt[1][0])
    else:
        got_d = params_to_jax(pt.discriminator)[0]
        assert all(np.array_equal(got_d[k], v) for k, v in before["d"].items())
        assert pt.d_opt.count == 0 and all(not m.any() for m in pt.d_opt.mu)
    assert pt.step == int(jt.state.step) == 1


def test_gan_mixed_step_matches_jax(corpus, jax_trainers):
    """One gan_mixed_precision MelGAN step (generator, then discriminator)
    against the JAX trainer's mixed `_build_steps` (bf16 casts of both
    networks' parameters, of the mels and of the discriminators' inputs;
    the losses and the discriminator outputs float32) from the same
    weights on the same batch: every loss part at MIX_LOSS_TOL, and each
    side's gradient, read from its Adam first moment, by `hold_mixed`
    against the port's float32 step from the same weights (its
    discriminator step, like the mixed ones, on the JAX mixed step's
    updated generator). It caught the CPU's bf16 transposed convolution's
    input gradient (nn/core.py ConvTranspose1d)."""
    jt, _ = jax_trainers("melgan", True)
    pts = {mixed: gan_port_trainer("melgan", corpus, 0, jt, mixed) for mixed in (True, False)}
    mel, audio = pts[True].dataset.sample_batch(2, np.random.default_rng(4))
    ref, _, _, g_after = jax_gan_step(jt, mel, audio, True)
    got = {mixed: port_gan_step(pt, mel, audio, g_after)[0] for mixed, pt in pts.items()}
    assert set(got[True]) == set(ref) - {"step_time"}
    for k, v in got[True].items():
        np.testing.assert_allclose(v, ref[k], rtol=MIX_LOSS_TOL, err_msg=k)
    for side, net, opt in (("g", "generator", "g_opt"), ("d", "discriminator", "d_opt")):
        mus = {m: adam_mu(getattr(pt, net), getattr(pt, opt)) for m, pt in pts.items()}
        hold_mixed(mus[True], jax_mu(getattr(jt.state, f"{side}_opt")[1][0]), mus[False])


def test_trained_melgan_asset_resumes_in_both_trainers(corpus):
    """assets/bench_trained_melgan.npz (the JAX GANTrainer's save of
    configs/melgan_smoke.json at step 4,000) restores strictly into the
    port's trainer: generator, discriminator and both Adam states equal the
    file. Then one G + D step of each trainer from it on the same batch:
    the generator step's loss parts 1e-4; its gradient, through the STFT
    loss of a trained generator, is ill-conditioned in float32 (the L1 of
    log-magnitudes near spectral nulls), so the STFT loss's gradient is
    held against the port's float64 one, the port's float32 gradient no
    farther from it than the JAX one is (by 1.25), the JAX one within 0.07
    rel L2 of it (reads 0.033; the port's float32 one 0.016), and the
    step's whole gradient, read from Adam's first moment, within 0.08 rel
    L2 of the JAX one (reads 0.041); each gate is twice its reading. The
    discriminator step from the same updated generator on both
    sides (the JAX one's loaded into the port's): its loss 1e-4 and its
    update by `hold_update`."""
    _, jitems, items = corpus
    jcfg, cfg = (mod.load_vocoder_config(MELGAN_SMOKE) for mod in (jvc, vc))
    jcfg, cfg = (dataclasses.replace(c, training=dataclasses.replace(c.training, seq_len=512))
                 for c in (jcfg, cfg))
    jt = JaxGANTrainer(jcfg, jitems, verbose=False)
    pt = GANTrainer(cfg, items, verbose=False, device="cpu")
    jt.restore(ASSET)
    meta = pt.restore(ASSET)
    assert meta["vocoder_model"] == "melgan" and pt.step == int(jt.state.step) == 4000
    # the discriminator steps from step 2 on (steps_to_start_discriminator)
    assert pt.g_opt.count == 4000 and pt.d_opt.count == 3998
    blobs = dict(np.load(ASSET))
    for sub, model, adam in (("g", pt.generator, pt.g_opt), ("d", pt.discriminator, pt.d_opt)):
        for sec, tensors in (("params", None), ("opt_state", "mu"), ("opt_state", "nu")):
            if tensors is None:
                tree = params_to_jax(model)[0]
                pre = f"params::['{sub}']"
            else:
                with _swapped(model, getattr(adam, tensors)):
                    tree = {k: v.copy() for k, v in params_to_jax(model)[0].items()}
                pre = f"opt_state::['{sub}'][1][0].{tensors}"
            for k, v in tree.items():
                np.testing.assert_array_equal(v, blobs[pre + k], err_msg=pre + k)
    mel, audio = pt.dataset.sample_batch(2, np.random.default_rng(8))
    m, a, key = jnp.asarray(mel), jnp.asarray(audio), jax.random.PRNGKey(9)
    g_step, d_step = jt._build_steps(True)
    mu0 = _flatten(np_tree(jt.state.g_opt[1][0].mu))
    jt.state, ref = g_step(jt.state, m, a, key)
    loss, parts = pt.g_loss(t(mel), t(audio), True)
    hold_parts({k: v.item() for k, v in parts.items()}, {k: float(v) for k, v in ref.items()})
    pt.g_opt.step(torch.autograd.grad(loss, pt.g_params))
    with _swapped(pt.generator, pt.g_opt.mu):
        mu1 = {k: v.copy() for k, v in params_to_jax(pt.generator)[0].items()}
    keys = sorted(mu0)
    implied = lambda mu: np.concatenate([(mu[k] - 0.5 * mu0[k]).ravel() for k in keys])  # noqa
    assert rel_l2(implied(mu1), implied(_flatten(np_tree(jt.state.g_opt[1][0].mu)))) <= 0.08
    # the STFT loss's gradient at the restored generator, float32 and float64
    gen = copy.deepcopy(pt.generator)
    gen.load_state_dict(params_from_jax(_np_sub(blobs, "params::['g']"), {}, jax_layouts(gen)),
                        strict=True)
    got = {}
    for dt in (torch.float32, torch.float64):
        gm = copy.deepcopy(gen).to(dt)
        sl = losses.multi_scale_stft_loss(gm(t(mel).to(dt)), t(audio).to(dt))
        gr = torch.autograd.grad(sl, list(gm.parameters()))
        got[dt] = np.concatenate([g.double().numpy().ravel() for g in gr])
    jg = jax.jit(jax.grad(lambda gp: jlosses.multi_scale_stft_loss(jt.generator(gp, m), a)))(
        _np_sub(blobs, "params::['g']"))
    sd = params_from_jax(np_tree(jg), {}, jax_layouts(gen))
    jflat = np.concatenate([sd[n].double().numpy().ravel() for n, _ in gen.named_parameters()])
    assert rel_l2(got[torch.float32], got[torch.float64]) <= 1.25 * rel_l2(jflat,
                                                                           got[torch.float64])
    assert rel_l2(jflat, got[torch.float64]) <= 0.07
    # the discriminator step from the JAX step's generator on both sides
    pt.generator.load_state_dict(params_from_jax(np_tree(jt.state.g_params), {},
                                                 jax_layouts(pt.generator)), strict=True)
    before = _flatten(np_tree(jt.state.d_params))
    jt.state, ref = d_step(jt.state, m, a, key)
    loss, parts = pt.d_loss(t(mel), t(audio))
    np.testing.assert_allclose(loss.item(), float(ref["disc_loss"]), rtol=1e-4)
    pt.d_opt.step(torch.autograd.grad(loss, pt.d_params))
    hold_update(pt.discriminator, before, _flatten(np_tree(jt.state.d_params)), pt.d_opt,
                jt.state.d_opt[1][0])


def _np_sub(blobs: dict, prefix: str) -> dict:
    """The nested tree of a checkpoint's entries under `prefix`."""
    from your_voice_tts_torch.train.checkpoint import _insert, parse_keypath

    tree: dict = {}
    for k, v in blobs.items():
        if k.startswith(prefix):
            _insert(tree, parse_keypath(k[len(prefix):]), v)
    return tree


def test_port_checkpoints_restore_strictly_in_jax(corpus, jax_trainers, tmp_path):
    """A MelGAN and a WaveRNN checkpoint the port's trainers save after a
    step restore strictly into the JAX trainers (parameters and Adam
    state equal), and the MelGAN one serves through both packages'
    VocoderSynthesizer alike (1e-5)."""
    from your_voice_tts_tpu.vocoder.synthesizer import VocoderSynthesizer as JaxVocSynth
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    _, _, items = corpus
    for model, pcls in (("melgan", GANTrainer), ("wavernn", WaveRNNTrainer)):
        _, cfg = voc_configs(model, steps_to_start_discriminator=0)
        pt = pcls(cfg, items, verbose=False, device="cpu")
        mel, audio = pt.dataset.sample_batch(2, np.random.default_rng(2))
        pt.train_step(mel, audio)
        path = pt.save(str(tmp_path / f"{model}.npz"))
        jt, _ = jax_trainers(model)
        jt.restore(path)
        assert int(jt.state.step) == 1
        blobs = dict(np.load(path))
        st = jt.state
        trees = ({"params": {"g": st.g_params, "d": st.d_params},
                  "opt_state": {"g": st.g_opt, "d": st.d_opt}} if model == "melgan"
                 else {"params": st.params, "opt_state": st.opt_state})
        ref = {f"{sec}::{k}": v for sec, tree in trees.items()
               for k, v in _flatten(np_tree(tree)).items()}
        assert set(ref) == set(blobs) - {"__meta__"}
        for k, v in ref.items():
            np.testing.assert_array_equal(blobs[k], v, err_msg=k)
        if model == "melgan":
            mel1 = np.random.default_rng(3).normal(size=(20, 30)).astype(np.float32)
            got = VocoderSynthesizer(cfg, path, device="cpu").mel_to_wav(mel1)
            want = JaxVocSynth(jt.cfg, path).mel_to_wav(mel1)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------------------- the CLI


def write_voc_config(tmp_path, model: str) -> str:
    raw = {"model": model, "audio": AUDIO,
           model: {k: list(v) if isinstance(v, tuple) else v for k, v in GROUPS[model].items()},
           "training": {"batch_size": 2, "seq_len": 512, "steps_to_start_discriminator": 1,
                        "print_step": 1, "save_step": 1000}}
    path = tmp_path / f"{model}.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_routes_pwgan_to_the_gan_trainer(tmp_path, monkeypatch):
    """The port's routing beside the JAX CLI's: "pwgan" trains on
    GANTrainer here, while the JAX bin/train_vocoder.py hands every model
    but "melgan" to its WaveRNNTrainer (a recorded departure); an unknown
    model raises."""
    from your_voice_tts_torch.bin.train_vocoder import trainer_class
    from your_voice_tts_tpu.bin import train_vocoder as jax_cli
    from your_voice_tts_tpu.vocoder import train_wavernn as jax_twr

    taken = []

    class Stop(Exception):
        pass

    class Recorder:
        def __init__(self, cfg, *a, **k):
            taken.append(type(self).__name__)
            raise Stop

    monkeypatch.setattr(jax_twr, "WaveRNNTrainer", type("WaveRNNTrainer", (Recorder,), {}))
    path = make_synthetic_corpus(str(tmp_path / "c"), n_items=2, sr=8000)
    with pytest.raises(Stop):
        jax_cli.main(["--config_path", write_voc_config(tmp_path, "pwgan"), "--data_path",
                      path, "--output_path", str(tmp_path / "jax_runs")])
    assert taken == ["WaveRNNTrainer"]
    assert trainer_class("pwgan") is GANTrainer and trainer_class("melgan") is GANTrainer
    assert trainer_class("wavernn") is WaveRNNTrainer
    with pytest.raises(ValueError, match="unknown vocoder model"):
        trainer_class("hifigan")


@pytest.mark.parametrize("model", ["melgan", "pwgan", "wavernn"])
def test_cli_trains_and_the_checkpoint_serves(corpus, tmp_path, capsys, model):
    """`bin/train_vocoder.py --max_steps 2 --device cpu`: two steps printed
    (the GAN ones past the discriminator's start at step 1), a
    `vocoder-<model>` run folder whose final.npz the port's
    VocoderSynthesizer serves."""
    from your_voice_tts_torch.bin import train_vocoder
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    cfg_path = write_voc_config(tmp_path, model)
    train_vocoder.main(["--config_path", cfg_path, "--data_path", corpus[0], "--max_steps",
                        "2", "--device", "cpu", "--output_path", str(tmp_path / "runs")])
    printed = capsys.readouterr().out
    assert "STEP 2" in printed and ("disc_loss" in printed) == (model != "wavernn")
    (run,) = os.listdir(tmp_path / "runs")
    assert run.startswith(f"vocoder-{model}-")
    synth = VocoderSynthesizer(cfg_path, str(tmp_path / "runs" / run / "final.npz"),
                               device="cpu")
    wav = synth.mel_to_wav(np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32))
    assert wav.shape == (6 * 64,) and np.isfinite(wav).all()
