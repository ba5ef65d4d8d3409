"""GAN vocoder trainer (the JAX package's vocoder/train_gan.py): MelGAN
against its multi-scale discriminator, or Parallel WaveGAN against its
one-scale discriminator, on one device or data-parallel.

The generator trains alone on the multi-resolution STFT loss until
training.steps_to_start_discriminator, then each step is a generator step
(STFT loss, LSGAN loss, feature matching) followed by a discriminator step
(LSGAN). Each side's update is optax's chain(clip_by_global_norm(grad_clip),
adam(lr, b1=0.5, b2=0.9)), train/optim.py `ClipAdam`. gan_mixed_precision
runs both networks' convolutions on bf16 casts of the float32 master
parameters; the losses and the discriminator outputs are float32.

Where a PyTorch habit would give another update than the reference's:
- the discriminator step runs the generator again, with the parameters
  the generator step has just updated and with noise of its own; it does
  not reuse the generator step's output;
- the generator step takes gradients for the generator's parameters only:
  nothing reaches the discriminator's, whose Adam state does not move;
- the step counter counts generator steps (checkpoints
  `vocoder_checkpoint_{step + 1}.npz`, metrics at (step + 1) % print_step).

`fit` draws rng.integers(2**31) after each batch, as the reference does,
so both packages read the same segments; that draw seeds PWGAN's noise, a
torch.Generator on the device drawn once for the generator step and once
for the discriminator step (the reference splits a threefry key, which
torch cannot reproduce). Checkpoints are the JAX trainer's (params and
opt_state under 'g' and 'd', extra.vocoder_model), restored strictly by
either package.

Under an initialized process group (bin/distribute.py; parallel/mesh.py)
each step is the reference's on the global batch, the ranks' local
batches in rank order: the global batch rounds training.batch_size up to a
multiple of the world size, each rank samples its share of it from
np.random.default_rng(1 + rank), both losses run under `global_batch()`
(means over the global batch, the spectral convergence from the global
norms), and each side's gradients are summed over the ranks before its
update. Rank 0's weights are broadcast at the start and after `restore`,
and rank 0 alone writes checkpoints.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..audio import AudioProcessor
from ..parallel import mesh
from ..train.checkpoint import restore_trainer_checkpoint, save_trainer_checkpoint
from ..train.optim import ClipAdam
from .config import VocoderConfig
from .dataset import GANDataset
from .losses import disc_adv_loss, feature_match_loss, gen_adv_loss, multi_scale_stft_loss
from .models.melgan import MelganGenerator, MelganMultiscaleDiscriminator
from .models.pwgan import ParallelWaveganDiscriminator, ParallelWaveganGenerator
from .train_wavernn import bf16_params

BF16 = torch.bfloat16


def _grads(loss, params: list) -> list:
    """d loss / d params, zeros for a parameter the loss does not reach
    (PWGAN's last residual conv, whose output no skip reads), as JAX's
    gradient gives them."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _cast(outs: list, dtype) -> list:
    """[(score, feature maps)] cast to `dtype`."""
    return [(s.to(dtype), [f.to(dtype) for f in fs]) for s, fs in outs]


class GANTrainer:
    def __init__(self, cfg: VocoderConfig, items: list, output_path: str | None = None,
                 verbose: bool = True, device=None):
        """Trains cfg.model ("melgan" or "pwgan") on `items` ((text, wav
        path, speaker) rows) on `device`, CUDA unless given. The global
        batch is training.batch_size rounded up to a multiple of the world
        size."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ap = AudioProcessor(cfg.audio, self.device)
        hop = self.ap.hop_length
        if cfg.model == "pwgan":
            p = cfg.pwgan
            prod = math.prod(p.upsample_factors)
            if prod != hop:
                raise ValueError(f"pwgan upsample product {prod} != hop {hop}")
            self.generator = ParallelWaveganGenerator(
                cfg.audio.num_mels, p.num_layers, p.stacks, p.residual_channels,
                p.gate_channels, p.skip_channels, p.kernel_size, p.upsample_factors,
                aux_context_window=p.aux_context_window, device=self.device)
            self.discriminator = ParallelWaveganDiscriminator(p.disc_layers, p.disc_channels,
                                                              device=self.device)
        elif cfg.model == "melgan":
            m = cfg.melgan
            prod = math.prod(m.upsample_factors)
            if prod != hop:
                raise ValueError(f"melgan upsample_factors product {prod} != hop_length {hop}")
            self.generator = MelganGenerator(cfg.audio.num_mels, m.upsample_factors,
                                             m.base_channels, m.num_res_blocks, m.kernel_size,
                                             device=self.device)
            self.discriminator = MelganMultiscaleDiscriminator(
                m.num_scales, m.disc_base_channels, device=self.device)
        else:
            raise ValueError(f"GANTrainer trains melgan or pwgan, not {cfg.model!r}")
        self.dataset = GANDataset(items, self.ap, cfg.training.seq_len)
        t = cfg.training
        self.g_params = [p for p in self.generator.parameters() if p.requires_grad]
        self.d_params = [p for p in self.discriminator.parameters() if p.requires_grad]
        self.g_opt = ClipAdam(self.g_params, t.lr_gen, t.grad_clip, b1=0.5, b2=0.9)
        self.d_opt = ClipAdam(self.d_params, t.lr_disc, t.grad_clip, b1=0.5, b2=0.9)
        self.world, self.rank = mesh.world_size(), mesh.rank()
        self.global_batch = -(-t.batch_size // self.world) * self.world
        mesh.broadcast_module(self.generator)
        mesh.broadcast_module(self.discriminator)
        # the inputs', the losses' and the discriminator outputs' dtype:
        # float32 as the reference's; a reference run on float64 copies of
        # the networks sets float64
        self.dtype = torch.float32
        self.step = 0
        self.output_path = output_path
        self.verbose = verbose

    # --- the networks ------------------------------------------------------

    def _generate(self, mel, noise, generator):
        """The generator on mel (bf16 casts under gan_mixed_precision);
        PWGAN takes `noise` [B, T * hop], or draws it from `generator`."""
        kw = {}
        if self.cfg.model == "pwgan":
            kw = {"noise": noise, "generator": generator}
        if self.cfg.training.gan_mixed_precision:
            return torch.func.functional_call(self.generator, bf16_params(self.generator),
                                              (mel.to(BF16),), kw)
        return self.generator(mel, **kw)

    def _discriminate(self, x) -> list:
        """[(score, feature maps)] a scale, in `dtype` (the convolutions on bf16
        casts under gan_mixed_precision); PWGAN's one scale as a list of
        one."""
        d = self.discriminator
        if self.cfg.training.gan_mixed_precision:
            out = torch.func.functional_call(d, bf16_params(d), (x.to(BF16),))
        else:
            out = d(x)
        return _cast([out] if self.cfg.model == "pwgan" else out, self.dtype)

    # --- the steps ---------------------------------------------------------

    def g_loss(self, mel, audio, use_disc: bool, noise=None, generator=None):
        """(generator loss, its parts): the STFT loss (weighted), and with
        the discriminator the LSGAN loss and feature matching (weighted)
        against the real audio's feature maps."""
        t = self.cfg.training
        fake = self._generate(mel, noise, generator).to(self.dtype)
        loss, parts = 0.0, {}
        if t.use_stft_loss:
            sl = multi_scale_stft_loss(fake, audio)
            loss = loss + t.stft_loss_weight * sl
            parts["stft_loss"] = sl
        if use_disc:
            fake_out = self._discriminate(fake)
            with torch.no_grad():
                real_out = self._discriminate(audio)
            adv = gen_adv_loss([s for s, _ in fake_out])
            loss = loss + adv
            parts["gen_adv_loss"] = adv
            if t.use_feat_match_loss:
                fm = feature_match_loss([f for _, f in fake_out], [f for _, f in real_out])
                loss = loss + t.feat_match_loss_weight * fm
                parts["feat_match_loss"] = fm
        parts["gen_loss"] = loss
        return loss, parts

    def d_loss(self, mel, audio, noise=None, generator=None):
        """(discriminator loss, its parts): LSGAN on the real audio and a
        fake the generator makes now, its gradient stopped."""
        with torch.no_grad():
            fake = self._generate(mel, noise, generator)
        fake_out = self._discriminate(fake)
        real_out = self._discriminate(audio)
        loss = disc_adv_loss([s for s, _ in real_out], [s for s, _ in fake_out])
        return loss, {"disc_loss": loss}

    def train_step(self, mel, audio, seed: int = 0, noise=(None, None)) -> dict:
        """One step on a batch (mel [B, F, n_mels], audio [B, seq_len], numpy
        or tensors): the generator's update, then from
        steps_to_start_discriminator on the discriminator's. PWGAN's noise
        for the two is drawn from a generator seeded by `seed`, one draw
        each, unless given as noise = (generator step's, discriminator
        step's). Returns the float metrics."""
        self.generator.train()
        self.discriminator.train()
        mel = torch.as_tensor(mel, dtype=self.dtype, device=self.device)
        audio = torch.as_tensor(audio, dtype=self.dtype, device=self.device)
        gen = (torch.Generator(device=self.device).manual_seed(seed)
               if self.cfg.model == "pwgan" else None)
        use_disc = self.step >= self.cfg.training.steps_to_start_discriminator
        with mesh.global_batch():
            loss, parts = self.g_loss(mel, audio, use_disc, noise[0], gen)
            grads = _grads(loss, self.g_params)
        self.g_opt.step(mesh.sum_grads(grads))
        if use_disc:
            with mesh.global_batch():
                loss, d_parts = self.d_loss(mel, audio, noise[1], gen)
                grads = _grads(loss, self.d_params)
            self.d_opt.step(mesh.sum_grads(grads))
            parts.update(d_parts)
        self.step += 1
        parts = mesh.sum_metrics(parts)
        keys = list(parts)
        return dict(zip(keys, torch.stack([parts[k].detach().double() for k in keys]).tolist()))

    def fit(self, max_steps: int) -> dict:
        """max_steps steps on batches drawn from np.random.default_rng(1 +
        rank), this rank's share of the global batch, each followed by the
        reference's rng.integers(2**31) draw (PWGAN's noise seed); metrics
        printed at (step + 1) % print_step and a checkpoint every
        save_step with an output path (rank 0). Returns the last step's
        metrics and seconds."""
        t = self.cfg.training
        rng = np.random.default_rng(1 + self.rank)
        last: dict = {}
        for _ in range(max_steps):
            step = self.step
            mel, audio = self.dataset.sample_batch(self.global_batch // self.world, rng)
            seed = int(rng.integers(2 ** 31))
            t0 = time.time()
            last = self.train_step(mel, audio, seed)
            last["step_time"] = time.time() - t0
            if self.verbose and (step + 1) % t.print_step == 0:
                msg = " | ".join(f"{k}: {v:.4f}" for k, v in last.items())
                print(f"   --> GAN STEP {step + 1} | {msg}", flush=True)
            if self.output_path and (step + 1) % t.save_step == 0 and self.rank == 0:
                self.save(os.path.join(self.output_path, f"vocoder_checkpoint_{step + 1}.npz"))
        return last

    # --- persistence -------------------------------------------------------

    def _parts(self) -> dict:
        return {"g": (self.generator, self.g_opt), "d": (self.discriminator, self.d_opt)}

    def save(self, path: str) -> str:
        return save_trainer_checkpoint(path, self._parts(), step=self.step,
                                       extra={"vocoder_model": self.cfg.model})

    def restore(self, path: str) -> dict:
        meta = restore_trainer_checkpoint(path, self._parts())
        mesh.broadcast_module(self.generator)
        mesh.broadcast_module(self.discriminator)
        self.step = int(meta["step"])
        return meta
