"""WaveRNN trainer (the JAX package's vocoder/train_wavernn.py): the
teacher-forced negative log-likelihood by I/O mode (mu-law cross-entropy,
mixture of logistics, Gaussian; `WaveRNN.loss`) on random segments of a
corpus, on one device or data-parallel.

The update is optax's chain(clip_by_global_norm(grad_clip), adam(lr_gen)),
train/optim.py `ClipAdam`. mixed_precision runs the forward on bf16 casts
of the float32 master parameters and of the mels (the casts are
differentiable, so the gradients come back float32); as in the reference,
whose scan starts its GRU states in float32, the recurrences and the layers
after them run in float32 on the bf16 weights (`WaveRNN.forward`), and the
NLL is float32. Checkpoints are the JAX trainer's
(`wavernn_checkpoint_{step}.npz`, `extra.vocoder_model = "wavernn"`, the
Adam state at the chain's place), restored strictly by either package.

Under an initialized process group (bin/distribute.py; parallel/mesh.py)
each step is the reference's on the global batch, as in train_gan.py: the
global batch rounds training.batch_size up to a multiple of the world
size, each rank samples its share from np.random.default_rng(1 + rank),
the NLL is this rank's share of the global mean (`global_batch()`), the
gradients are summed over the ranks, rank 0's weights are broadcast at the
start and after `restore`, and rank 0 alone writes checkpoints.
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
from .models.wavernn import WaveRNN


def bf16_params(module: torch.nn.Module) -> dict:
    """bf16 casts of the module's float32 parameters, by name, for
    torch.func.functional_call: the JAX trainers' `cast_f32_to_bf16`
    (differentiable, so the gradients reach the float32 parameters)."""
    return {n: p.to(torch.bfloat16) for n, p in module.named_parameters()
            if p.dtype == torch.float32}


class WaveRNNTrainer:
    def __init__(self, cfg: VocoderConfig, items: list, output_path: str | None = None,
                 verbose: bool = True, device=None):
        """Trains a WaveRNN of cfg.wavernn on `items` ((text, wav path,
        speaker) rows) on `device`, CUDA unless given. The global batch is
        training.batch_size rounded up to a multiple of the world size."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ap = AudioProcessor(cfg.audio, self.device)
        w = cfg.wavernn
        prod = math.prod(w.upsample_factors)
        if prod != self.ap.hop_length:
            raise ValueError(f"wavernn upsample product {prod} != hop {self.ap.hop_length}")
        self.model = WaveRNN(cfg.audio.num_mels, w.bits, w.rnn_dims, w.fc_dims, w.compute_dims,
                             w.res_out_dims, w.num_res_blocks, w.pad, w.upsample_factors,
                             w.mode, num_mixtures=w.num_mixtures, device=self.device)
        self.dataset = GANDataset(items, self.ap, cfg.training.seq_len, pad=w.pad)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = ClipAdam(self.params, cfg.training.lr_gen, cfg.training.grad_clip)
        self.world, self.rank = mesh.world_size(), mesh.rank()
        self.global_batch = -(-cfg.training.batch_size // self.world) * self.world
        mesh.broadcast_module(self.model)
        self.output_path = output_path
        self.verbose = verbose

    @property
    def step(self) -> int:
        """Updates applied (the Adam state's count)."""
        return self.optimizer.count

    def loss(self, mel, audio):
        """The training loss of one batch of tensors, in training mode (on
        bf16 casts under mixed_precision)."""
        self.model.train()
        if self.cfg.training.mixed_precision:
            return self.model.loss(mel.to(torch.bfloat16), audio, torch.bfloat16,
                                   params=bf16_params(self.model))
        return self.model.loss(mel, audio)

    def train_step(self, mel, audio) -> float:
        """One update on a batch (mel [B, F + 2 pad, n_mels], audio [B,
        seq_len], numpy or tensors); returns the loss before it."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        with mesh.global_batch():
            loss = self.loss(mel, audio)
            grads = torch.autograd.grad(loss, self.params)
        self.optimizer.step(mesh.sum_grads(list(grads)))
        return mesh.sum_metrics({"loss": loss})["loss"].item()

    def fit(self, max_steps: int) -> dict:
        """max_steps updates on batches drawn from np.random.default_rng(1 +
        rank), the reference's draws; the loss printed every print_step steps
        and a checkpoint every save_step with an output path (rank 0).
        Returns the last step's loss and seconds."""
        cfg = self.cfg.training
        rng = np.random.default_rng(1 + self.rank)
        last: dict = {}
        for _ in range(max_steps):
            mel, audio = self.dataset.sample_batch(self.global_batch // self.world, rng)
            t0 = time.time()
            loss = self.train_step(mel, audio)
            last = {"loss": loss, "step_time": time.time() - t0}
            step = self.step
            if self.verbose and step % cfg.print_step == 0:
                print(f"   --> WAVERNN STEP {step} | loss: {loss:.4f} "
                      f"| step_time: {last['step_time']:.3f}", flush=True)
            if self.output_path and step % cfg.save_step == 0 and self.rank == 0:
                self.save(os.path.join(self.output_path, f"wavernn_checkpoint_{step}.npz"))
        return last

    def save(self, path: str) -> str:
        return save_trainer_checkpoint(path, {None: (self.model, self.optimizer)},
                                       step=self.step, extra={"vocoder_model": "wavernn"})

    def restore(self, path: str) -> dict:
        meta = restore_trainer_checkpoint(path, {None: (self.model, self.optimizer)})
        mesh.broadcast_module(self.model)
        return meta
