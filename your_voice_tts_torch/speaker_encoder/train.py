"""Speaker-encoder trainer (the JAX package's speaker_encoder/train.py):
GE2E over random N x M batches, one device.

The update is optax's chain(clip_by_global_norm(grad_clip), adam(lr)),
train/optim.py `ClipAdam` (b1 0.9, b2 0.999, eps 1e-8), over the
encoder's parameters and the loss's (w, b) together.

Checkpoints are the JAX package's .npz: the encoder under ``params``, the
loss's (w, b) as model state ``['ge2e']``, and the Adam state under
``opt_state`` in optax's own key paths (``[1][0].count``,
``[1][0].mu['model'][...]``, ``[1][0].mu['loss'][...]``, and ``nu``), so
the JAX package's trainer and both packages' `load_encoder` read it.
"""

from __future__ import annotations

import datetime
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..train.checkpoint import (_insert, jax_layouts, params_from_jax, parse_keypath,
                                read_checkpoint)
from ..train.optim import ClipAdam
from .losses import ge2e_loss, init_ge2e_params
from .model import params_to_jax

F32 = np.float32
_OPT = "[1][0]"          # the Adam state's place in optax.chain(clip, adam)'s state


class SpeakerEncoderTrainer:
    def __init__(self, model, dataset, lr: float = 1e-4, grad_clip: float = 3.0,
                 num_speakers_per_batch: int = 4, num_utters_per_speaker: int = 4,
                 output_path: str | None = None, verbose: bool = True, device=None):
        """Trains `model` (a SpeakerEncoder, from its current weights) on
        `dataset` (a SpeakerEncoderDataset), on `device`: CUDA unless
        given."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dataset = dataset
        self.N, self.M = num_speakers_per_batch, num_utters_per_speaker
        self.loss_params = init_ge2e_params(self.device)
        self.names = [n for n, p in model.named_parameters() if p.requires_grad]
        for p in self.loss_params.values():
            p.requires_grad_(True)
        self.params = [dict(model.named_parameters())[n] for n in self.names] + \
            [self.loss_params["w"], self.loss_params["b"]]
        self.adam = ClipAdam(self.params, lr, grad_clip)
        self.mu, self.nu = self.adam.mu, self.adam.nu
        self.output_path = output_path
        self.verbose = verbose

    def loss(self, mels):
        """mels [N, M, T, n_mels] -> the GE2E loss of their embeddings."""
        N, M = mels.shape[:2]
        emb = self.model(mels.reshape((N * M,) + mels.shape[2:])).reshape(N, M, -1)
        return ge2e_loss(emb, self.loss_params["w"], self.loss_params["b"])

    def train_step(self, mels) -> float:
        """One update on a [N, M, T, n_mels] batch (numpy or tensor);
        returns the loss before it."""
        self.model.train()
        mels = torch.as_tensor(mels, dtype=torch.float32, device=self.device)
        loss = self.loss(mels)
        self.adam.step(torch.autograd.grad(loss, self.params))
        return loss.item()

    @property
    def step(self) -> int:
        """Updates applied (the Adam state's count)."""
        return self.adam.count

    def fit(self, max_steps: int, print_step: int = 50) -> dict:
        """max_steps updates on batches drawn from np.random.default_rng(0),
        the reference's draws; a checkpoint every 1,000 steps when given an
        output path. Returns the last step's loss and seconds."""
        rng = np.random.default_rng(0)
        last: dict = {}
        for _ in range(max_steps):
            mels = self.dataset.sample_batch(self.N, self.M, rng)
            t0 = time.time()
            loss = self.train_step(mels)
            last = {"loss": loss, "step_time": time.time() - t0}
            if self.verbose and self.step % print_step == 0:
                print(f"   --> GE2E STEP {self.step} | loss: {loss:.4f}", flush=True)
            if self.output_path and self.step % 1000 == 0:
                self.save(os.path.join(self.output_path, f"speaker_encoder_{self.step}.npz"))
        return last

    # --- persistence -------------------------------------------------------

    def _jax_trees(self, tensors: list) -> dict:
        """Tensors ordered as self.params -> {keystr: numpy} under
        ['model'] and ['loss'], the optax tree of {"model", "loss"}."""
        k = len(self.names)
        out = {f"['model']{key}": v
               for key, v in params_to_jax(dict(zip(self.names, tensors[:k]))).items()}
        for name, t in zip(("w", "b"), tensors[k:]):
            out[f"['loss']['{name}']"] = t.detach().float().cpu().numpy()
        return out

    def save(self, path: str) -> str:
        """The JAX package's checkpoint layout (see the module docstring)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        blobs = {f"params::{k}": v for k, v in
                 params_to_jax(dict(self.model.named_parameters())).items()}
        for name, t in self.loss_params.items():
            blobs[f"model_state::['ge2e']['{name}']"] = t.detach().float().cpu().numpy()
        blobs[f"opt_state::{_OPT}.count"] = np.asarray(self.step, np.int32)
        for kind, moments in (("mu", self.mu), ("nu", self.nu)):
            for key, v in self._jax_trees(moments).items():
                blobs[f"opt_state::{_OPT}.{kind}{key}"] = v
        meta = {"step": self.step, "epoch": 0, "r": 1,
                "date": datetime.datetime.now().isoformat(), "model": "speaker_encoder"}
        blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(path, **blobs)
        return path

    @torch.no_grad()
    def restore(self, path: str) -> dict:
        """Parameters, (w, b), Adam's state and the step from a checkpoint
        `save` (or the JAX package's trainer) wrote; strict. Returns meta."""
        params, state, meta = read_checkpoint(path)
        layouts = jax_layouts(self.model)
        self.model.load_state_dict(params_from_jax(params, {}, layouts), strict=True)
        for name, t in self.loss_params.items():
            t.copy_(torch.as_tensor(np.asarray(state["ge2e"][name], F32)))
        with np.load(path, allow_pickle=False) as z:
            opt = {k[len("opt_state::"):]: z[k] for k in z.files if k.startswith("opt_state::")}
        if f"{_OPT}.count" not in opt:
            raise KeyError(f"{path} holds no Adam state at opt_state::{_OPT}")
        for kind, moments in (("mu", self.mu), ("nu", self.nu)):
            prefix = f"{_OPT}.{kind}"
            tree: dict = {}
            for key, v in opt.items():
                if key.startswith(prefix):
                    _insert(tree, parse_keypath(key[len(prefix):]), v)
            sd = params_from_jax(tree["model"], {}, layouts)
            for m, name in zip(moments, self.names + ["w", "b"]):
                m.copy_(sd[name] if name in sd else torch.as_tensor(
                    np.asarray(tree["loss"][name], F32)))
        self.adam.count = int(opt[f"{_OPT}.count"])
        return meta
