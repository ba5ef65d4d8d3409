"""Tacotron2 teacher-forced training (the JAX package's train/trainer.py),
single device.

`Trainer(cfg, device=...).fit(max_steps=N)`: gradual (step, r, batch size)
schedule, the bucketed loader, one train step per batch (loss, backward
through the training kernels, the RAdam stack of train/optim.py), the
evaluation pass with the alignment score, and periodic and best-model
checkpoints in the JAX package's .npz layout.

Mixed precision (training.mixed_precision) follows the JAX package's
`_loss_fn`: the forward runs on bf16 casts of the float32 master
parameters and of the teacher-forcing mels (the casts are differentiable,
so gradients come back float32), BatchNorm statistics and running stats
stay float32, and the losses are float32. Every parameter is cast, the
encoder's BiLSTM's too (cuDNN's LSTM runs in bf16).

Conditioning follows the JAX package's `Trainer`: with
cfg.speakers.use_speaker_embedding one sorted speaker map over the train
and eval items goes to both datasets, and the model conditions on its own
table (spk_dim 0 -> 512-wide rows, E = encoder_dim + 512) or, with
use_external_speaker_embedding_file, on the d-vectors handed to the
constructor (`speaker_embeddings`, name -> vector of
speaker_embedding_dim); a GST model (cfg.speakers.use_gst) takes the
teacher mels as its style. Under mixed precision the d-vectors are cast to
bf16 with the parameters, as the reference casts them.

Later slices bring Tacotron(1) training (with its conditioning), data
parallelism, gradient accumulation, the bidirectional decoder, forward
attention (with its transition agent) and Graves attention, TensorBoard
logging, test-sentence synthesis and the profiler server; they raise
NotImplementedError here.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from .. import resolve_device
from ..audio import AudioProcessor
from ..data import TTSDataset, load_meta_data
from ..models import setup_model
from ..models.losses import TacotronLoss
from ..text import phonemes, symbols
from ..utils.logging import ConsoleLogger
from ..utils.measures import alignment_diagonal_score
from .checkpoint import (jax_layouts, params_from_jax, read_checkpoint,
                         read_optimizer_state, save_best_model, save_checkpoint)
from .optim import build_optimizer

_LATER = "arrives with a later slice of the port"


def gradual_schedule(step: int, schedule, default_r: int, default_bs: int) -> tuple[int, int]:
    """(r, batch_size) at `step` from [[from_step, r, batch_size], ...]."""
    r, bs = default_r, default_bs
    for row_step, row_r, row_bs in schedule or ():
        if step >= row_step:
            r, bs = row_r, row_bs
    return r, bs


class Trainer:
    """End-to-end training loop: Trainer(cfg, device=...).fit()."""

    def __init__(self, cfg, output_path: str | None = None, verbose: bool = True,
                 device=None, speaker_embeddings: dict | None = None):
        if cfg.training.grad_accum_steps > 1:
            raise NotImplementedError(f"gradient accumulation {_LATER}")
        if cfg.model.model == "Tacotron":
            raise NotImplementedError(f"Tacotron(1) training {_LATER}")
        sp = cfg.speakers
        if sp.use_speaker_embedding and sp.use_external_speaker_embedding_file \
                and speaker_embeddings is None:
            raise ValueError("this config conditions on external d-vectors: pass "
                             "Trainer(speaker_embeddings={speaker: vector})")
        # the JAX package trains these through its scan, not the training
        # kernels; windowing acts at inference only and trains as plain
        # location-sensitive attention
        m = cfg.model
        if m.attention_type == "graves":
            raise NotImplementedError(f"training Graves attention {_LATER}")
        for flag in ("use_forward_attn", "transition_agent"):
            if getattr(m, flag):
                raise NotImplementedError(f"training with {flag} {_LATER}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.verbose = verbose
        self.ap = AudioProcessor(cfg.audio, self.device)
        train_items, eval_items = load_meta_data(cfg.data.datasets)
        speakers = None
        if sp.use_speaker_embedding:
            names = sorted({it[2] for it in train_items + eval_items})
            speakers = {n: i for i, n in enumerate(names)}
        self.train_data = TTSDataset(train_items, cfg, self.ap, speakers=speakers,
                                     speaker_embeddings=speaker_embeddings,
                                     cache_dir=cfg.data.phoneme_cache_path)
        self.eval_data = TTSDataset(eval_items, cfg, self.ap, speakers=speakers,
                                    speaker_embeddings=speaker_embeddings) \
            if eval_items else None
        self.num_chars = len(phonemes) if cfg.data.use_phonemes else len(symbols)
        self.num_speakers = len(speakers) if speakers else 0
        spk_dim = sp.speaker_embedding_dim if sp.use_external_speaker_embedding_file else 0
        self.model = setup_model(self.num_chars, cfg, device=self.device,
                                 num_speakers=self.num_speakers, speaker_embedding_dim=spk_dim)
        t = cfg.training
        self.criterion = TacotronLoss(cfg.model.model, t.loss_masking, t.seq_len_norm,
                                      cfg.model.stopnet, t.stopnet_pos_weight, t.ga_alpha,
                                      t.ga_sigma, t.ga_decay_steps, t.decoder_loss_alpha,
                                      t.postnet_loss_alpha)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(self.params, t)
        self.lr_fn = self.optimizer.lr_fn
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(42)
        self.output_path = output_path
        if output_path:
            os.makedirs(output_path, exist_ok=True)
        self.console = ConsoleLogger()
        self.best_loss = float("inf")
        if verbose:
            n = sum(p.numel() for p in self.model.parameters())
            print(f" > Model has {n:,} parameters")
            print(f" > Device: {self.device}")

    # --- steps -------------------------------------------------------------

    def _tensors(self, batch: dict) -> dict:
        """A numpy batch on the device, with what the model conditions on:
        speaker_ids when it has speakers, speaker_embeddings when the
        batch carries d-vectors."""
        dev = self.device
        keys = ["text", "text_lengths", "mel", "mel_lengths", "stop_targets"]
        if self.num_speakers:
            keys.append("speaker_ids")
        if "speaker_embeddings" in batch:
            keys.append("speaker_embeddings")
        out = {k: torch.as_tensor(batch[k]).to(dev) for k in keys}
        out["text"] = out["text"].long()
        if "speaker_ids" in out:
            out["speaker_ids"] = out["speaker_ids"].long()
        return out

    def _forward_kwargs(self, b: dict, r: int) -> dict:
        return {"mel_lengths": b["mel_lengths"], "r": r,
                "speaker_ids": b.get("speaker_ids"),
                "speaker_embeddings": b.get("speaker_embeddings")}

    def _loss_fn(self, b: dict, r: int, generator):
        """Forward + criterion on one batch of tensors -> (total, parts,
        outputs), in training mode."""
        self.model.train()
        mel_in = b["mel"]
        args = (b["text"], b["text_lengths"])
        kwargs = {**self._forward_kwargs(b, r), "generator": generator}
        if self.cfg.training.mixed_precision:
            cast = {n: p.to(torch.bfloat16) for n, p in self.model.named_parameters()
                    if p.dtype == torch.float32}
            if kwargs["speaker_embeddings"] is not None:
                kwargs["speaker_embeddings"] = kwargs["speaker_embeddings"].to(torch.bfloat16)
            out = torch.func.functional_call(self.model, cast,
                                             args + (mel_in.to(torch.bfloat16),), kwargs)
        else:
            out = self.model(*args, mel_in, **kwargs)
        out = {k: v.float() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
        total, parts = self.criterion(out, b["mel"], b["mel_lengths"], b["stop_targets"],
                                      b["text_lengths"], step=self.step, r=r)
        return total, parts, out

    def train_step(self, batch: dict, r: int) -> dict:
        """One optimizer step on a numpy batch; returns the float metrics
        (losses and the gradient norm before clipping)."""
        total, parts, _ = self._loss_fn(self._tensors(batch), r, self.generator)
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        self.optimizer.step(grads)
        self.step += 1
        keys = list(parts)
        vals = torch.stack([parts[k].detach().float() for k in keys] + [grad_norm]).tolist()
        return dict(zip(keys + ["grad_norm"], vals))

    # --- loops -------------------------------------------------------------

    def fit(self, max_steps: int | None = None) -> dict:
        """Train for cfg.training.epochs epochs or `max_steps` steps, with an
        evaluation pass after each epoch; returns the last epoch's mean
        metrics. Test-sentence synthesis is not run (a later slice)."""
        cfg = self.cfg
        global_step = self.step
        last_metrics: dict = {}
        epoch, r = 0, self.model.r
        for epoch in range(cfg.training.epochs):
            self.console.print_epoch_start(epoch, cfg.training.epochs)
            r, bs = gradual_schedule(global_step, cfg.training.gradual_training, cfg.model.r,
                                     cfg.training.batch_size)
            self.model.set_r(r)
            epoch_metrics: list[dict] = []
            t_loader = time.time()
            for batch in self.train_data.batches(bs, r, shuffle=True, seed=epoch):
                loader_time = time.time() - t_loader
                t0 = time.time()
                metrics = self.train_step(batch, r)
                metrics["step_time"] = time.time() - t0
                metrics["loader_time"] = loader_time
                metrics["lr"] = float(self.lr_fn(global_step))
                epoch_metrics.append(metrics)
                global_step += 1
                if self.verbose and global_step % cfg.io.print_step == 0:
                    self.console.print_train_step(
                        len(self.train_data) // bs, global_step, global_step,
                        {k: metrics[k] for k in ("loss", "decoder_loss", "postnet_loss",
                                                 "step_time") if k in metrics})
                if cfg.io.checkpoint and self.output_path and \
                        global_step % cfg.io.save_step == 0:
                    self._save(global_step, epoch, r)
                t_loader = time.time()
                new_r, _ = gradual_schedule(global_step, cfg.training.gradual_training,
                                            cfg.model.r, cfg.training.batch_size)
                if new_r != r or (max_steps and global_step >= max_steps):
                    break
            if epoch_metrics:
                last_metrics = {k: float(np.mean([m[k] for m in epoch_metrics]))
                                for k in epoch_metrics[0]}
                self.console.print_epoch_end(epoch, last_metrics)
            if self.eval_data is not None and cfg.training.run_eval:
                eval_metrics = self.evaluate(r)
                if self.output_path:
                    self.best_loss = save_best_model(
                        eval_metrics.get("loss", float("inf")), self.best_loss,
                        self.output_path, model=self.model, optimizer=self.optimizer,
                        step=global_step, epoch=epoch, r=r)
            if max_steps and global_step >= max_steps:
                break
        if self.output_path and cfg.io.checkpoint:
            self._save(global_step, epoch, r)
        return last_metrics

    @torch.no_grad()
    def evaluate(self, r: int | None = None) -> dict:
        """Eval-mode teacher-forced losses and the alignment score over the
        eval set, weighted by each batch's real rows."""
        r = r or self.model.r
        self.console.print_eval_start()
        self.model.eval()
        all_metrics, scores, weights = [], [], []
        for batch in self.eval_data.batches(self.cfg.training.eval_batch_size, r,
                                            shuffle=False):
            real_b = int(batch["n_real"])
            b = self._tensors(batch)
            out = self.model(b["text"], b["text_lengths"], b["mel"],
                             **self._forward_kwargs(b, r))
            _, parts = self.criterion(out, b["mel"], b["mel_lengths"], b["stop_targets"],
                                      b["text_lengths"], step=self.step, r=r)
            all_metrics.append({k: float(v) for k, v in parts.items()})
            scores.append(alignment_diagonal_score(out["alignments"][:real_b].cpu().numpy()))
            weights.append(real_b)
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        out = {k: float(np.sum(w * [m[k] for m in all_metrics])) for k in all_metrics[0]}
        out["alignment_score"] = float(np.sum(w * np.asarray(scores)))
        return out

    def test_run(self, global_step: int) -> None:
        raise NotImplementedError(f"test-sentence synthesis during training {_LATER}")

    def start_profiler(self, port: int = 9999) -> None:
        raise NotImplementedError(f"the profiler server {_LATER}")

    # --- persistence -------------------------------------------------------

    def _save(self, step: int, epoch: int, r: int) -> None:
        path = os.path.join(self.output_path, f"checkpoint_{step}.npz")
        save_checkpoint(path, self.model, self.optimizer, step=step, epoch=epoch, r=r,
                        extra={"g2p_backend": self.train_data.g2p_backend_name or ""})
        if self.verbose:
            print(f" > CHECKPOINT: {path}")

    def restore(self, path: str, lenient: bool = False) -> dict:
        """Resume from a checkpoint: parameters, BatchNorm state, step, r,
        and (unless lenient) the optimizer state. lenient keeps the current
        values of leaves whose name or shape does not match, with a
        warning, and leaves the optimizer as it is."""
        params, state, meta = read_checkpoint(path)
        sd = params_from_jax(params, state, jax_layouts(self.model))
        own = self.model.state_dict()
        if lenient:
            skipped = [k for k in own if k not in sd or sd[k].shape != own[k].shape]
            if skipped:
                warnings.warn(f"checkpoint partial restore: kept init values for {skipped}",
                              stacklevel=2)
            sd = {k: v for k, v in sd.items() if k in own and v.shape == own[k].shape}
        self.model.load_state_dict(sd, strict=not lenient)
        if not lenient:
            opt = read_optimizer_state(path, self.model)
            if opt is not None:
                self.optimizer.load_state_dict(opt)
        self.step = int(meta["step"])
        if "r" in meta:
            self.model.set_r(meta["r"])
        return meta
