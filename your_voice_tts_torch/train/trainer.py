"""Teacher-forced training of Tacotron2 and Tacotron(1) (the JAX package's
train/trainer.py), single device.

`Trainer(cfg, device=...).fit(max_steps=N)`: gradual (step, r, batch size)
schedule, the bucketed loader, one train step per batch (loss, backward
through the training kernels or the decoder's step loop for Tacotron2, see
below, and through autograd's own backward of the decoder loop for
Tacotron(1), the RAdam stack of
train/optim.py), the evaluation pass with the alignment score, test
sentences synthesized after each evaluation (`test_run`), TensorBoard
events (`utils.logging.TensorboardLogger`, where tensorboardX is
installed), and periodic and best-model checkpoints in the JAX package's
.npz layout. Tacotron(1) regresses the linear spectrogram the dataset
batches beside the mel, with the band below 3 kHz weighted twice
(`n_priority_freq`).

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

Tacotron2's decoder trains on the training kernels (5 and 6) with plain
location-sensitive attention and as a step loop under autograd with
forward attention, the transition agent or Graves, the JAX package's two
routes (models/tacotron2.py `Decoder.fast_grad_supported`); a
bidirectional-decoder model runs its backward decoder on the same route
as the forward one, and the loss adds its terms. grad_accum_steps > 1
splits each step's batch into micro-batches and applies one averaged
update (`train_step`).

`capture_trace` writes a torch.profiler trace of one call; the JAX
package's profiler server has no torch counterpart, so `start_profiler`
raises NotImplementedError. A later slice brings data parallelism.
"""

from __future__ import annotations

import importlib.util
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
from ..utils.io import count_parameters
from ..utils.logging import ConsoleLogger, TensorboardLogger
from ..utils.measures import alignment_diagonal_score
from .checkpoint import (jax_layouts, params_from_jax, read_checkpoint,
                         read_optimizer_state, save_best_model, save_checkpoint)
from .optim import build_optimizer


def gradual_schedule(step: int, schedule, default_r: int, default_bs: int) -> tuple[int, int]:
    """(r, batch_size) at `step` from [[from_step, r, batch_size], ...]."""
    r, bs = default_r, default_bs
    for row_step, row_r, row_bs in schedule or ():
        if step >= row_step:
            r, bs = row_r, row_bs
    return r, bs


def check_accumulation(cfg, A: int) -> None:
    """The JAX package's checks of grad_accum_steps A over every batch size
    the loader can emit (its messages): batch_size, each gradual_training
    row's, and under tokens_per_batch the batch quantum, whose multiples
    token buckets emit. The batch each step is given is checked again in
    `train_step`."""
    t = cfg.training
    if t.batch_size % A != 0:
        raise ValueError(f"batch_size {t.batch_size} must be divisible by grad_accum_steps {A}")
    for row in t.gradual_training or ():
        if int(row[2]) % A != 0:
            raise ValueError(f"gradual_training row {row}: batch size {row[2]} must be "
                             f"divisible by grad_accum_steps {A}")
    if cfg.data.tokens_per_batch:
        q = TTSDataset._B_QUANTUM
        if q % A != 0:
            raise ValueError(f"data.tokens_per_batch emits batches in multiples of {q}; "
                             f"grad_accum_steps {A} must divide {q}")


class Trainer:
    """End-to-end training loop: Trainer(cfg, device=...).fit()."""

    def __init__(self, cfg, output_path: str | None = None, verbose: bool = True,
                 device=None, speaker_embeddings: dict | None = None):
        sp = cfg.speakers
        if sp.use_speaker_embedding and sp.use_external_speaker_embedding_file \
                and speaker_embeddings is None:
            raise ValueError("this config conditions on external d-vectors: pass "
                             "Trainer(speaker_embeddings={speaker: vector})")
        self.accum = max(1, int(cfg.training.grad_accum_steps))
        if self.accum > 1:
            check_accumulation(cfg, self.accum)
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
        # Tacotron(1)'s priority band: the linear bins below ~3 kHz
        self.n_priority_freq = (int(3000 / (cfg.audio.sample_rate / 2) * cfg.audio.num_freq)
                                if cfg.model.model == "Tacotron" else 0)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(self.params, t)
        self.lr_fn = self.optimizer.lr_fn
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(42)
        self.output_path = output_path
        if output_path:
            os.makedirs(output_path, exist_ok=True)
        self.tb = TensorboardLogger(output_path)
        self.console = ConsoleLogger()
        self.best_loss = float("inf")
        if verbose:
            print(f" > Model has {count_parameters(self.model):,} parameters")
            print(f" > Device: {self.device}")

    # --- steps -------------------------------------------------------------

    def _tensors(self, batch: dict) -> dict:
        """A numpy batch on the device, with what the model conditions on:
        speaker_ids when it has speakers, speaker_embeddings when the
        batch carries d-vectors; and Tacotron(1)'s linear targets."""
        dev = self.device
        keys = ["text", "text_lengths", "mel", "mel_lengths", "stop_targets"]
        if "linear" in batch:
            keys.append("linear")
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
        total, parts = self._criterion(out, b, r)
        return total, parts, out

    def _criterion(self, out: dict, b: dict, r: int):
        return self.criterion(out, b["mel"], b["mel_lengths"], b["stop_targets"],
                              b["text_lengths"], step=self.step, r=r,
                              linear_target=b.get("linear"),
                              n_priority_freq=self.n_priority_freq)

    def train_step(self, batch: dict, r: int) -> dict:
        """One optimizer step on a numpy batch; returns the float metrics
        (losses and the gradient norm before clipping). With
        grad_accum_steps A > 1 (the JAX package's `train_step_accum`) the
        padded batch splits into A contiguous micro-batches of B / A rows,
        which keep its padded lengths (every tensor `_tensors` gives is
        batched; the batch's scalars, which the reference broadcasts to each
        micro-batch, are not read). Each micro-batch runs its forward and
        backward in turn, dropout drawn from the generator in order and the
        BatchNorm running statistics carried from one to the next; the
        gradients are summed in float32 and divided by A, the loss parts
        averaged, and one update applied, whose gradient norm is the
        averaged gradients'."""
        b = self._tensors(batch)
        A = self.accum
        B = b["text"].shape[0]
        if B % A != 0:
            raise ValueError(
                f"grad_accum_steps={A} does not divide the actual batch dim {B} (token batching "
                f"and gradual_training rows can change B from cfg.training.batch_size "
                f"{self.cfg.training.batch_size}); pick A dividing every batch size the loader "
                f"can emit")
        n = B // A
        grads, parts = None, []
        for i in range(A):
            micro = {k: v[i * n:(i + 1) * n] for k, v in b.items()}
            total, p, out = self._loss_fn(micro, r, self.generator)
            g = torch.autograd.grad(total, self.params, allow_unused=True)
            g = [torch.zeros_like(w, dtype=torch.float32) if x is None else x.float()
                 for w, x in zip(self.params, g)]
            grads = g if grads is None else torch._foreach_add(grads, g)
            parts.append({k: v.detach().float() for k, v in p.items()})
            del total, p, out, g          # this micro-batch's graph, before the next
        if A > 1:
            grads = torch._foreach_div(grads, A)
        grad_norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
        self.optimizer.step(grads)
        self.step += 1
        keys = list(parts[0])
        vals = torch.stack([torch.stack([p[k] for p in parts]).mean() for k in keys]
                           + [grad_norm]).tolist()
        return dict(zip(keys + ["grad_norm"], vals))

    # --- loops -------------------------------------------------------------

    def fit(self, max_steps: int | None = None) -> dict:
        """Train for cfg.training.epochs epochs or `max_steps` steps, with an
        evaluation pass after each epoch, followed from epoch
        training.test_delay_epochs on by the test sentences (`test_run`);
        returns the last epoch's mean metrics. Each step's metrics, each
        epoch's means and each evaluation go to TensorBoard."""
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
                self.tb.tb_train_iter_stats(global_step, metrics)
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
                self.tb.tb_train_epoch_stats(global_step, last_metrics)
                if cfg.io.tb_model_param_stats:
                    self.tb.tb_model_weights(global_step, self.model)
            if self.eval_data is not None and cfg.training.run_eval:
                eval_metrics = self.evaluate(r)
                self.tb.tb_eval_stats(global_step, eval_metrics)
                if epoch >= cfg.training.test_delay_epochs:
                    self.test_run(global_step)
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
            _, parts = self._criterion(out, b, r)
            all_metrics.append({k: float(v) for k, v in parts.items()})
            scores.append(alignment_diagonal_score(out["alignments"][:real_b].cpu().numpy()))
            weights.append(real_b)
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        out = {k: float(np.sum(w * [m[k] for m in all_metrics])) for k in all_metrics[0]}
        out["alignment_score"] = float(np.sum(w * np.asarray(scores)))
        return out

    DEFAULT_TEST_SENTENCES = [
        "It took me quite a long time to develop a voice, and now that I "
        "have it I'm not going to be silent.",
        "Be a voice, not an echo.",
    ]

    def test_run(self, global_step: int) -> list[dict]:
        """Free-running synthesis of the test sentences (io.test_sentences_file,
        one a line, or the two defaults) through `synthesis_batch` with
        Griffin-Lim: on the card the decode kernel (1, or 8 for
        Tacotron(1)) and the Griffin-Lim kernel `gl_route` picks. A
        speaker-conditioned model speaks as the first speaker of the map
        (id 0, or that speaker's d-vector); a GST model speaks without a
        style, as the reference's test run does. Each sentence's alignment
        and spectrogram figures (where matplotlib is installed) and its
        audio go to TensorBoard. Returns the synthesis results. Nothing is
        caught: a kernel that fails here fails training."""
        from ..infer.synthesis import synthesis_batch

        sentences = self.DEFAULT_TEST_SENTENCES
        if self.cfg.io.test_sentences_file:
            with open(self.cfg.io.test_sentences_file, encoding="utf-8") as f:
                sentences = [line.strip() for line in f if line.strip()]
        cond = {}
        if self.num_speakers:
            first = min(self.train_data.speakers, key=self.train_data.speakers.get)
            vectors = self.train_data.speaker_embeddings
            if vectors is not None:
                cond["d_vectors"] = np.stack([np.asarray(vectors[first], np.float32)]
                                             * len(sentences))
            else:
                cond["speaker_ids"] = [self.train_data.speakers[first]] * len(sentences)
        results = synthesis_batch(self.model, sentences, self.cfg, self.ap, **cond)
        if self.tb.writer is not None:
            if importlib.util.find_spec("matplotlib") is not None:
                from ..utils.visual import plot_alignment, plot_spectrogram

                figures = {}
                for i, res in enumerate(results):
                    figures[f"{i}-alignment"] = plot_alignment(res["alignment"])
                    figures[f"{i}-spectrogram"] = plot_spectrogram(res["mel_postnet_spec"],
                                                                   time_major=False)
                self.tb.tb_eval_figures(global_step, figures)
            self.tb.tb_eval_audios(global_step, {f"{i}-audio": res["wav"]
                                                 for i, res in enumerate(results)},
                                   self.cfg.audio.sample_rate)
        return results

    def start_profiler(self, port: int = 9999) -> None:
        """The JAX package's profiler server (`jax.profiler.start_server`),
        which torch has no counterpart of: it raises, pointing at
        `capture_trace`."""
        raise NotImplementedError("torch has no profiler server to connect to; trace a step "
                                  "with Trainer.capture_trace(log_dir, fn, *args)")

    def capture_trace(self, log_dir: str, fn, *args):
        """One-shot trace of fn(*args) (e.g. a train step) with
        torch.profiler: CPU activity, and CUDA activity when the model is on
        the card, whose work is synchronized before the trace closes. The
        Chrome trace goes to log_dir/trace_<time>_<pid>.json. Returns
        fn(*args)."""
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            out = fn(*args)
            if cuda:
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"))
        return out

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
