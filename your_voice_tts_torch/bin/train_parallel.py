"""ParallelTTS training CLI (the JAX package's bin/train_parallel.py):

    python -m your_voice_tts_torch.bin.train_parallel \\
        --config_path config.json --data_path corpus/ \\
        [--durations durations.npz] [--speakers_json speakers.json] \\
        [--batch_size B] [--lr LR | --use_config_optimizer] \\
        [--restore_path ckpt.npz] [--max_steps N] [--save_step N] \\
        [--output_path runs/par] [--device cpu]

Teacher durations come from bin/extract_durations.py (`--durations`, every
corpus item checked up front, each row repaired to its mel length);
without them uniform durations bootstrap the model. `--speakers_json`
(bin/compute_embeddings' output) trains a d-vector-conditioned model. A GST
model takes each target mel as its own style, an energy model the teacher
`frame_energy` of its target as its energy.

The corpus is walked as the reference walks it: the dataset's length-sorted
entries cut into groups of batch_size, the groups in
np.random.default_rng(0) permutation order each epoch, each group one
batch padded to its own shape; dropout draws from a torch.Generator seeded
42. The optimizer is the reference's apply_if_finite(chain(
clip_by_global_norm(grad_clip or 1), adam(lr)), 10,000) (`optim.ClipAdam`
with if_finite, no host read a step), or with --use_config_optimizer the
config's RAdam stack (`optim.build_optimizer`). Checkpoints are
`checkpoint_<step>.npz` in the JAX layout: parameters, BatchNorm state and
the Adam state at the reference's `.inner_state[1][0]`, so the JAX
train_parallel's --restore_path takes them, and this one takes its; with
--use_config_optimizer the optimizer state goes to the port's own section
(as bin/train.py writes it).

It trains on one device. The reference's data-parallel mesh
(parallel/mesh.py: `shard_batch`, `pad_batch_to_devices`) is not ported
here. Without --device it runs on CUDA.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

BATCH_KEYS = ("text", "text_lengths", "mel", "mel_lengths", "durations", "speaker_embeddings")


def step_loss(model, criterion, b: dict, generator=None):
    """The training forward and loss on one batch of tensors `b` (text,
    text_lengths, mel, mel_lengths, durations, optionally
    speaker_embeddings) -> (total, parts): max_frames is the mel bucket, a
    GST model's style is the target mel, an energy model's energy the
    target's `frame_energy`."""
    from ..models.parallel_tts import frame_energy

    kw = {}
    if model.use_gst:
        kw["style_mel"], kw["style_len"] = b["mel"], b["mel_lengths"]
    if model.energy is not None:
        fm = torch.arange(b["mel"].shape[1], device=b["mel"].device)[None, :] \
            < b["mel_lengths"][:, None]
        kw["energies"] = frame_energy(b["mel"], fm)
    out = model(b["text"], b["text_lengths"], b["durations"], max_frames=b["mel"].shape[1],
                generator=generator, speaker_embeddings=b.get("speaker_embeddings"), **kw)
    return criterion(out, b["mel"], b["durations"], b["text_lengths"])


def step_grads(model, criterion, b: dict, generator=None):
    """(parts, gradients of the trained parameters, zeros where unused) of
    one training-mode pass."""
    model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    total, parts = step_loss(model, criterion, b, generator)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return parts, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description="Train ParallelTTS")
    p.add_argument("--config_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--meta_file", default="metadata.csv")
    p.add_argument("--durations", default=None,
                   help=".npz from bin/extract_durations (wav basename -> int32 [T_tokens]); "
                        "omitted = uniform durations")
    p.add_argument("--output_path", default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--save_step", type=int, default=1000)
    p.add_argument("--restore_path", default=None)
    p.add_argument("--lr", type=float, default=1e-3, help="Adam learning rate")
    p.add_argument("--use_config_optimizer", action="store_true",
                   help="use the config's RAdam + Noam stack instead")
    p.add_argument("--batch_size", type=int, default=None,
                   help="override cfg.training.batch_size")
    p.add_argument("--speakers_json", default=None,
                   help="external d-vector mapping (bin/compute_embeddings output): trains a "
                        "d-vector-conditioned ParallelTTS")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present)")
    args = p.parse_args(argv)

    import dataclasses

    from .. import resolve_device
    from ..audio import AudioProcessor
    from ..config import load_config
    from ..data.dataset import TTSDataset
    from ..data.formatters import load_meta_data
    from ..models import setup_model
    from ..models.parallel_tts import ParallelTTSLoss, repair_row_durations, uniform_durations
    from ..text import symbols
    from ..train.checkpoint import (load_checkpoint, read_optimizer_state,
                                    restore_trainer_checkpoint, save_checkpoint,
                                    save_trainer_checkpoint)
    from ..train.optim import ClipAdam, build_optimizer

    device = resolve_device(args.device)
    cfg = load_config(args.config_path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model="ParallelTTS"))
    if args.batch_size:
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, batch_size=args.batch_size))
    ds0 = dataclasses.replace(cfg.data.datasets[0], path=args.data_path,
                              meta_file_train=args.meta_file)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds0,)))
    items, _ = load_meta_data(cfg.data.datasets, eval_split=False)
    ap = AudioProcessor(cfg.audio, device)
    spk_embeddings, spk_dim = None, 0
    if args.speakers_json:
        from ..utils.speakers import load_speaker_mapping, parse_speakers

        _, dvecs = parse_speakers(load_speaker_mapping(args.speakers_json))
        spk_embeddings = {k: np.asarray(v, np.float32) for k, v in dvecs.items()}
        spk_dim = len(next(iter(spk_embeddings.values())))
    dataset = TTSDataset(items, cfg, ap, speaker_embeddings=spk_embeddings)
    basename = lambda e: os.path.splitext(os.path.basename(e["wav"]))[0]  # noqa: E731

    dur_table = None
    if args.durations:
        with np.load(args.durations) as z:
            dur_table = {k: z[k] for k in z.files}
        # every corpus item needs a row: fail now, not mid-epoch
        missing = [e["wav"] for e in dataset.entries if basename(e) not in dur_table]
        if missing:
            raise KeyError(
                f"durations file {args.durations} is missing {len(missing)}/"
                f"{len(dataset.entries)} corpus items (first: {missing[:3]}). Re-run "
                f"bin/extract_durations on this corpus, or drop --durations for uniform "
                f"bootstrap durations.")

    model = setup_model(len(symbols), cfg, device, speaker_embedding_dim=spk_dim)
    params = [q for q in model.parameters() if q.requires_grad]
    if args.use_config_optimizer:
        optimizer = build_optimizer(params, cfg.training)
    else:
        optimizer = ClipAdam(params, args.lr, cfg.training.grad_clip or 1.0, if_finite=True)
    step0 = 0
    if args.restore_path:
        if args.use_config_optimizer:
            meta = load_checkpoint(model, args.restore_path)
            opt = read_optimizer_state(args.restore_path, model)
            if opt is not None:
                optimizer.load_state_dict(opt)
        else:
            meta = restore_trainer_checkpoint(args.restore_path, {None: (model, optimizer)})
        step0 = int(meta.get("step", 0))
    criterion = ParallelTTSLoss()
    generator = torch.Generator(device=device).manual_seed(42)

    def save(step: int, epoch: int) -> None:
        path = os.path.join(args.output_path, f"checkpoint_{step}.npz")
        extra = {"model": "ParallelTTS"}
        if args.use_config_optimizer:
            save_checkpoint(path, model, optimizer, step=step, epoch=epoch, r=1, extra=extra)
        else:
            save_trainer_checkpoint(path, {None: (model, optimizer)}, step=step, epoch=epoch,
                                    extra=extra)

    def batch_durations(batch, group):
        """The group's teacher durations: its rows of the table, each
        repaired to the loader's mel length, or uniform ones."""
        B, T = batch["text"].shape
        if dur_table is None:
            return uniform_durations(batch["text_lengths"], batch["mel_lengths"], T).numpy()
        out = np.zeros((B, T), np.int32)
        for i, e in enumerate(group):
            key = basename(e)
            if key not in dur_table:
                raise KeyError(f"durations file has no entry for '{key}' (wav: {e['wav']}). "
                               f"Re-run bin/extract_durations on this corpus, or drop "
                               f"--durations for uniform bootstrap durations.")
            d = repair_row_durations(dur_table[key], int(batch["mel_lengths"][i]), T)
            out[i, : len(d)] = d
        return out

    B = cfg.training.batch_size
    groups = [dataset.entries[s: s + B] for s in range(0, len(dataset.entries), B)]
    rng_np = np.random.default_rng(0)
    step = step0
    last_parts: dict = {}
    t0 = time.time()
    # --max_steps is the budget when given: epochs loop until it is reached
    n_epochs = cfg.training.epochs if not args.max_steps else 10 ** 9
    for epoch in range(n_epochs):
        for gi in rng_np.permutation(len(groups)):
            group = groups[gi]
            batch = dataset._collate(group, len(group), 1)
            batch["durations"] = batch_durations(batch, group)
            b = {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS if k in batch}
            b["text"] = b["text"].long()
            parts, grads = step_grads(model, criterion, b, generator)
            optimizer.step(grads)
            step += 1
            keys = list(parts)
            last_parts = dict(zip(keys, torch.stack([parts[k].detach() for k in keys]).tolist()))
            if step % 25 == 0:
                print(f" > step {step} loss {last_parts['loss']:.4f} "
                      f"dur {last_parts['loss_duration']:.4f} ({(time.time() - t0):.0f}s)",
                      flush=True)
            if args.output_path and step % args.save_step == 0:
                save(step, epoch)
            if args.max_steps and step - step0 >= args.max_steps:
                break
        else:
            continue
        break
    if args.output_path:
        save(step, 0)
    return last_parts


if __name__ == "__main__":
    main()
