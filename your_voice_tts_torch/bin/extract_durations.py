"""Teacher durations for ParallelTTS training (the JAX package's
bin/extract_durations.py):

    python -m your_voice_tts_torch.bin.extract_durations \\
        --config tts_config.json --checkpoint taco2.npz --data_path corpus/ \\
        --output durations.npz [--batch_size 16] [--device cpu]

Runs the trained Tacotron2 teacher-forced over the corpus (`Tacotron2.
forward` in eval mode, no dropout; on CUDA its decoder recurrence is the
training forward kernel through `DecoderCore`) and turns each item's
attention alignment into integer durations a token: each decoder step's r
frames go to its argmax token, then the row is repaired to sum to the
item's mel length exactly (`durations_from_alignment`). r comes from the
checkpoint's meta, else from the config. The entries are taken in the
dataset's length-sorted order, `batch_size` at a time, as the reference
groups them. Output: one .npz mapping each wav's basename to int32
[T_tokens], which the JAX package's train_parallel reads as well as this
package's. Without --device it runs on CUDA.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def durations_from_alignment(align, n_tokens: int, mel_len: int, r: int):
    """[steps, T_text] alignment -> int32 [n_tokens] durations summing to
    mel_len. Steps past the mel length are ignored; frames are credited r
    at a time to the argmax token, then the total is repaired."""
    steps_needed = -(-mel_len // r)
    am = np.asarray(align)[:steps_needed, :n_tokens].argmax(axis=1)
    d = np.zeros((n_tokens,), np.int64)
    for t in am:
        d[t] += r
    # the last r-group may overshoot mel_len: trim from the last attended
    # tokens, never below zero
    excess = int(d.sum()) - mel_len
    t = len(am) - 1
    while excess > 0 and t >= 0:
        take = min(excess, int(d[am[t]]))
        d[am[t]] -= take
        excess -= take
        t -= 1
    # a degenerate alignment (an untrained teacher): the rest onto the most
    # attended token
    if int(d.sum()) != mel_len:
        d[int(np.argmax(d))] += mel_len - int(d.sum())
    return d.astype(np.int32)


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description="Extract ParallelTTS durations")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--meta_file", default="metadata.csv")
    p.add_argument("--output", default="durations.npz")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present)")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from .. import resolve_device
    from ..audio import AudioProcessor
    from ..config import load_config
    from ..data.dataset import TTSDataset
    from ..data.formatters import load_meta_data
    from ..models import setup_model
    from ..text import symbols
    from ..train.checkpoint import load_checkpoint

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    ds0 = dataclasses.replace(cfg.data.datasets[0], path=args.data_path,
                              meta_file_train=args.meta_file)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds0,)))
    items, _ = load_meta_data(cfg.data.datasets, eval_split=False)
    dataset = TTSDataset(items, cfg, AudioProcessor(cfg.audio, device))
    model = setup_model(len(symbols), cfg, device)
    meta = load_checkpoint(model, args.checkpoint)
    r = int(meta.get("r", cfg.model.r))
    model.set_r(r)
    model.eval()

    out: dict[str, np.ndarray] = {}
    ents = dataset.entries
    for s in range(0, len(ents), args.batch_size):
        if (s // args.batch_size) % 8 == 0:
            print(f" > durations {s}/{len(ents)}", flush=True)
        group = ents[s: s + args.batch_size]
        batch = dataset._collate(group, len(group), r)
        t = {k: torch.as_tensor(batch[k]).to(device)
             for k in ("text", "text_lengths", "mel", "mel_lengths")}
        with torch.no_grad():
            res = model(t["text"].long(), t["text_lengths"], t["mel"], t["mel_lengths"], r=r)
        aligns = res["alignments"].float().cpu().numpy()        # [B, steps, T_text]
        for i, e in enumerate(group):
            key = os.path.splitext(os.path.basename(e["wav"]))[0]
            out[key] = durations_from_alignment(aligns[i], int(batch["text_lengths"][i]),
                                                int(batch["mel_lengths"][i]), r)
    np.savez(args.output, **out)
    print(f" > wrote {len(out)} duration rows -> {args.output}")
    return out


if __name__ == "__main__":
    main()
