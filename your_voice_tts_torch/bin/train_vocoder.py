"""Vocoder training CLI (the JAX package's bin/train_vocoder.py):

    python -m your_voice_tts_torch.bin.train_vocoder --config_path voc.json \\
        --data_path corpus/ [--max_steps N] [--restore_path ckpt.npz] [--device cpu]

Trains the vocoder the config names on an LJSpeech-layout corpus
(metadata.csv + wavs/) and writes <output_path>/vocoder-<model>-<date>-
<commit>/final.npz, a JAX-layout checkpoint that both packages'
`VocoderSynthesizer` and trainers read. "melgan" and "pwgan" train on
`GANTrainer`, "wavernn" on `WaveRNNTrainer`; any other model raises
ValueError. (The JAX CLI sends every model but "melgan" to its WaveRNN
trainer, so a "pwgan" config trains a WaveRNN there.) Without --device it
needs CUDA.
"""

from __future__ import annotations

import argparse


def trainer_class(model: str):
    """The trainer class a vocoder config's `model` trains on."""
    if model in ("melgan", "pwgan"):
        from ..vocoder.train_gan import GANTrainer

        return GANTrainer
    if model == "wavernn":
        from ..vocoder.train_wavernn import WaveRNNTrainer

        return WaveRNNTrainer
    raise ValueError(f"unknown vocoder model {model!r}: melgan, pwgan or wavernn")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Train a neural vocoder")
    p.add_argument("--config_path", required=True)
    p.add_argument("--data_path", required=True, help="corpus root (LJSpeech metadata layout)")
    p.add_argument("--meta_file", default="metadata.csv")
    p.add_argument("--output_path", default="runs-vocoder")
    p.add_argument("--restore_path", default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from .. import resolve_device
    from ..data.formatters import ljspeech
    from ..utils.io import create_experiment_folder
    from ..vocoder.config import load_vocoder_config

    cfg = load_vocoder_config(args.config_path)
    cls = trainer_class(cfg.model)
    device = resolve_device(args.device)
    items = ljspeech(args.data_path, args.meta_file)
    out = create_experiment_folder(args.output_path, f"vocoder-{cfg.model}")
    trainer = cls(cfg, items, output_path=out, device=device)
    if args.restore_path:
        trainer.restore(args.restore_path)
    trainer.fit(args.max_steps or cfg.training.epochs * max(1, len(items)))
    trainer.save(f"{out}/final.npz")
    print(f" > vocoder saved to {out}/final.npz")


if __name__ == "__main__":
    main()
