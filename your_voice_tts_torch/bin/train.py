"""Training CLI (the JAX package's bin/train.py), one device:

    python -m your_voice_tts_torch.bin.train --config_path configs/x.json \\
        [--restore_path ckpt.npz | --continue_path run_dir] [--max_steps N] \\
        [--output_path runs] [--device cpu]

The run goes to <output_path>/<run_name>-<date>/ (config copy, checkpoints).
A "synthetic" dataset whose path does not exist (configs/smoke_synthetic.json
ships "SET_AT_RUNTIME") is generated there first with data/synthetic.py at
the config's sample rate. Without --device the run needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import shutil


def _synthetic_corpus(cfg, out_path: str):
    """Point missing synthetic datasets at a corpus generated in out_path."""
    from ..data.synthetic import make_synthetic_corpus

    datasets = []
    for ds in cfg.data.datasets:
        if ds.name == "synthetic" and not os.path.isdir(ds.path):
            path = os.path.join(out_path, "synthetic_corpus")
            if not os.path.exists(os.path.join(path, "metadata.csv")):
                make_synthetic_corpus(path, n_items=32, sr=cfg.audio.sample_rate)
            print(f" > Synthetic corpus: {path}")
            ds = dataclasses.replace(ds, path=path)
        datasets.append(ds)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=tuple(datasets)))


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Train Tacotron2 with the PyTorch port")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--restore_path", default=None,
                        help="checkpoint to start from (parameters only, lenient)")
    parser.add_argument("--continue_path", default=None,
                        help="run folder to resume from its last checkpoint")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps")
    parser.add_argument("--output_path", default=None, help="override io.output_path")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..config import check_config, load_config
    from ..train.trainer import Trainer

    cfg = load_config(args.config_path)
    check_config(cfg)
    device = resolve_device(args.device)
    if args.continue_path:
        out_path = args.continue_path
        ckpts = sorted((f for f in os.listdir(out_path)
                        if f.startswith("checkpoint_") and f.endswith(".npz")),
                       key=lambda f: int(f.split("_")[1].split(".")[0]))
        restore = os.path.join(out_path, ckpts[-1]) if ckpts else None
    else:
        date = datetime.datetime.now().strftime("%B-%d-%Y_%I+%M%p")
        out_path = os.path.join(args.output_path or cfg.io.output_path,
                                f"{cfg.io.run_name}-{date}")
        os.makedirs(out_path, exist_ok=True)
        restore = args.restore_path
        shutil.copy(args.config_path, os.path.join(out_path, "config.json"))
    cfg = _synthetic_corpus(cfg, out_path)

    trainer = Trainer(cfg, output_path=out_path, device=device)
    if restore:
        meta = trainer.restore(restore, lenient=args.restore_path is not None)
        print(f" > Restored from {restore} (step {meta['step']})")
    trainer.fit(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
