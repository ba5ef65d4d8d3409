"""Training CLI (the JAX package's bin/train.py) for a Tacotron2 or a
Tacotron(1) config, one device:

    python -m your_voice_tts_torch.bin.train --config_path configs/x.json \\
        [--restore_path ckpt.npz | --continue_path run_dir] [--max_steps N] \\
        [--output_path runs] [--device cpu]

The run goes to <output_path>/<run_name>-<date>-<commit>/ (config copy,
checkpoints; utils/io.create_experiment_folder). A "synthetic" dataset whose
path does not exist (configs/smoke_synthetic.json ships "SET_AT_RUNTIME") is
generated there first with data/synthetic.py at the config's sample rate,
with 4 speakers for a multi-speaker config. A config conditioned on
external d-vectors (speakers.use_external_speaker_embedding_file) reads
them from speakers.external_speaker_embedding_file, a speakers.json as
bin/compute_embeddings writes it (each speaker's clips averaged); the JAX
package's CLI passes none, and its trainer then fails at the first step.
Without --device the run needs CUDA.

Under an initialized process group (bin/distribute.py hands off here with
one, or torchrun's environment, which the CLI reads) the Trainer trains
data-parallel; rank 0 alone makes the run folder, copies the config and
generates a synthetic corpus, and every rank reads them after a barrier.
"""

from __future__ import annotations

import argparse
import dataclasses
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
                make_synthetic_corpus(path, n_items=32, sr=cfg.audio.sample_rate,
                                      n_speakers=4 if cfg.speakers.use_speaker_embedding else 1)
            print(f" > Synthetic corpus: {path}")
            ds = dataclasses.replace(ds, path=path)
        datasets.append(ds)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=tuple(datasets)))


def _d_vectors(cfg):
    """speaker -> d-vector from the config's external speakers.json, or None
    where the config takes none."""
    from ..utils.speakers import load_speaker_mapping, parse_speakers

    sp = cfg.speakers
    if not (sp.use_speaker_embedding and sp.use_external_speaker_embedding_file):
        return None
    if not sp.external_speaker_embedding_file:
        raise ValueError("speakers.use_external_speaker_embedding_file needs "
                         "speakers.external_speaker_embedding_file (a speakers.json of "
                         "d-vectors, as bin/compute_embeddings writes it)")
    _, vectors = parse_speakers(load_speaker_mapping(sp.external_speaker_embedding_file))
    if vectors is None:
        raise ValueError(f"{sp.external_speaker_embedding_file} maps speakers to ids, "
                         "not to d-vectors")
    return vectors


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Train Tacotron2 or Tacotron(1) with the PyTorch port")
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
    from ..parallel import mesh
    from ..train.trainer import Trainer
    from ..utils.io import create_experiment_folder

    cfg = load_config(args.config_path)
    check_config(cfg)
    mesh.init_from_env(args.device)
    device = resolve_device(args.device)
    if args.continue_path:
        out_path = args.continue_path
        ckpts = sorted((f for f in os.listdir(out_path)
                        if f.startswith("checkpoint_") and f.endswith(".npz")),
                       key=lambda f: int(f.split("_")[1].split(".")[0]))
        restore = os.path.join(out_path, ckpts[-1]) if ckpts else None
    else:
        out_path = None
        if mesh.is_rank0():
            out_path = create_experiment_folder(args.output_path or cfg.io.output_path,
                                                cfg.io.run_name)
            shutil.copy(args.config_path, os.path.join(out_path, "config.json"))
        out_path = mesh.broadcast_object(out_path)
        restore = args.restore_path
    made = _synthetic_corpus(cfg, out_path) if mesh.is_rank0() else None
    mesh.barrier()
    cfg = made or _synthetic_corpus(cfg, out_path)

    trainer = Trainer(cfg, output_path=out_path, device=device,
                      speaker_embeddings=_d_vectors(cfg))
    if restore:
        meta = trainer.restore(restore, lenient=args.restore_path is not None)
        print(f" > Restored from {restore} (step {meta['step']})")
    trainer.fit(max_steps=args.max_steps)
    if trainer.tb.writer is not None:
        trainer.tb.writer.close()


if __name__ == "__main__":
    main()
