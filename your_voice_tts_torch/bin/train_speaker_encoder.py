"""Speaker-encoder training CLI (the JAX package's
bin/train_speaker_encoder.py):

    python -m your_voice_tts_torch.bin.train_speaker_encoder --config tts.json \\
        --data_path corpus/ --formatter synthetic --max_steps 1000 [--device cpu]

Trains the GE2E encoder (80 -> 3 x 768 / 256 by default, the input width
from the config's num_mels) on N speakers x M utterances a batch and writes
<output_path>/speaker-encoder-<date>-<commit>/final.npz, a JAX-layout
checkpoint that both packages' `load_encoder` and bin/compute_embeddings
read. Under an initialized process group (torchrun's environment, which
the CLI reads) the trainer trains data-parallel (speaker_encoder/train.py),
and rank 0 alone makes the run folder and writes the checkpoints. Without
--device it needs CUDA.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Train the GE2E speaker encoder")
    p.add_argument("--config", required=True, help="TTS config (audio params)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--formatter", default="ljspeech")
    p.add_argument("--meta_file", default="metadata.csv")
    p.add_argument("--output_path", default="runs-speaker-encoder")
    p.add_argument("--restore_path", default=None)
    p.add_argument("--max_steps", type=int, default=100_000)
    p.add_argument("--num_frames", type=int, default=160)
    p.add_argument("--num_speakers_per_batch", type=int, default=32)
    p.add_argument("--num_utters_per_speaker", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from .. import resolve_device
    from ..audio import AudioProcessor
    from ..parallel import mesh
    from ..config import load_config
    from ..data.formatters import get_formatter
    from ..speaker_encoder.dataset import SpeakerEncoderDataset
    from ..speaker_encoder.model import SpeakerEncoder
    from ..speaker_encoder.train import SpeakerEncoderTrainer
    from ..utils.io import create_experiment_folder

    mesh.init_from_env(args.device)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    ap = AudioProcessor(cfg.audio, device)
    items = get_formatter(args.formatter)(args.data_path, args.meta_file)
    dataset = SpeakerEncoderDataset(items, ap, num_frames=args.num_frames)
    model = SpeakerEncoder(input_dim=cfg.audio.num_mels, device=device)
    out = mesh.broadcast_object(create_experiment_folder(args.output_path, "speaker-encoder")
                                if mesh.is_rank0() else None)
    trainer = SpeakerEncoderTrainer(model, dataset, lr=args.lr,
                                    num_speakers_per_batch=args.num_speakers_per_batch,
                                    num_utters_per_speaker=args.num_utters_per_speaker,
                                    output_path=out, device=device)
    if args.restore_path:
        trainer.restore(args.restore_path)
    trainer.fit(args.max_steps)
    if mesh.is_rank0():
        trainer.save(f"{out}/final.npz")
        print(f" > speaker encoder saved to {out}/final.npz")


if __name__ == "__main__":
    main()
