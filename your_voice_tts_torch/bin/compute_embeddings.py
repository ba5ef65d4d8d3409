"""d-vector extraction CLI (the JAX package's bin/compute_embeddings.py):

python -m your_voice_tts_torch.bin.compute_embeddings \
    --checkpoint se.npz --config tts_config.json --data_path corpus/ \
    --formatter synthetic --output speakers.json [--device cpu]

Writes speakers.json as {speaker: {clip_id: {"embedding": [...]}}}, the
layout `Synthesizer(speakers_json=...)` and multi-speaker training read.
Each clip's d-vector is the speaker encoder's embedding of its first
--num_frames mel frames (a shorter mel tiled to that length), as the JAX
package computes it; the clips go through the encoder in batches. Without
--checkpoint the encoder keeps seeded random weights at its default widths.
Runs on CUDA unless --device names another device.
"""

from __future__ import annotations

import argparse
import json
import os

BATCH = 256     # clips a forward pass


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Compute speaker d-vectors")
    p.add_argument("--checkpoint", default=None,
                   help="speaker-encoder checkpoint (random init if omitted)")
    p.add_argument("--config", required=True, help="TTS config (audio params)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--formatter", default="ljspeech")
    p.add_argument("--meta_file", default="metadata.csv")
    p.add_argument("--output", default="speakers.json")
    p.add_argument("--num_frames", type=int, default=160)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..audio import AudioProcessor
    from ..config import load_config
    from ..data.formatters import get_formatter
    from ..speaker_encoder.model import SpeakerEncoder, load_encoder

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    ap = AudioProcessor(cfg.audio, device)
    if args.checkpoint:
        model = load_encoder(args.checkpoint, default_input_dim=cfg.audio.num_mels,
                             device=device)
    else:
        model = SpeakerEncoder(input_dim=cfg.audio.num_mels, device=device)

    items = get_formatter(args.formatter)(args.data_path, args.meta_file)
    mels = ap.melspectrogram_batch(ap.load_wav_batch([wav for _, wav, _ in items]))
    n = args.num_frames
    windows = np.stack([np.tile(m, (-(-n // len(m)), 1))[:n] for m in mels])
    embs = []
    with torch.no_grad():
        for s in range(0, len(windows), BATCH):
            embs.append(model(torch.from_numpy(windows[s: s + BATCH]).to(device)).cpu().numpy())
    mapping: dict = {}
    for (_, wav_path, speaker), e in zip(items, np.concatenate(embs) if embs else []):
        clip = os.path.splitext(os.path.basename(wav_path))[0]
        mapping.setdefault(speaker, {})[clip] = {"embedding": e.tolist()}
        print(f" > {speaker}/{clip}")
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(mapping, f)
    print(f" > wrote {args.output} ({len(mapping)} speakers)")


if __name__ == "__main__":
    main()
