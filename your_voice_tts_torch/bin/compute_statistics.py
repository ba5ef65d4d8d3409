"""Per-bin mean / std statistics of a corpus (the JAX package's
bin/compute_statistics.py), the `scale_stats.npy` that `audio.stats_path`
names:

    python -m your_voice_tts_torch.bin.compute_statistics \\
        --config_path config.json --out_path scale_stats.npy [--device cpu]

The statistics are taken over the raw dB-minus-ref spectrograms
(normalization and any earlier statistics off), the values the scaling
later transforms, as float64 sums and sums of squares. The clips go
through the AudioProcessor's batched spectrograms. Runs on CUDA unless
--device names another device.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

BATCH = 64      # clips a batched spectrogram call


def compute_statistics(cfg, items, include_linear: bool = True, device=None) -> dict:
    """items: [(text, wav_path, speaker), ...] formatter rows. Returns the
    scale_stats dict: mel_mean / mel_std [num_mels], n_frames, the raw
    audio config, and with include_linear linear_mean / linear_std
    [num_freq]."""
    from .. import resolve_device
    from ..audio import AudioProcessor

    raw_audio = dataclasses.replace(cfg.audio, signal_norm=False, stats_path=None)
    ap = AudioProcessor(raw_audio, resolve_device(device))
    n = 0
    mel_sum = mel_sq = lin_sum = lin_sq = 0.0
    for s in range(0, len(items), BATCH):
        wavs = [ap.load_wav(item[1]) for item in items[s:s + BATCH]]
        for mel in ap.melspectrogram_batch(wavs):              # [T, num_mels]
            mel = mel.astype(np.float64)
            mel_sum = mel_sum + mel.sum(axis=0)
            mel_sq = mel_sq + (mel ** 2).sum(axis=0)
            n += mel.shape[0]
        if include_linear:
            for lin in ap.spectrogram_batch(wavs):
                lin = lin.astype(np.float64)
                lin_sum = lin_sum + lin.sum(axis=0)
                lin_sq = lin_sq + (lin ** 2).sum(axis=0)
    mel_mean = mel_sum / n
    out = {"mel_mean": mel_mean.astype(np.float32),
           "mel_std": np.sqrt(np.maximum(mel_sq / n - mel_mean ** 2, 1e-10)).astype(np.float32),
           "n_frames": n,
           "audio_config": dataclasses.asdict(raw_audio)}
    if include_linear:
        lin_mean = lin_sum / n
        out["linear_mean"] = lin_mean.astype(np.float32)
        out["linear_std"] = np.sqrt(
            np.maximum(lin_sq / n - lin_mean ** 2, 1e-10)).astype(np.float32)
    return out


def main(argv: list[str] | None = None) -> None:
    from ..config import load_config
    from ..data.formatters import get_formatter

    parser = argparse.ArgumentParser(description="Compute mean / std spectrogram statistics")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--out_path", required=True)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config_path)
    items = []
    for ds in cfg.data.datasets:
        items.extend(get_formatter(ds.name)(ds.path, ds.meta_file_train))
    stats = compute_statistics(cfg, items, device=args.device)
    np.save(args.out_path, stats, allow_pickle=True)
    print(f" > {len(items)} clips, {stats['n_frames']} frames -> {args.out_path}")


if __name__ == "__main__":
    main()
