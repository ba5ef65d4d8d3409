"""Corpus preprocessing (the JAX package's bin/preprocess.py): warm the
dataset's caches, or audit a corpus.

    python -m your_voice_tts_torch.bin.preprocess --config_path config.json \\
        --cache_dir cache/ [--device cpu]

computes every clip's mel (and, for a Tacotron(1) config, its linear
spectrogram) and, for a phoneme config, its phoneme ids, into the files
`data.TTSDataset` reads from that cache directory, so that training starts
on cached features (point data.phoneme_cache_path at it). The spectrograms
are computed on CUDA unless --device names another device.

    python -m your_voice_tts_torch.bin.preprocess --config_path config.json --audit

checks the corpus instead: formatter rows, WAV headers (readable, mono,
sample rate; parsed by `audio.wav_info`, the parser of `audio.read_wav`),
text and duration distributions, per-speaker counts, and prints the report
as JSON; it exits 1 when it finds a problem. The audit is host work only:
it reads headers and computes nothing.
"""

from __future__ import annotations

import argparse
import os
import time


def audit(cfg) -> dict:
    """Check every metadata row and WAV header; returns the report (the JAX
    package's keys; `loader` names the header parser)."""
    import numpy as np

    from ..audio import wav_info
    from ..data import load_meta_data

    items, eval_items = load_meta_data(cfg.data.datasets)
    rows = items + eval_items
    report = {"rows": len(rows), "train_rows": len(items), "eval_rows": len(eval_items)}
    problems: list[str] = []
    warnings: list[str] = []            # handled later (resampling): never fail the audit
    durations, text_lens = [], []
    speakers: dict[str, int] = {}
    sr_expected = cfg.audio.sample_rate
    for text, wav_path, speaker in rows:
        speakers[speaker] = speakers.get(speaker, 0) + 1
        if not text or not text.strip():
            problems.append(f"empty text for {wav_path}")
        text_lens.append(len(text))
        if not os.path.exists(wav_path):
            problems.append(f"missing wav: {wav_path}")
            continue
        try:
            info = wav_info(wav_path)
        except (OSError, ValueError, IndexError) as e:
            problems.append(f"{wav_path}: unreadable ({type(e).__name__}: {e})")
            continue
        ch, bits, sr, n = (info[k] for k in ("channels", "bits", "sample_rate", "n_frames"))
        if ch != 1:
            problems.append(f"{wav_path}: {ch} channels (want mono)")
        if bits not in (8, 16, 24, 32, 64):
            problems.append(f"{wav_path}: sample width {bits} bits")
        if sr != sr_expected:
            warnings.append(f"{wav_path}: {sr} Hz != config {sr_expected} Hz "
                            "(will be resampled)")
        if n == 0:
            problems.append(f"{wav_path}: zero frames")
        durations.append(n / max(sr, 1))
    if durations:
        d = np.asarray(durations)
        report["audio_hours"] = round(float(d.sum()) / 3600, 3)
        report["duration_s"] = {"min": round(float(d.min()), 2),
                                "p50": round(float(np.median(d)), 2),
                                "max": round(float(d.max()), 2)}
    if text_lens:
        t = np.asarray(text_lens)
        report["text_chars"] = {"min": int(t.min()), "p50": int(np.median(t)),
                                "max": int(t.max())}
        n_out = int((t < cfg.data.min_seq_len).sum()) + int((t > cfg.data.max_seq_len).sum())
        if n_out:
            report["filtered_by_seq_len"] = n_out
    report["loader"] = "read_wav"
    report["speakers"] = len(speakers)
    report["per_speaker_min"] = min(speakers.values()) if speakers else 0
    report["problems"] = problems
    report["warnings"] = warnings
    return report


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Precompute dataset caches, or audit a corpus")
    p.add_argument("--config_path", required=True)
    p.add_argument("--cache_dir")
    p.add_argument("--audit", action="store_true",
                   help="check metadata and WAV headers, compute nothing")
    p.add_argument("--device", default=None,
                   help="torch device of the spectrograms (default: cuda)")
    args = p.parse_args(argv)

    from ..config import load_config

    cfg = load_config(args.config_path)
    if args.audit:
        import json

        report = audit(cfg)
        print(json.dumps(report, indent=2))
        return 1 if report["problems"] else 0

    if not args.cache_dir:
        p.error("--cache_dir is required unless --audit is given")
    from .. import resolve_device
    from ..audio import AudioProcessor
    from ..data import TTSDataset, load_meta_data

    ap = AudioProcessor(cfg.audio, resolve_device(args.device))
    items, eval_items = load_meta_data(cfg.data.datasets)
    os.makedirs(args.cache_dir, exist_ok=True)
    t0 = time.time()
    ds = TTSDataset(items + eval_items, cfg, ap, cache_dir=args.cache_dir)
    total_frames = sum(e["mel_len"] for e in ds.entries)
    print(f" > cached {len(ds)} utterances / {total_frames} mel frames "
          f"in {time.time() - t0:.1f}s -> {args.cache_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
