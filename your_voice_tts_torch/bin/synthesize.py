"""Synthesis CLI (the JAX package's bin/synthesize.py).

python -m your_voice_tts_torch.bin.synthesize "Text to speak." config.json \
    checkpoint.npz out_dir/ [--vocoder_config voc.json [--vocoder_checkpoint
    voc.npz]] [--speakers_json speakers.json --speaker_id NAME_OR_ID]
    [--style_wav style.wav] [--device cpu]

The checkpoints are JAX-package `.npz` files; without a vocoder config the
waveform comes from Griffin-Lim, with one from MelGAN, PWGAN or WaveRNN
(the config's "model"). --speakers_json conditions a multi-speaker model
on the mapping's speakers (ids or d-vectors) and --speaker_id picks one.
--style_wav gives a GST model the style of a reference recording. A
phoneme config (use_phonemes) phonemizes through the backend its
checkpoint was trained with. The port runs on CUDA unless --device names
another device.
"""

from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Synthesize speech from text")
    p.add_argument("text", help="text, or path to a file with one sentence per line")
    p.add_argument("config_path")
    p.add_argument("checkpoint_path")
    p.add_argument("out_path")
    p.add_argument("--vocoder_config", default=None)
    p.add_argument("--vocoder_checkpoint", default=None)
    p.add_argument("--speaker_id", default=None, help="speaker name or id")
    p.add_argument("--speakers_json", default=None)
    p.add_argument("--style_wav", default=None, help="GST models: a reference wav for style")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from ..infer.synthesizer import Synthesizer

    synth = Synthesizer(args.config_path, args.checkpoint_path,
                        vocoder_config=args.vocoder_config,
                        vocoder_checkpoint=args.vocoder_checkpoint, device=args.device,
                        speakers_json=args.speakers_json)
    if os.path.isfile(args.text):
        with open(args.text, encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
    else:
        texts = [args.text]
    os.makedirs(args.out_path, exist_ok=True)
    style = synth.ap.load_wav(args.style_wav) if args.style_wav else None
    wavs = synth.tts_many(texts, [args.speaker_id] * len(texts), style_wav=style)
    for i, (text, wav) in enumerate(zip(texts, wavs)):
        out = os.path.join(args.out_path, f"out_{i:03d}.wav")
        synth.ap.save_wav(wav, out)
        print(f" > {out}  ({len(wav) / synth.ap.sample_rate:.2f}s)  <- {text[:60]!r}")


if __name__ == "__main__":
    main()
