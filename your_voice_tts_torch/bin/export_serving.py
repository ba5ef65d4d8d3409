"""Export the end-to-end serving program as torch.export artifacts (the JAX
package's bin/export_serving.py).

python -m your_voice_tts_torch.bin.export_serving --config cfg.json \
    --checkpoint ckpt.npz --out exported/ [--batch 1 8] [--text_bucket 128] \
    [--max_decoder_steps N] [--vocoder_config voc.json --vocoder_checkpoint \
    voc.npz] [--speakers_json speakers.json] [--speaker_encoder_checkpoint \
    se.npz --se_num_frames 160] [--style_frames F] [--device cpu]

Writes one artifact per (batch, text bucket) shape and a manifest
(infer/export.py). Serve them with ExportedSynthesizer(out_dir) or
`bin/server.py --export_dir`: no model code or checkpoint at serving time.
The checkpoints are JAX-package `.npz` files, loaded through the
Synthesizer. The artifacts are exported on CUDA, where they carry the
hand-written kernels and serve on CUDA only, unless --device names another
device (`cpu`: the kernels' plain versions).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Export the serving program")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, nargs="+", default=[1])
    p.add_argument("--text_bucket", type=int, nargs="+", default=[128])
    p.add_argument("--max_decoder_steps", type=int, default=None)
    p.add_argument("--vocoder_config", default=None,
                   help="bake a MelGAN/PWGAN generator in place of Griffin-Lim")
    p.add_argument("--vocoder_checkpoint", default=None)
    p.add_argument("--speakers_json", default=None,
                   help="multi-speaker export: adds a speaker input (d-vectors if the json "
                        "carries embeddings, ids otherwise) and records the table in the "
                        "manifest")
    p.add_argument("--speaker_encoder_checkpoint", default=None,
                   help="also export the GE2E encoder (mel windows -> d-vectors) into the "
                        "same directory, so that cloning serves from artifacts alone")
    p.add_argument("--se_num_frames", type=int, default=160)
    p.add_argument("--style_frames", type=int, default=None,
                   help="GST models: add a style-reference mel input of this many frames")
    p.add_argument("--device", default=None,
                   help="torch device to export on (default: cuda, whose artifacts carry "
                        "the kernels)")
    args = p.parse_args(argv)

    from ..infer.export import export_serving
    from ..infer.synthesizer import Synthesizer

    synth = Synthesizer(args.config, args.checkpoint, vocoder_config=args.vocoder_config,
                        vocoder_checkpoint=args.vocoder_checkpoint,
                        speakers_json=args.speakers_json, device=args.device)
    speaker_mode = d_dim = speakers = None
    if synth.speaker_embeddings:
        speaker_mode, speakers = "dvector", synth.speaker_embeddings
        d_dim = len(next(iter(speakers.values())))
    elif synth.speaker_ids:
        speaker_mode, speakers = "id", synth.speaker_ids
    manifest = export_serving(
        synth.model, synth.cfg, synth.ap, args.out, batch_sizes=tuple(args.batch),
        text_buckets=tuple(args.text_bucket), max_decoder_steps=args.max_decoder_steps,
        vocoder=synth.vocoder, speaker_mode=speaker_mode, d_dim=d_dim, speakers=speakers,
        style_frames=args.style_frames, decode_dtype=synth.decode_dtype)
    print(f"exported {len(manifest['entries'])} artifact(s) to {args.out} "
          f"({manifest['platforms'][0]})")

    if args.speaker_encoder_checkpoint:
        from ..infer.export import export_speaker_encoder
        from ..speaker_encoder.model import load_encoder

        enc = load_encoder(args.speaker_encoder_checkpoint,
                           default_input_dim=synth.cfg.audio.num_mels, device=synth.device)
        se = export_speaker_encoder(enc, args.out, input_dim=enc.layers[0].lstm.input_size,
                                    num_frames=args.se_num_frames)
        print(f"exported speaker encoder ({len(se['entries'])} artifact(s))")


if __name__ == "__main__":
    main()
