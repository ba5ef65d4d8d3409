"""Server CLI (the JAX package's bin/server.py).

python -m your_voice_tts_torch.bin.server --tts_config config.json \
    [--tts_checkpoint checkpoint.npz] [--vocoder_config voc.json
    [--vocoder_checkpoint voc.npz]] [--speakers_json speakers.json]
    [--host 0.0.0.0] [--port 5002] [--max_batch 8] [--max_delay_ms 25]
    [--device cpu]
python -m your_voice_tts_torch.bin.server --export_dir exported/ [--device cpu] ...

Serves GET /api/tts?text=... (micro-batched) and
GET /api/tts?text=...&stream=1 (chunked, one audio chunk a text piece) on
CUDA unless --device names another device. With --export_dir it serves the
artifacts of bin/export_serving.py (ExportedSynthesizer, no model code) on
the device they were exported on (--device, if given, must name it);
/api/tts micro-batches through one program call, and stream=1 answers 400.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="TTS HTTP server")
    p.add_argument("--tts_config", default=None)
    p.add_argument("--export_dir", default=None,
                   help="serve from an export_serving artifact directory "
                        "instead of a config+checkpoint")
    p.add_argument("--tts_checkpoint", default=None)
    p.add_argument("--vocoder_config", default=None)
    p.add_argument("--vocoder_checkpoint", default=None)
    p.add_argument("--speakers_json", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5002)
    p.add_argument("--max_batch", type=int, default=8,
                   help="dynamic micro-batching: max concurrent requests "
                        "coalesced into one device batch (1 disables)")
    p.add_argument("--max_delay_ms", type=float, default=25.0,
                   help="how long to hold the first request for batchmates")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    if (args.export_dir is None) == (args.tts_config is None):
        p.error("pass exactly one of --tts_config or --export_dir")

    from ..infer.server import make_server

    if args.export_dir is not None:
        from ..infer.export import ExportedSynthesizer

        synth = ExportedSynthesizer(args.export_dir, device=args.device)
    else:
        from ..infer.synthesizer import Synthesizer

        synth = Synthesizer(args.tts_config, args.tts_checkpoint,
                            vocoder_config=args.vocoder_config,
                            vocoder_checkpoint=args.vocoder_checkpoint,
                            speakers_json=args.speakers_json, device=args.device)
    server = make_server(synth, args.host, args.port, max_batch=args.max_batch,
                         max_delay_ms=args.max_delay_ms)
    host, port = server.server_address[:2]
    print(f" > Serving on http://{host}:{port}  (GET /api/tts?text=...)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.batcher.close()
        server.server_close()


if __name__ == "__main__":
    main()
