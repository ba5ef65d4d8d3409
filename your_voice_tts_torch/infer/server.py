"""HTTP synthesis server (the JAX package's infer/server.py), on stdlib
http.server: GET / (a demo page) and GET /api/tts?text=...[&speaker_id=...]
answering audio/wav.

Concurrent /api/tts requests are coalesced by a `MicroBatcher` into one
batched call (`Synthesizer.tts_many`), so N simultaneous users pay about one
request of decode plus the collation window instead of N decodes one after
another.

`/api/tts?text=...&stream=1` serves chunked audio through
`Synthesizer.tts_streaming` (decoder state carried across text chunks by
`Tacotron2.inference_truncated`): the client hears the first sentence while
later ones are still decoding, so the time to the first audio is one
chunk's decode, not the whole text's. Streaming runs on the request's own
thread beside the batcher's collator; the Synthesizer's lock keeps their
device work apart.

An `ExportedSynthesizer` (infer/export.py) serves the same way through its
`tts_many`; having no `tts_streaming`, it answers stream=1 with 400. This
module imports no model code, so that an artifact serves without it.
"""

from __future__ import annotations

import html
import json
import struct
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING

import numpy as np

from .batching import MicroBatcher

if TYPE_CHECKING:
    from .synthesizer import Synthesizer


def _wav_stream_header(sample_rate: int) -> bytes:
    """A 16-bit mono WAV header with the unknown-length sentinel sizes
    (0xFFFFFFFF) used by live-streaming WAV emitters; players read PCM
    until the connection closes."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt " +
            struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2,
                        2, 16) +
            b"data" + struct.pack("<I", 0xFFFFFFFF))


def _pcm16(wav: np.ndarray) -> bytes:
    """float chunk -> 16-bit PCM at fixed gain (per-chunk peak normalization
    would pump the loudness between chunks of one utterance)."""
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


_INDEX_HTML = """<!DOCTYPE html>
<html><head><title>your-voice TTS (PyTorch)</title><style>
body { font-family: sans-serif; margin: 3em auto; max-width: 40em; }
input { width: 100%; padding: .5em; font-size: 1em; }
button { margin-top: .75em; padding: .5em 1.5em; }
</style></head><body>
<h2>your-voice TTS &mdash; PyTorch</h2>
<input id="text" placeholder="Type a sentence..." value="Hello, this is a test.">
<button onclick="speak()">Speak</button>
<p><audio id="audio" controls></audio></p>
<script>
function speak() {
  const t = document.getElementById('text').value;
  const a = document.getElementById('audio');
  a.src = '/api/tts?text=' + encodeURIComponent(t);
  a.play();
}
</script></body></html>"""


def _error(message: str) -> bytes:
    return json.dumps({"error": html.escape(message)}).encode()


class TTSHandler(BaseHTTPRequestHandler):
    synthesizer: Synthesizer = None  # set by make_server
    batcher: MicroBatcher = None
    # chunked transfer framing (`_stream_tts`) is an HTTP/1.1 feature: under
    # the stdlib default ("HTTP/1.0") real clients would read the chunk-size
    # lines as BODY bytes — framing garbage spliced into the audio. 1.1 also
    # enables keep-alive (every non-stream response carries Content-Length).
    protocol_version = "HTTP/1.1"
    timeout = 120  # reap keep-alive handler threads whose client went quiet

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/":
            self._send(200, "text/html; charset=utf-8", _INDEX_HTML.encode())
            return
        if parsed.path == "/api/tts":
            qs = urllib.parse.parse_qs(parsed.query)
            text = (qs.get("text") or [""])[0].strip()
            if not text:
                self._send(400, "application/json", _error("missing text parameter"))
                return
            speaker = (qs.get("speaker_id") or [None])[0]
            if (qs.get("stream") or ["0"])[0] not in ("0", ""):
                self._stream_tts(text, speaker)
                return
            try:
                wav = self.batcher.submit((text, speaker))
            except Exception as e:  # noqa: BLE001 — errors as JSON, keep serving
                self._send(500, "application/json", _error(str(e)))
                return
            self._send(200, "audio/wav", wav)
            return
        self._send(404, "application/json", b'{"error": "not found"}')

    def _stream_tts(self, text: str, speaker) -> None:
        """Chunked audio/wav from tts_streaming: the streaming WAV header,
        then one PCM chunk a text piece. The first piece is synthesized
        before the status line, so a bad speaker or a failed synthesis still
        answers a clean 500. Streaming bypasses the micro-batcher (it is a
        latency play, not a throughput one)."""
        gen = getattr(self.synthesizer, "tts_streaming", None)
        if gen is None:
            self._send(400, "application/json", _error("this server cannot stream; "
                                                       "drop stream=1"))
            return

        def chunk(b: bytes) -> None:
            self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

        try:
            it = gen(text, speaker=speaker)
            first = _pcm16(next(it))
        except StopIteration:
            first = b""
        except Exception as e:  # noqa: BLE001
            self._send(500, "application/json", _error(str(e)))
            return
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            chunk(_wav_stream_header(self.synthesizer.ap.sample_rate))
            if first:
                chunk(first)
            for wav in it:
                pcm = _pcm16(wav)
                if pcm:                  # a zero-size chunk would end the body
                    chunk(pcm)
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up mid-stream; nothing to salvage


def _batch_fn(synthesizer):
    """(text, speaker) items -> WAV bytes, batched through `tts_many` where
    the synthesizer has it, else one `tts_to_wav_bytes(text, speaker=)` an
    item.

    Returns an Exception object in an item's slot for per-request errors
    (bad speaker name, one failed item) so one bad request 500s alone
    instead of poisoning every request sharing its micro-batch."""
    def run(items: list) -> list:
        if not hasattr(synthesizer, "tts_many"):
            out = []
            for t, s in items:
                try:
                    out.append(synthesizer.tts_to_wav_bytes(t, speaker=s))
                except Exception as e:  # noqa: BLE001 — isolate per item
                    out.append(e)
            return out
        out: list = [None] * len(items)
        ok: list[int] = []
        for k, (_, speaker) in enumerate(items):
            try:  # reject bad speakers per request, before the shared batch
                synthesizer._resolve_speaker(speaker)
                ok.append(k)
            except Exception as e:  # noqa: BLE001
                out[k] = e
        if ok:
            try:
                wavs = synthesizer.tts_many([items[k][0] for k in ok],
                                            [items[k][1] for k in ok])
                for k, w in zip(ok, wavs):
                    out[k] = synthesizer.encode_wav_bytes(w)
            except Exception as e:  # noqa: BLE001 — batch-wide failure
                for k in ok:
                    out[k] = e
        return out
    return run


def make_server(synthesizer: Synthesizer, host: str = "0.0.0.0",
                port: int = 5002, max_batch: int = 8,
                max_delay_ms: float = 25.0) -> ThreadingHTTPServer:
    """ThreadingHTTPServer whose /api/tts requests coalesce through a
    MicroBatcher (its batches run on its single collator thread).
    `max_batch=1` disables coalescing. The server's `batcher` attribute is
    there to be closed on shutdown."""
    batcher = MicroBatcher(_batch_fn(synthesizer), max_batch=max_batch,
                           max_delay_ms=max_delay_ms)
    handler = type("BoundTTSHandler", (TTSHandler,), {
        "synthesizer": synthesizer, "batcher": batcher})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.batcher = batcher
    return srv
