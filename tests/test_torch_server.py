"""The port's HTTP server (your_voice_tts_torch/infer/server.py) on the CPU
with the smoke config, driven over real sockets, modelled on the JAX
package's server tests (tests/test_synthesis.py): the routes and their
errors, the micro-batched /api/tts route, the chunked stream=1 route with
its pieces cut by the JAX package's rule, per-request speaker errors, a
stream and a batch served at once, and bin/server.py."""

import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request
import wave

import numpy as np
import pytest
import torch

from your_voice_tts_tpu.infer.synthesizer import split_into_sentences as jax_split
from your_voice_tts_torch.bin import server as server_cli
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.infer.server import _batch_fn, _wav_stream_header, make_server
from your_voice_tts_torch.infer.synthesizer import Synthesizer, stream_pieces

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG, CKPT = "configs/smoke_synthetic.json", "assets/bench_trained_smoke.npz"
MELGAN = ("configs/melgan_smoke.json", "assets/bench_trained_melgan.npz")
SPK_JSON, MULTI_CKPT = "assets/speakers_smoke.json", "assets/bench_trained_multispeaker.npz"
LONG = ("the rain in the hills fell for three days and three nights, and the river rose "
        "over its banks until the old bridge at the mill could no longer be crossed by anyone.")
STREAM_TEXT = "One sentence. And another one! " + LONG


def smoke(**model):
    cfg = load_config(CONFIG)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **dict(dict(max_decoder_steps=24), **model)))


def serve(synth, **kw):
    """(base URL, server) of make_server on a free local port, serving on a
    daemon thread."""
    srv = make_server(synth, host="127.0.0.1", port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}", srv


def stop(srv):
    srv.shutdown()
    srv.batcher.close()
    srv.server_close()


def get(url):
    """(status, content type, body), errors included."""
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def tts_url(base, text, **params):
    return f"{base}/api/tts?" + urllib.parse.urlencode(dict(text=text, **params))


def stream_raw(base, text, **params):
    """The raw response to a stream=1 request, read off the socket: (status
    line and headers, the chunks of the chunked body in order)."""
    port = int(base.rsplit(":", 1)[1])
    path = tts_url("", text, stream=1, **params)
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        raw = b""
        while not raw.endswith(b"0\r\n\r\n"):
            got = s.recv(65536)
            if not got:
                break
            raw += got
    head, _, body = raw.partition(b"\r\n\r\n")
    chunks = []
    while body and not body.startswith(b"0\r\n"):
        size, _, body = body.partition(b"\r\n")
        n = int(size, 16)
        chunks.append(body[:n])
        assert body[n:n + 2] == b"\r\n"
        body = body[n + 2:]
    return head.decode(), chunks


def head_without_date(head):
    """A response head as (status line, {header: value}) without `Date`,
    which BaseHTTPRequestHandler stamps with the current second."""
    status, *lines = head.split("\r\n")
    fields = dict(line.split(": ", 1) for line in lines)
    fields.pop("Date")
    return status, fields


def concurrently(fns):
    """Run the callables at once on threads; their results in order."""
    out = [None] * len(fns)

    def run(k):
        out[k] = fns[k]()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return out


@pytest.fixture(scope="module")
def gl():
    """(base URL, server, Synthesizer): the trained smoke checkpoint through
    Griffin-Lim, a wide collation window so that a burst coalesces."""
    synth = Synthesizer(smoke(), CKPT, device="cpu")
    base, srv = serve(synth, max_batch=8, max_delay_ms=400.0)
    yield base, srv, synth
    stop(srv)


@pytest.fixture(scope="module")
def spk():
    """The same with the trained multi-speaker asset and its d-vectors."""
    synth = Synthesizer(smoke(), MULTI_CKPT, speakers_json=SPK_JSON, device="cpu")
    base, srv = serve(synth, max_batch=8, max_delay_ms=400.0)
    yield base, srv, synth
    stop(srv)


def test_index(gl):
    status, ctype, body = get(gl[0] + "/")
    assert status == 200 and ctype.startswith("text/html")
    assert b"api/tts" in body and b"{{" not in body and b"}}" not in body


def test_missing_text_is_400(gl):
    status, ctype, body = get(gl[0] + "/api/tts")
    assert status == 400 and ctype == "application/json"
    assert json.loads(body)["error"] == "missing text parameter"


def test_unknown_route_is_404(gl):
    status, ctype, body = get(gl[0] + "/nope")
    assert status == 404 and json.loads(body)["error"] == "not found"


def test_tts_route_answers_a_wav(gl):
    status, ctype, body = get(tts_url(gl[0], "hello server"))
    assert status == 200 and ctype == "audio/wav"
    with wave.open(io.BytesIO(body)) as f:
        assert f.getframerate() == 8000 and f.getsampwidth() == 2 and f.getnframes() > 0


def jax_pieces(text, chunk_chars=120):
    """The JAX package's streaming pieces (infer/synthesizer.py
    tts_streaming): its sentences, hard-split every chunk_chars."""
    out = []
    for s in jax_split(text) or [text]:
        while len(s) > chunk_chars:
            out.append(s[:chunk_chars])
            s = s[chunk_chars:]
        out.append(s)
    return out


@pytest.mark.parametrize("chunk_chars", [120, 40, 7])
@pytest.mark.parametrize("text", [STREAM_TEXT, "no stop at all", "  ", "A.\n\nB? C!"])
def test_stream_pieces_follow_the_jax_rule(text, chunk_chars):
    assert stream_pieces(text, chunk_chars) == jax_pieces(text, chunk_chars)


def test_stream_route_is_chunked(gl):
    """stream=1: HTTP/1.1 chunked framing, no Content-Length; chunk 0 is the
    unknown-length WAV header, then one PCM chunk a piece (four: two
    sentences and a long one cut in two), each as long as tts_streaming's
    waveform of that piece."""
    base, _, synth = gl
    head, chunks = stream_raw(base, STREAM_TEXT)
    assert head.split("\r\n")[0].endswith("200 OK")
    assert "Transfer-Encoding: chunked" in head and "Content-Length" not in head
    assert chunks[0] == _wav_stream_header(8000)
    pieces = jax_pieces(STREAM_TEXT)
    assert len(pieces) == 4 and len(chunks) == 1 + len(pieces)
    solo = list(synth.tts_streaming(STREAM_TEXT))
    assert [len(c) for c in chunks[1:]] == [2 * len(w) for w in solo]
    pcm = np.frombuffer(b"".join(chunks[1:]), "<i2")
    assert np.abs(pcm).max() > 0


def test_stream_route_through_a_standard_client(gl):
    with urllib.request.urlopen(tts_url(gl[0], "One sentence. And more.", stream=1),
                                timeout=120) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
        body = r.read()
    assert body[:44] == _wav_stream_header(8000) and len(body) > 44


def test_concurrent_requests_coalesce(gl):
    base, srv, _ = gl
    texts = ["first voice line", "a second one", "third request", "and the fourth"]
    before = len(srv.batcher.batch_sizes)
    got = concurrently([lambda t=t: get(tts_url(base, t)) for t in texts])
    for status, ctype, body in got:
        assert status == 200 and ctype == "audio/wav" and body[:4] == b"RIFF"
    sizes = srv.batcher.batch_sizes[before:]
    assert max(sizes) > 1 and len(sizes) < len(texts)


def test_unknown_speaker_fails_alone(spk):
    """A bad speaker is refused before the shared batch: its request 500s,
    its batchmates are served."""
    base, srv, _ = spk
    before = len(srv.batcher.batch_sizes)
    got = concurrently([lambda s=s: get(tts_url(base, "hello there", speaker_id=s))
                        for s in ("SYN01", "SYN99", "SYN02")])
    assert [g[0] for g in got] == [200, 500, 200]
    assert "unknown speaker" in json.loads(got[1][2])["error"]
    assert got[0][2][:4] == b"RIFF" and got[2][2][:4] == b"RIFF"
    assert max(srv.batcher.batch_sizes[before:]) > 1


def test_stream_with_a_speaker(spk):
    head, chunks = stream_raw(spk[0], "Hi there. Bye now.", speaker_id="SYN03")
    assert head.startswith("HTTP/1.1 200") and len(chunks) == 3
    status, ctype, body = get(tts_url(spk[0], "Hi there.", stream=1, speaker_id="SYN99"))
    assert status == 500 and "unknown speaker" in json.loads(body)["error"]


def test_a_stream_and_a_batch_at_once_equal_their_solo_runs():
    """With a deterministic vocoder (MelGAN) a request's bytes do not depend
    on what else the server does: a stream and a /api/tts request served
    at once (the Synthesizer's lock keeps their device work apart) give
    the bytes each gives alone: the /api/tts response and every chunk of
    the stream byte for byte, and the stream's status line and headers but
    its `Date`, which names the second it was answered in."""
    synth = Synthesizer(smoke(), CKPT, vocoder_config=MELGAN[0], vocoder_checkpoint=MELGAN[1],
                        device="cpu")
    base, srv = serve(synth)
    try:
        batch = lambda: get(tts_url(base, "The quick brown fox."))  # noqa: E731
        def stream():
            head, chunks = stream_raw(base, STREAM_TEXT)
            return head_without_date(head), chunks

        solo = [batch(), stream()]
        for _ in range(2):
            assert concurrently([stream, batch])[::-1] == solo
    finally:
        stop(srv)


def test_tts_to_wav_bytes_takes_the_speaker(spk):
    """`tts_to_wav_bytes(text, speaker=)`, as `_batch_fn`'s per-item branch
    calls it for a synthesizer without tts_many."""
    synth = spk[2]
    with pytest.raises(ValueError, match="unknown speaker"):
        synth.tts_to_wav_bytes("Hi.", speaker="SYN99")
    assert synth.tts_to_wav_bytes("Hi.", speaker="SYN01")[:4] == b"RIFF"

    class OneAtATime:
        def __init__(self, inner):
            self.tts_to_wav_bytes = inner.tts_to_wav_bytes

    out = _batch_fn(OneAtATime(synth))([("Hi.", "SYN01"), ("Hi.", "SYN99")])
    assert out[0][:4] == b"RIFF" and isinstance(out[1], ValueError)


def test_streaming_without_inference_truncated_yields_one_tts():
    """Tacotron(1) has no inference_truncated: tts_streaming yields the
    whole text's `tts` waveform once."""
    cfg = smoke(model="Tacotron", memory_size=5, tacotron_width=32, attention_dim=24,
                max_decoder_steps=8)
    synth = Synthesizer(cfg, device="cpu")
    chunks = list(synth.tts_streaming("Hi. Yes."))
    assert len(chunks) == 1 and len(chunks[0]) == len(synth.tts("Hi. Yes."))


def test_server_cli_refuses_export_dir():
    """--export_dir serves an artifact directory (tests/test_torch_export.py);
    the CLI refuses one with no manifest, both sources at once, and
    neither."""
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        server_cli.main(["--export_dir", "exported"])
    with pytest.raises(SystemExit):
        server_cli.main(["--export_dir", "exported", "--tts_config", os.path.join(ROOT, CONFIG)])
    with pytest.raises(SystemExit):
        server_cli.main([])


def test_server_cli_refuses_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server_cli.main(["--tts_config", os.path.join(ROOT, CONFIG), "--port", "0"])


def test_server_cli_serves():
    """`python -m your_voice_tts_torch.bin.server ... --device cpu` prints
    its URL and answers /api/tts."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "your_voice_tts_torch.bin.server", "--tts_config", CONFIG,
         "--tts_checkpoint", CKPT, "--device", "cpu", "--host", "127.0.0.1", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        line = proc.stdout.readline()
        assert "Serving on http://127.0.0.1:" in line, proc.stderr.read()
        base = line.split()[3]
        status, ctype, body = get(tts_url(base, "Hi."))
        assert status == 200 and ctype == "audio/wav" and body[:4] == b"RIFF"
    finally:
        proc.kill()
        proc.communicate(timeout=60)
