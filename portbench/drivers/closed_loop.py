"""Closed-loop serving: `clients` clients, each sending its next sentence as
soon as its last one is answered, through the serving batcher
(`MicroBatcher` over the server's batch function, in process, no socket).
With more clients than `max_batch`, the next batch is queued before the
current call ends, as on a loaded server.

A client is a chain of futures, not a thread: it enqueues its request as
`MicroBatcher.submit` does (the item and a future on the batcher's queue,
`_queue`) and its next request goes in from the answer's callback, which
runs on the collator thread as the batch's results fan out. So the batcher
always finds the next batch waiting, and the window measures the
synthesizer, not 64 threads waking up and taking the interpreter lock from
it. The cost: the timed entry is a copy of `submit`'s body beside the
port's own, so a change to `submit` itself does not reach this window.

The window opens at the first request; a request counts when it is
answered inside the window, its latency from its enqueue to its answer,
its audio read from its WAV bytes. The end-to-end metric: all the audio
answered in the window over its length. The clients keep the batcher at
capacity, so the latencies' tail follows that rate and is a per-layer
metric (metrics/latency_p95_ms.serve.py)."""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future


def warm(system, pool: list[str], mix: dict) -> None:
    """One full batch of the cell's own shape, through the batch function."""
    system.batch_fn([(t, None) for t in pool[-mix["max_batch"]:]])


def measure(system, pool: list[str], mix: dict, seconds: float) -> dict:
    from your_voice_tts_torch.infer.batching import MicroBatcher

    calls: list[tuple[float, list[str]]] = []     # (start, texts) of each batch call

    def batch_fn(items):
        calls.append((time.perf_counter(), [t for t, _ in items]))
        return system.batch_fn(items)

    batcher = MicroBatcher(batch_fn, max_batch=mix["max_batch"], max_delay_ms=mix["max_delay_ms"])
    n = mix["clients"]
    done: list[tuple] = []                        # (enqueue, answer, text, audio s)
    answers: dict[str, bytes] = {}                # the bytes of the rows the check keeps
    submits: dict[str, float] = {}
    failed, live, overflow = [0], [n], [False]
    finished = threading.Event()
    window = {}

    def send(i: int, k: int):
        t0 = time.perf_counter()
        short = i + n * k >= len(pool) - mix["max_batch"]   # the warm-up's own sentences
        overflow[0] |= short
        if t0 >= window["end"] or short:
            live[0] -= 1
            if live[0] == 0:
                finished.set()
            return
        text = pool[i + n * k]
        submits[text] = t0
        fut: Future = Future()
        fut.add_done_callback(lambda f: answer(f, i, k, t0, text))
        batcher._queue.put(((text, None), fut))

    def answer(f: Future, i: int, k: int, t0: float, text: str):
        t1 = time.perf_counter()
        if f.cancelled() or f.exception() is not None:
            failed[0] += 1
        else:
            wav = f.result()
            done.append((t0, t1, text, system.audio_seconds(wav)))
            if text in system.capture.rows:
                answers[text] = wav
        send(i, k + 1)

    batches0 = len(batcher.batch_sizes)
    system.window_start()
    window["start"] = time.perf_counter()
    window["end"] = window["start"] + seconds
    for i in range(n):
        send(i, 0)
    finished.wait(seconds + 600)
    batcher.close()
    if overflow[0]:
        raise RuntimeError("the pool holds too few sentences for this window")
    w0, w1 = window["start"], window["end"]
    inside = [r for r in done if r[1] <= w1]
    in_calls = [c for c in calls if w0 <= c[0] <= w1]
    sizes = batcher.batch_sizes[batches0:]
    latencies = [(t1 - t0) * 1e3 for t0, t1, *_ in inside]
    return {
        "end_to_end": {"audio_s_per_s": sum(a for *_, a in inside) / seconds},
        "latencies_ms": latencies,
        "window_s": seconds,
        "window": (w0, w1),
        "attempted": len(done) + failed[0],
        "failed": failed[0],
        "completed": [(t0, t1, text) for t0, t1, text, _ in inside],
        "answers": answers,
        "batch_sizes": sizes[:len(in_calls)],
        "calls": in_calls,
        "submits": submits,
        "diagnostic": f"{len(in_calls)} batch calls, {len(inside)} answers in the window; "
                      "calls a tenth of it " + " ".join(
                          str(sum(1 for t, _ in in_calls if w0 + q * (w1 - w0) / 10 <= t
                                  < w0 + (q + 1) * (w1 - w0) / 10)) for q in range(10)),
    }
