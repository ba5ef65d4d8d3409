"""Offline synthesis: `tts_many` called back to back from one thread with
`batch` sentences a call, as a batch job voicing a book runs it.

The window opens at the first call and closes at the end of the first call
that ends past `seconds`, so that it holds whole calls; the end-to-end
rate is all their audio over all that time."""

from __future__ import annotations

import time


def _texts(pool: list[str], k: int, batch: int) -> list[str]:
    if (k + 2) * batch > len(pool):
        raise RuntimeError("the pool holds too few sentences for this window")
    return pool[k * batch:(k + 1) * batch]


def warm(system, pool: list[str], mix: dict) -> None:
    """One full call of the cell's own shape, on the pool's last sentences."""
    system.synth.tts_many(pool[-mix["batch"]:])


def measure(system, pool: list[str], mix: dict, seconds: float) -> dict:
    system.window_start()
    w0 = time.perf_counter()
    completed, audio, k, answers = [], 0.0, 0, {}
    while True:
        texts = _texts(pool, k, mix["batch"])
        k += 1
        t0 = time.perf_counter()
        wavs = system.synth.tts_many(texts)
        t1 = time.perf_counter()
        audio += sum(len(w) for w in wavs) / system.sample_rate
        completed += [(t0, t1, t) for t in texts]
        answers.update((t, w) for t, w in zip(texts, wavs) if t in system.capture.rows)
        if t1 - w0 >= seconds:
            break
    return {
        "end_to_end": {"audio_s_per_s": audio / (t1 - w0)},
        "window_s": t1 - w0,
        "window": (w0, t1),
        "attempted": len(completed),
        "failed": 0,
        "completed": completed,
        "answers": answers,
        "diagnostic": f"{k} calls in {t1 - w0:.3f} s",
    }
