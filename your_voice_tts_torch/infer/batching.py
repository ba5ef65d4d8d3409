"""Dynamic request micro-batching for serving (the JAX package's
infer/batching.py; host-side glue, stdlib threading only).

A server that handled one request at a time would run concurrent users as
batch-1 syntheses one after another. The decode's cost on the card is
nearly flat in batch (a step is a chain of small dependent products), so N
concurrent requests cost about one request of wall time when they ride one
batched call.

`MicroBatcher` is the collator that makes that happen: callers block in
`submit()` while a single collator thread gathers concurrent requests into
one list (up to `max_batch`, waiting at most `max_delay_ms` after the first
arrival) and hands them to `batch_fn` in one call. Results (or the
exception) fan back out to the waiting callers. The batched device work it
feeds is `Synthesizer.tts_many` (`infer.synthesis.synthesis_batch`).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence


class MicroBatcher:
    """Coalesce concurrent `submit(item)` calls into `batch_fn(items)`.

    batch_fn: called with a list of 1..max_batch items on the collator
        thread; must return one result per item, in order. If it raises,
        every caller in that batch sees the exception. A returned result
        that IS an Exception instance is raised only in its own caller —
        per-item error isolation inside a shared batch.
    max_batch: largest batch handed to batch_fn.
    max_delay_ms: how long the collator waits for more requests after the
        first one arrives. 0 batches only what is already queued.
    """

    def __init__(self, batch_fn: Callable[[list], Sequence],
                 max_batch: int = 8, max_delay_ms: float = 25.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._batch_fn = batch_fn
        self._max_batch = int(max_batch)
        self._max_delay_s = max(0.0, float(max_delay_ms)) / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._collate, daemon=True,
                                        name="microbatcher")
        self.batch_sizes: list[int] = []  # observability: size of each batch
        self._thread.start()

    # --- caller side ------------------------------------------------------

    def submit(self, item, timeout: float | None = None):
        """Block until `item`'s result is ready and return it."""
        if self._closed.is_set():
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._queue.put((item, fut))
        # close() may have drained the queue between the check above and the
        # put: if the batcher is now closed and nobody claimed the future,
        # cancel it ourselves instead of blocking forever
        if self._closed.is_set() and fut.cancel():
            raise RuntimeError("MicroBatcher is closed")
        return fut.result(timeout=timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the collator; pending submits fail with CancelledError."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._queue.put(None)  # wake the collator
        self._thread.join(timeout=timeout)
        while True:  # fail anything still queued
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                break
            if entry is not None:
                entry[1].cancel()

    # --- collator thread ----------------------------------------------------

    def _collate(self) -> None:
        while not self._closed.is_set():
            entry = self._queue.get()  # block for the first request
            if entry is None:
                continue
            batch = [entry]
            deadline = time.monotonic() + self._max_delay_s
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                try:
                    nxt = (self._queue.get_nowait() if remaining <= 0
                           else self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            items = [it for it, _ in batch]
            futs = [f for _, f in batch]
            self.batch_sizes.append(len(items))
            if len(self.batch_sizes) > 4096:  # bounded observability buffer
                del self.batch_sizes[:2048]
            try:
                results = self._batch_fn(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(items)} items")
            except Exception as e:  # noqa: BLE001 — fan the error out
                for f in futs:
                    if not f.cancelled():
                        f.set_exception(e)
                continue
            for f, r in zip(futs, results):
                if f.cancelled():
                    continue
                if isinstance(r, Exception):
                    f.set_exception(r)
                else:
                    f.set_result(r)
