"""The port's MicroBatcher (your_voice_tts_torch/infer/batching.py), held to
the JAX package's seven cases (tests/test_batching.py): host-only threading
logic, no device work.

The server-level integration (concurrent HTTP requests coalescing into one
batched synthesis call) lives in tests/test_torch_server.py."""

import threading
import time

import pytest

from your_voice_tts_torch.infer.batching import MicroBatcher


def _concurrent_submit(batcher, items, timeout=30.0):
    results = [None] * len(items)
    errors = [None] * len(items)

    def worker(k):
        try:
            results[k] = batcher.submit(items[k], timeout=timeout)
        except Exception as e:  # noqa: BLE001 — recorded for assertions
            errors[k] = e

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    return results, errors


def test_coalesces_concurrent_requests():
    seen = []

    def batch_fn(items):
        seen.append(list(items))
        time.sleep(0.05)  # hold the collator so later submits pile up
        return [x * 10 for x in items]

    b = MicroBatcher(batch_fn, max_batch=8, max_delay_ms=100.0)
    try:
        results, errors = _concurrent_submit(b, list(range(12)))
        assert errors == [None] * 12
        assert results == [x * 10 for x in range(12)]
        # every item went through exactly once...
        assert sorted(x for batch in seen for x in batch) == list(range(12))
        # ...and the 12 near-simultaneous requests shared batches
        assert max(b.batch_sizes) > 1
        assert len(b.batch_sizes) < 12
    finally:
        b.close()


def test_respects_max_batch():
    def batch_fn(items):
        time.sleep(0.03)
        return items

    b = MicroBatcher(batch_fn, max_batch=3, max_delay_ms=200.0)
    try:
        _, errors = _concurrent_submit(b, list(range(10)))
        assert errors == [None] * 10
        assert max(b.batch_sizes) <= 3
    finally:
        b.close()


def test_single_request_does_not_wait_max_batch():
    b = MicroBatcher(lambda items: items, max_batch=64, max_delay_ms=50.0)
    try:
        t0 = time.monotonic()
        assert b.submit("x") == "x"
        # one lone request pays at most the collation window, never blocks
        # for max_batch peers that will never come
        assert time.monotonic() - t0 < 5.0
        assert b.batch_sizes == [1]
    finally:
        b.close()


def test_batch_exception_fans_out_to_all_callers():
    def batch_fn(items):
        raise ValueError("device on fire")

    b = MicroBatcher(batch_fn, max_batch=4, max_delay_ms=50.0)
    try:
        results, errors = _concurrent_submit(b, [1, 2, 3])
        assert results == [None, None, None]
        assert all(isinstance(e, ValueError) for e in errors)
        # the batcher survives a failed batch and keeps serving
        def ok_fn(items):
            return items
        b._batch_fn = ok_fn
        assert b.submit(42) == 42
    finally:
        b.close()


def test_per_item_exception_isolation():
    def batch_fn(items):
        return [ValueError(f"bad {x}") if x < 0 else x for x in items]

    b = MicroBatcher(batch_fn, max_batch=8, max_delay_ms=100.0)
    try:
        results, errors = _concurrent_submit(b, [1, -2, 3])
        assert results[0] == 1 and results[2] == 3
        assert isinstance(errors[1], ValueError) and errors[0] is None
    finally:
        b.close()


def test_result_count_mismatch_is_an_error():
    b = MicroBatcher(lambda items: items[:-1] if len(items) else [],
                     max_batch=1, max_delay_ms=0.0)
    try:
        with pytest.raises(RuntimeError, match="returned 0 results"):
            b.submit("x", timeout=10.0)
    finally:
        b.close()


def test_close_rejects_new_submits():
    b = MicroBatcher(lambda items: items, max_batch=2, max_delay_ms=10.0)
    assert b.submit("a") == "a"
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("b")
    b.close()  # idempotent
