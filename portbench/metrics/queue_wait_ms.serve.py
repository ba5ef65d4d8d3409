"""queue_wait_ms.serve (ms): the median wait of a request in the serving
batcher, from its submit to the start of the batch call that carries it
(the benchmark's wrapper of the batch function): a call ahead of it.
Moves audio_s_per_s: a shorter call is a shorter wait and a higher rate."""

import statistics


def read(ctx):
    submits = ctx.result.get("submits")
    if not submits:
        return None
    w0, w1 = ctx.result["window"]
    waits = [(t - submits[text]) * 1e3 for t, texts in ctx.result["calls"] if w0 <= t <= w1
             for text in texts if text in submits]
    return statistics.median(waits) if waits else None
