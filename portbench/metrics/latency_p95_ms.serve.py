"""latency_p95_ms.serve (ms): the 95th percentile of the latency of every
request answered in the window, from its enqueue to its WAV bytes (the
driver's host clock). A closed loop that always holds a batch queued runs
at capacity, where the tail follows the rate and swings with the host, so
it stands here beside the rate it follows and is no end-to-end metric; in
the traced run the profiler slows every call. Moves audio_s_per_s."""

from portbench.harness import percentile


def read(ctx):
    lat = ctx.result.get("latencies_ms")
    return percentile(lat, 95) if lat else None
