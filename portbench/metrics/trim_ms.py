"""trim_ms (ms): host time in `AudioProcessor.find_endpoint` (the silence
trimming, a Python loop a row), summed over a `tts_many` call, mean over
the window's calls. Moves audio_s_per_s."""


def read(ctx):
    calls, trims = ctx.spans.get("tts_many"), ctx.spans.get("find_endpoint")
    if not calls or not trims:
        return None
    total = sum(b - a for a, b in trims if any(c0 <= a <= c1 for c0, c1 in calls))
    return total / len(calls) * 1e3
