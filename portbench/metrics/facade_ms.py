"""facade_ms (ms): the mean wall time of one `Synthesizer.tts_many` call
that starts in the window (its span). Moves audio_s_per_s."""


def read(ctx):
    spans = ctx.spans.get("tts_many")
    return sum(b - a for a, b in spans) / len(spans) * 1e3 if spans else None
