"""batch_rows.serve (rows): the serving batcher's mean batch size over the
window, read from its own counter (`MicroBatcher.batch_sizes`, one entry a
call). Moves audio_s_per_s: a full batch carries the most audio a call."""


def read(ctx):
    sizes = ctx.result.get("batch_sizes")
    return sum(sizes) / len(sizes) if sizes else None
