"""device_idle.synth (%): the share of the window in which no kernel ran on
the card (the union of the kernels' intervals, from the trace). Moves
audio_s_per_s."""


def read(ctx):
    t = ctx.trace
    if not t["kernels"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
