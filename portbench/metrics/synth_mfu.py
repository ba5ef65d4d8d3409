"""synth_mfu (%): the whole synthesis as a share of the chip's peak: the
model operations of the window's calls, as the configuration's model and
vocoder plugs count them (for Tacotron2: encoder and key projection,
decode attention and postnet in float32 at 67 TFLOP/s, the decode's
products in bf16 at 989 TFLOP/s; Griffin-Lim's products in bf16, MelGAN
in float32), each at its rate's peak, over the window's length. Moves
audio_s_per_s."""

from portbench import counts


def read(ctx):
    if not ctx.calls or not ctx.trace["kernels"]:
        return None
    busy = 0.0
    for c in ctx.calls:
        f32, bf16 = (sum(x) for x in zip(*(p.flops(ctx.conf, c) for p in ctx.system.plugs)))
        busy += counts.ops_seconds(f32, bf16)
    return 100.0 * busy / ctx.trace["window_s"]
