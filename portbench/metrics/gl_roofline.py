"""gl_roofline (%): Griffin-Lim's kernels (csrc/griffin_lim.cu, the `fgla_`
kernels of kernel 2's route) as a share of their roofline: the least time
the window's inversions need (counts.griffin_lim: 2 n + 1 bf16 products of
[frames, n_fft] by [n_fft, n_fft] a launch at 989 TFLOP/s, magnitudes,
phase, constants and waveforms once at 3.35 TB/s; operations bind) over
the device time of the window's `fgla_` kernels. Moves audio_s_per_s."""

from portbench import counts


def read(ctx):
    spent = ctx.kernel_seconds("fgla_")
    if not spent or not ctx.calls:
        return None
    need = 0.0
    for c in ctx.calls:
        n = counts.griffin_lim(ctx.conf["tts"]["audio"], c)
        need += counts.seconds(n["f32_flops"], n["bf16_flops"], n["bytes"])
    return 100.0 * need / spent
