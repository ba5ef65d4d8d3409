"""decode_roofline (%): kernel 1, the Tacotron2 decode (csrc/taco2_decode.cu
`decode_kernel`), as a share of its roofline: the least time the window's
decodes need (counts.decode: bf16 products at 989 TFLOP/s, the attention's
float32 work at 67 TFLOP/s, weights once a call and inputs and outputs once
at 3.35 TB/s; operations bind at full width) over the device time of the
window's decode kernels. Moves audio_s_per_s."""

from portbench import counts


def read(ctx):
    spent = ctx.kernel_seconds("decode_kernel")
    if not spent or not ctx.calls:
        return None
    need = 0.0
    for c in ctx.calls:
        n = counts.decode(ctx.conf["tts"], c)
        need += counts.seconds(n["f32_flops"], n["bf16_flops"], n["bytes"])
    return 100.0 * need / spent
