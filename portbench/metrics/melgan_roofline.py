"""melgan_roofline (%): the MelGAN generator (vocoder/models/melgan.py, cuDNN
float32 convolutions, TF32 off) as a share of its roofline: the least time
the window's rows need (counts.melgan: its convolutions' float32 operations
at 67 TFLOP/s, weights, mel and waveform once at 3.35 TB/s; operations
bind) over the device time under the window's `mel_to_wav` spans. Moves
audio_s_per_s."""

from portbench import counts


def read(ctx):
    voc = ctx.conf.get("vocoder")
    spent = ctx.span_device_seconds("mel_to_wav")
    if not voc or not spent or not ctx.calls:
        return None
    nm = ctx.conf["tts"]["audio"]["num_mels"]
    need = 0.0
    for c in ctx.calls:
        for f in c["frames"]:
            n = counts.melgan(voc["melgan"], f, nm)
            need += counts.seconds(n["f32_flops"], n["bf16_flops"], n["bytes"])
    return 100.0 * need / spent
