"""The yardstick's arithmetic: the chip's peaks, and the operations and
bytes each layer of a synthesis call needs, from its shapes. The kernel
bounds follow the repository's kernel table (the chip script's
`decode_bound` and Griffin-Lim bounds): products at the bf16 rate, the
attention's location, energy and context work at the float32 rate; each
input read once and each output written once, the decode's weights once
a call. The time a layer's work needs at the peaks is the larger of its
operations' time and its bytes' time; a share of the roofline is that
time over the time measured."""

from __future__ import annotations

import math

# NVIDIA H100 SXM, dense, at its full 700 W power limit
PEAKS = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}


def ops_seconds(f32_flops: float = 0.0, bf16_flops: float = 0.0) -> float:
    """The operations' time at each precision's peak."""
    return bf16_flops / PEAKS["bf16_flops"] + f32_flops / PEAKS["f32_flops"]


def seconds(f32_flops: float = 0.0, bf16_flops: float = 0.0, nbytes: float = 0.0) -> float:
    """The least time: the larger of the operations' and the bytes' time."""
    return max(ops_seconds(f32_flops, bf16_flops), nbytes / PEAKS["hbm_bytes"])


def dims(tts: dict) -> dict:
    r_init = max([tts["r"]] + [row[1] for row in tts.get("gradual_training") or []])
    nm = tts["audio"]["num_mels"]
    return {"NM": nm, "P": tts["prenet_dim"], "H1": tts["attention_rnn_dim"],
            "H2": tts["decoder_rnn_dim"], "E": tts["encoder_dim"], "A": tts["attention_dim"],
            "K": tts["attention_location_kernel_size"], "OW": nm * r_init, "r": tts["r"]}


def decode(tts: dict, call: dict) -> dict:
    """Kernel 1 over one call: each row's own steps (its frames / r), the
    padded text length T. bf16 products, f32 attention and context."""
    d = dims(tts)
    NM, P, H1, H2, E, A, K, OW = (d[k] for k in ("NM", "P", "H1", "H2", "E", "A", "K", "OW"))
    B, T = call["rows"], call["padded"]
    steps = sum(math.ceil(f / d["r"]) for f in call["frames"])      # row-steps
    macs = (P * NM + P * P + 4 * H1 * (P + E + H1) + A * H1
            + 4 * H2 * (H1 + E + H2) + (OW + 1) * (H2 + E))
    f32 = T * A * (4 * K + 4) + 2 * T * E
    weights = 2 * (P * NM + P * P + 4 * H1 * (P + E + H1) + A * H1 + 2 * K * A
                   + 4 * H2 * (H1 + E + H2) + (OW + 1) * (H2 + E)) \
        + 4 * (2 * P + 4 * H1 + 4 * H2 + OW + 1 + A + 1)
    nbytes = weights + B * T * (2 * E + 4 * A + 1) + 4 * steps * (OW + T + 1)
    return {"bf16_flops": 2.0 * macs * steps, "f32_flops": float(f32 * steps), "bytes": nbytes}


def frame_bucket(n: int) -> int:
    """The frames a Griffin-Lim launch pads a row to: multiples of 32."""
    return max(32, -(-n // 32) * 32)


def griffin_lim(audio: dict, call: dict, cap: int = 128) -> dict:
    """Kernel 2 (FGLA, wave route) over one call's rows, grouped as served:
    by frame bucket, at most `cap` rows a launch. Products of [M, n_fft] by
    [n_fft, n_fft] in bf16, 2 n + 1 of them; M counts each row's own
    frames."""
    n_fft, hop, iters = audio["fft_size"], audio["hop_length"], audio["griffin_lim_iters"]
    F = n_fft // 2 + 1
    groups: dict[int, list[int]] = {}
    for f in call["frames"]:
        groups.setdefault(frame_bucket(f), []).append(f)
    flops = nbytes = 0.0
    for tb, fs in groups.items():
        for lo in range(0, len(fs), cap):
            chunk = fs[lo:lo + cap]
            M = sum(chunk)
            flops += (2 * iters + 1) * 2.0 * M * n_fft * n_fft
            nbytes += (M * F * 4 + tb * F * 4 + 2 * n_fft * n_fft * 2
                       + sum(hop * (f - 1) * 4 for f in chunk))
    return {"bf16_flops": flops, "f32_flops": 0.0, "bytes": nbytes}


def melgan(voc: dict, frames: int, n_mels: int) -> dict:
    """The MelGAN generator on one row of `frames` mel frames, float32."""
    ch, k = voc["base_channels"], voc["kernel_size"]
    T = frames
    macs = T * n_mels * ch * k
    params = n_mels * ch * k + ch
    for u in voc["upsample_factors"]:
        macs += T * ch * (ch // 2) * 2 * u            # transposed conv, kernel 2u
        params += ch * (ch // 2) * 2 * u + ch // 2
        ch //= 2
        T *= u
        macs += voc["num_res_blocks"] * T * ch * ch * (3 + 1 + 1)
        params += voc["num_res_blocks"] * (ch * ch * 5 + 3 * ch)
    macs += T * ch * k
    params += ch * k + 1
    return {"bf16_flops": 0.0, "f32_flops": 2.0 * macs,
            "bytes": 4.0 * (params + frames * n_mels + T)}


def encoder(tts: dict, call: dict) -> float:
    """Float32 flops of the encoder (3 conv5 + BiLSTM) and the key
    projection over one call's padded batch."""
    E, A = tts["encoder_dim"], tts["attention_dim"]
    H = E // 2
    per_pos = 3 * E * E * 5 + 2 * 4 * H * (E + H) + E * A
    return 2.0 * call["rows"] * call["padded"] * per_pos


def postnet(tts: dict, call: dict) -> float:
    """Float32 flops of the postnet over each row's frames."""
    nm, pd = tts["audio"]["num_mels"], tts["postnet_dim"]
    per_frame = (nm * pd + 3 * pd * pd + pd * nm) * 5
    return 2.0 * per_frame * sum(call["frames"])
