"""Weights drawn from the seed: one normal draw on the device, one
torch.Generator there, cut into every tensor of a spec (name, shape, std,
mean) and scaled; a tensor of std 0 is its mean. Both the program and the
reference load the same dict."""

from __future__ import annotations

import math

import torch

STREAMS = {"tts": 1, "vocoder": 2}


def subseed(seed: int, stream: str) -> int:
    """A seed of its own for each thing the run draws, from the run's seed."""
    return (int(seed) * 1_000_003 + STREAMS[stream] * 7_919) % (2 ** 63)


@torch.no_grad()
def draw(spec: list, seed: int, device) -> dict:
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, std, _ in spec if std)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, std, mean in spec:
        n = math.prod(shape)
        if std:
            out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
            off += n
        else:
            out[name] = torch.full(shape, float(mean), device=device)
    return out
