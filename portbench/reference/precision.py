"""Rounding of the operands of a product, so that one plain reference runs
at the precision a configuration states or at the one below it (the
control that decides whether a comparison can tell them apart).

Every mode returns float32 tensors; products accumulate in float32.
- "f32": nothing rounded (the reference);
- "tf32": the mantissa cut to TF32's 10 bits, round to nearest even (the
  step below float32 with TF32 off);
- "bf16": bfloat16 (what a bf16 kernel's operands are);
- "fp8": float8 e4m3 with one scale a tensor, its largest magnitude mapped
  to 448 (the step below bf16, as an fp8 product takes it).
"""

from __future__ import annotations

import torch

MODES = ("f32", "tf32", "bf16", "fp8")
E4M3_MAX = 448.0


def rounder(mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}; one of {MODES}")
    return {"f32": _f32, "tf32": _tf32, "bf16": _bf16, "fp8": _fp8}[mode]


def _f32(x):
    return x.float()


def _tf32(x):
    b = x.float().contiguous().view(torch.int32)
    # round to nearest even on the 13 dropped bits
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fp8(x):
    x = x.float()
    amax = x.abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def linear(x, w, b=None, rnd=_f32):
    """x [..., in] @ w [out, in].T (+ b), operands rounded by `rnd`."""
    y = rnd(x) @ rnd(w).T
    return y if b is None else y + b.float()


def conv1d(x, w, b=None, pad=(0, 0), mode="constant", dilation=1, rnd=_f32):
    """Channel-first [B, C, T] convolution with the weight [out, in, k];
    padded by `pad` (zeros, or "reflect"), operands rounded by `rnd`."""
    x = torch.nn.functional.pad(rnd(x), pad, mode=mode) if pad != (0, 0) else rnd(x)
    return torch.nn.functional.conv1d(x, rnd(w), None if b is None else b.float(),
                                      dilation=dilation)
