"""your_voice_tts_torch — the PyTorch + CUDA port of your_voice_tts_tpu.

The JAX package stays the reference; this package mirrors its layout
(config, text, nn, models, ops, audio, infer, vocoder, train, bin) and
never imports it or JAX. The hot loops (the Tacotron2 decode, Griffin-Lim,
the training decoder's forward and backward, the WaveRNN sample loop) run
as hand-written CUDA kernels (csrc/) on the GPU and as their plain PyTorch
versions on the CPU.

Numerics: importing the package turns TF32 off for float32 matmuls and
cuDNN convolutions, so the encoder and postnet run in full float32 like the
reference.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no CUDA and no explicit device this raises; it never
    drops to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


__all__ = ["resolve_device"]
