"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no GPU (a CUDA kernel has no CPU
mode). On a machine with the card and nvcc, without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Whether a card is present is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

from your_voice_tts_torch.config import ModelConfig
from your_voice_tts_torch.models.common import sequence_mask
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.ops.filters import hann_window
from your_voice_tts_torch.ops.griffin_lim import (griffin_lim_wave, griffin_lim_wave_cuda,
                                                  griffin_lim_wave_plain, packed_constants)
from your_voice_tts_torch.ops.taco2_decode import (tacotron2_decode, tacotron2_decode_cuda,
                                                   tacotron2_decode_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("norm", ["sigmoid", "softmax"])
def test_decode_kernel_matches_plain(cuda, norm):
    """Smoke widths (odd sizes: 20 mels, attention 24, filter 15), one row
    pushed to stop at once; bf16 on both sides, f32 sums in other orders."""
    cfg = ModelConfig(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
                      attention_rnn_dim=48, attention_dim=24, attention_location_filters=8,
                      attention_location_kernel_size=15, prenet_dim=24, postnet_dim=32,
                      attention_norm=norm)
    model = Tacotron2(30, cfg, n_mels=20, r_init=3, device=cuda, seed=1)
    g = torch.Generator().manual_seed(0)
    B, T = 11, 13
    enc = (0.5 * torch.randn(B, T, 32, generator=g)).to(cuda)
    w = model.decoder.decode_weights(torch.bfloat16)
    c = w["o_w"][-1, 48:80].float()
    enc[3] += 8.0 * c / (c @ c)
    pinp = model.decoder.attention.preprocess_inputs(enc).detach()
    mask = sequence_mask(torch.arange(T, T - B, -1, device=cuda).clamp_min(2), T)
    kw = dict(r=2, max_steps=30, seed=5, chunk=7)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert int(got[3][3]) == 1
    assert torch.equal(got[3], ref[3])
    for a, b, tol in zip(got[:3], ref[:3], (5e-3, 2e-3, 2e-3)):
        assert float((a - b).abs().max()) <= tol
    assert torch.equal(tacotron2_decode(w, enc, pinp, mask, **kw)[0], got[0])


@pytest.mark.parametrize("n_fft,hop,B,T", [(256, 64, 3, 37), (1024, 256, 2, 20)])
def test_griffin_lim_kernel_matches_plain(cuda, n_fft, hop, B, T):
    """One and three FGLA iterations: bf16 loop state on both sides."""
    g = torch.Generator().manual_seed(0)
    mag = (torch.randn(B, T, n_fft // 2 + 1, generator=g).abs() + 0.1).to(cuda)
    phase = (torch.rand(T, n_fft // 2 + 1, generator=g) * 2 * np.pi).to(cuda)
    consts = packed_constants(n_fft, hop, hann_window(n_fft, n_fft), torch.bfloat16, cuda)
    for n in (1, 3):
        got = griffin_lim_wave_cuda(mag, phase, consts, n_iters=n, momentum=0.95)
        ref = griffin_lim_wave_plain(mag, phase, consts, n_iters=n, momentum=0.95)
        assert got.shape == (B, hop * (T - 1))
        assert float((got - ref).norm() / ref.norm()) <= 1e-2
    assert torch.equal(griffin_lim_wave(mag, phase, consts, n_iters=3, momentum=0.95), got)


def test_kernels_refuse_what_they_do_not_take(cuda):
    consts32 = packed_constants(256, 64, hann_window(256, 256), torch.float32, cuda)
    with pytest.raises(ValueError):
        griffin_lim_wave_cuda(torch.ones(1, 4, 129, device=cuda), torch.zeros(4, 129, device=cuda),
                              consts32, n_iters=1)
    model = Tacotron2(30, ModelConfig(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
                                      attention_rnn_dim=48, attention_dim=24, prenet_dim=24,
                                      postnet_dim=32), n_mels=20, device=cuda)
    w32 = model.decoder.decode_weights(torch.float32)
    enc = torch.zeros(1, 4, 32, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        tacotron2_decode_cuda(w32, enc, torch.zeros(1, 4, 24, device=cuda),
                              torch.ones(1, 4, dtype=torch.bool, device=cuda), r=2, max_steps=2)
