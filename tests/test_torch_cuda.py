"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no GPU (a CUDA kernel has no CPU
mode). On a machine with the card and nvcc, without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Whether a card is present is decided inside the fixture, never at import.
"""

import functools

import numpy as np
import pytest
import torch

from your_voice_tts_torch.config import ModelConfig
from your_voice_tts_torch.models.attention import VARIANTS
from your_voice_tts_torch.models.common import sequence_mask
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.ops.filters import hann_window
from your_voice_tts_torch.ops.griffin_lim import (griffin_lim_wave, griffin_lim_wave_cuda,
                                                  griffin_lim_wave_plain, packed_constants)
from your_voice_tts_torch.ops.taco2_decode import (ATTN_OPTIONS, held_steps, tacotron2_decode,
                                                   tacotron2_decode_cuda, tacotron2_decode_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def decode_case(cuda, B, norm="sigmoid", location=True, dropout=True, stop_rows=None, T=13,
                seed=1, K=15):
    """Smoke widths (odd sizes: 20 mels, attention 24, filter K=15), seeded
    random weights and inputs on the card; `stop_rows` (default: row
    min(3, B - 1)) get the stop row's context direction so they stop at
    once. Returns (w, enc, pinp, mask)."""
    cfg = ModelConfig(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
                      attention_rnn_dim=48, attention_dim=24, attention_location_filters=8,
                      attention_location_kernel_size=K, prenet_dim=24, postnet_dim=32,
                      attention_norm=norm, location_attn=location, prenet_dropout=dropout)
    model = Tacotron2(30, cfg, n_mels=20, r_init=3, device=cuda, seed=seed)
    g = torch.Generator().manual_seed(0)
    enc = (0.5 * torch.randn(B, T, 32, generator=g)).to(cuda)
    w = model.decoder.decode_weights(torch.bfloat16)
    c = w["o_w"][-1, 48:80].float()
    for row in (min(3, B - 1),) if stop_rows is None else stop_rows:
        enc[row] += 8.0 * c / (c @ c)
    pinp = model.decoder.attention.preprocess_inputs(enc).detach()
    lengths = (T - torch.arange(B, device=cuda) % T).clamp_min(2)
    return w, enc, pinp, sequence_mask(lengths, T)


def assert_decode_holds(got, ref):
    """Lengths equal; frames 5e-3, alignments and stops 2e-3 (bf16 inputs
    on both sides, f32 sums in other orders)."""
    assert torch.equal(got[3], ref[3])
    for a, b, tol in zip(got[:3], ref[:3], (5e-3, 2e-3, 2e-3)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol


# B, norm, location features, prenet dropout, filter taps, T
DECODE_CASES = [(1, "sigmoid", True, True, 15, 13), (3, "softmax", True, True, 15, 13),
                (8, "sigmoid", False, True, 15, 13), (8, "softmax", True, False, 15, 13),
                (11, "sigmoid", True, True, 15, 13), (11, "softmax", False, False, 15, 13),
                (40, "sigmoid", True, False, 15, 13), (40, "softmax", True, True, 15, 13),
                (11, "sigmoid", True, True, 35, 40), (11, "softmax", True, False, 65, 40)]


@pytest.mark.parametrize("B,norm,location,dropout,K,T", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, B, norm, location, dropout, K, T):
    """One persistent launch a decode, held against the plain version;
    one row pushed to stop at once. Filters past 32 taps: a warp stages
    the window 32 taps a pass."""
    w, enc, pinp, mask = decode_case(cuda, B, norm, location, dropout, K=K, T=T)
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, norm=norm, prenet_dropout=dropout)
    before = tacotron2_decode_cuda.launches
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron2_decode_cuda.launches == before + 1
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert int(got[3][min(3, B - 1)]) == 1
    assert_decode_holds(got, ref)
    assert torch.equal(tacotron2_decode(w, enc, pinp, mask, **kw)[0], got[0])


def fixed_smem(dec, dims, B, T, sms):
    """Shared memory of a plan without what it places only where it fits
    (the weight buffer, the pairs' W_k m)."""
    plan = dec.launch_plan(dims, B, T, sms)
    pre = -(-plan["PPB"] * dims["A"] * 4 // 16) * 16 * plan["PRE_SMEM"]
    return plan["smem_bytes"] - plan["WBUF"] * 512 - pre


def test_decode_kernel_in_batch_slices(cuda, monkeypatch):
    """A batch one launch cannot hold (a smaller limit of shared memory
    stands in for a larger batch) runs as slices of whole batch tiles; every
    row of the first slice stops at once, so that slice leaves at the first
    chunk boundary and runs again to the others' step count: the same
    outputs as plain over the whole batch, dropout keyed on the batch row."""
    from your_voice_tts_torch.ops import taco2_decode as dec

    B, T = 40, 13
    w, enc, pinp, mask = decode_case(cuda, B, stop_rows=range(16))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    monkeypatch.setattr(dec, "SMEM_LIMIT", fixed_smem(dec, w["dims"], 16, T, sms))
    assert dec.batch_slices(w["dims"], B, T, sms) == [(0, 16), (16, 32), (32, 40)]
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, prenet_dropout=True)
    before = tacotron2_decode_cuda.launches
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert_decode_holds(got, ref)
    # a slice leaves at the first chunk boundary past its longest row (in
    # steps), at 35 steps at the latest; those that left first run again
    rans = [min(-(-int(ref[3][b0:b1].max()) // 7) * 7, 35) for b0, b1 in
            [(0, 16), (16, 32), (32, 40)]]
    assert rans[0] == 7 < max(rans) and got[3][:16].tolist() == [1] * 16
    again = sum(r < max(rans) for r in rans)
    assert tacotron2_decode_cuda.launches == before + 3 + again
    assert got[1][min(max(rans), 30) - 1, :16].any()      # the first slice ran on


@pytest.mark.parametrize("room", ["none", "some"])
def test_decode_kernel_with_less_shared_memory(cuda, monkeypatch, room):
    """With less shared memory than the weight buffer wants (a smaller
    limit stands in for a larger batch or another card), the rounds that do
    not fit read their weights from L2, and with no room at all `pre` goes
    to global memory too: the same outputs as plain."""
    from your_voice_tts_torch.ops import taco2_decode as dec

    B = 11
    w, enc, pinp, mask = decode_case(cuda, B)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = dec.launch_plan(w["dims"], B, mask.shape[1], sms)
    pre = -(-plan["PPB"] * w["dims"]["A"] * 4 // 16) * 16 * plan["PRE_SMEM"]
    base = plan["smem_bytes"] - plan["WBUF"] * 512 - pre
    monkeypatch.setattr(dec, "SMEM_LIMIT", base + (0 if room == "none" else 512 * 4))
    small = dec.launch_plan(w["dims"], B, mask.shape[1], sms)
    assert small["WB_ROUNDS"] != plan["WB_ROUNDS"]
    if room == "none":
        assert small["WB_ROUNDS"] == 0 and small["PRE_SMEM"] == 0
    else:
        assert small["WB_ROUNDS"] != 0
    kw = dict(r=2, max_steps=30, seed=5, chunk=7)
    assert_decode_holds(tacotron2_decode_cuda(w, enc, pinp, mask, **kw),
                        tacotron2_decode_plain(w, enc, pinp, mask, **kw))


@pytest.mark.parametrize("B", [3, 11])
def test_decode_kernel_exits_early_on_the_device(cuda, B):
    """Every row stops at its first step, inside the first chunk: the
    kernel leaves at the first chunk boundary, as `_drive` does, writes 7
    steps to its device int, and the later chunks come back zero."""
    from your_voice_tts_torch.ops.taco2_decode import _launch

    w, enc, pinp, mask = decode_case(cuda, B, stop_rows=range(B))
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, norm="sigmoid", prenet_dropout=True)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1] * B
    assert_decode_holds(got, ref)
    assert got[1][:7].any() and not got[1][7:].any() and not got[2][7:].any()
    ran = _launch(w, enc, pinp, mask, thresh=0.6, probe=0, **kw)[3]
    assert int(ran.item()) == 7
    kw["max_steps"] = 7                            # no boundary inside the decode
    assert int(_launch(w, enc, pinp, mask, thresh=0.6, probe=0, **kw)[3].item()) == 7


def full_width_case(cuda, B, stop_rows, T=152, spk_dim=None):
    """configs/ljspeech_tacotron2.json's widths (r=2 of r_init 7), seeded
    random weights, the stop row's bias at -10 and `stop_rows` pushed to
    stop at once. spk_dim conditions the model on speakers (d-vectors of
    that width, or with 0 the 512-wide table): the memory is E = 512 +
    spk_dim wide, or 1,024. Returns (w, enc, pinp, mask, stop threshold)."""
    import dataclasses

    from your_voice_tts_torch.config import load_config

    cfg = load_config("configs/ljspeech_tacotron2.json")
    spk = {} if spk_dim is None else dict(num_speakers=4, speaker_embedding_dim=spk_dim)
    model = Tacotron2(60, dataclasses.replace(cfg.model, r=2), n_mels=80, r_init=7,
                      device=cuda, seed=2, **spk)
    E = 512 + model.spk_dim
    with torch.no_grad():
        model.decoder.stopnet.bias.fill_(-10.0)
    g = torch.Generator().manual_seed(4)
    enc = (0.5 * torch.randn(B, T, E, generator=g)).to(cuda)
    w = model.decoder.decode_weights(torch.bfloat16)
    c = w["o_w"][-1, 1024:1024 + E].float()
    enc[list(stop_rows)] += 20.0 * c / (c @ c)
    pinp = model.decoder.attention.preprocess_inputs(enc).detach()
    lengths = 150 - 4 * (torch.arange(B, device=cuda) % 32)
    return w, enc, pinp, sequence_mask(lengths, T), cfg.model.stop_threshold


def test_decode_kernel_at_full_width(cuda):
    """Full width, B=8, T=152, 40 steps, dropout on; row 0 stops at once."""
    w, enc, pinp, mask, thresh = full_width_case(cuda, 8, [0])
    kw = dict(r=2, max_steps=40, seed=7, thresh=thresh)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1] + [40] * 7
    assert_decode_holds(got, ref)


@pytest.mark.parametrize("spk_dim,E", [(256, 768), (0, 1024)])
@pytest.mark.parametrize("B", [8, 1])
def test_decode_kernel_at_speaker_conditioned_widths(cuda, spk_dim, E, B):
    """The memory of a speaker-conditioned model: 256-wide d-vectors (E =
    768) or the 512-wide speaker table (E = 1,024) concatenated onto the
    encoder's 512, full width, T=152, 40 steps, dropout on; row 0 stops at
    once. E = 768 at B=8 fills 229,376 of the 232,448 bytes of shared
    memory a block; at E = 1,024 one round's weight tiles are read from L2
    instead of prefetched (WB_ROUNDS 47 where E = 512 has 63)."""
    from your_voice_tts_torch.ops.taco2_decode import launch_plan

    w, enc, pinp, mask, thresh = full_width_case(cuda, B, [0], spk_dim=spk_dim)
    assert w["dims"]["E"] == E
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = launch_plan(w["dims"], B, 152, sms)
    kw = dict(r=2, max_steps=40, seed=7, thresh=thresh)
    before = tacotron2_decode_cuda.launches
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron2_decode_cuda.launches == before + 1
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1] + [40] * (B - 1)
    assert_decode_holds(got, ref)
    assert plan["PRE_SMEM"] == 1


def test_decode_kernel_reads_w_k_m_from_global_memory_at_e768(cuda):
    """E = 768 at B=64, one launch: the block's W_k m pairs do not fit
    shared memory (PRE_SMEM 0) and are read from global memory, and one
    round's weight tiles come from L2 (WB_ROUNDS 47); the same outputs as
    plain."""
    from your_voice_tts_torch.ops.taco2_decode import launch_plan

    B = 64
    w, enc, pinp, mask, thresh = full_width_case(cuda, B, range(0, B, 5), spk_dim=256)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert launch_plan(w["dims"], B, 152, sms)["PRE_SMEM"] == 0
    kw = dict(r=2, max_steps=30, seed=7, thresh=thresh)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1 if b % 5 == 0 else 30 for b in range(B)]
    assert_decode_holds(got, ref)


def test_melgan_on_the_card_matches_the_cpu(cuda):
    """The trained MelGAN asset (cuDNN convolutions, TF32 off) against the
    same generator on the CPU, on a seeded mel: 1e-4."""
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    cfg, ckpt = "configs/melgan_smoke.json", "assets/bench_trained_melgan.npz"
    mel = np.random.default_rng(0).uniform(-4, 4, (20, 37)).astype(np.float32)
    got = VocoderSynthesizer(cfg, ckpt, device=cuda).mel_to_wav(mel)
    ref = VocoderSynthesizer(cfg, ckpt, device="cpu").mel_to_wav(mel)
    assert got.shape == ref.shape == (37 * 64,)
    assert float(np.abs(got - ref).max()) <= 1e-4


@pytest.mark.parametrize("recur_on_proj", [True, False])
def test_speaker_encoder_on_the_card_matches_the_cpu(cuda, recur_on_proj):
    """A full-width GE2E encoder (80 -> 3 x 768 / 256, cuDNN LSTMs, TF32
    off) against the same weights on the CPU, both window paths of
    compute_embedding: 1e-5."""
    from your_voice_tts_torch.speaker_encoder.model import SpeakerEncoder

    enc = SpeakerEncoder(recur_on_proj=recur_on_proj, device=cuda, seed=3)
    cpu = SpeakerEncoder(recur_on_proj=recur_on_proj, device="cpu", seed=3)
    rng = np.random.default_rng(1)
    for T in (120, 400):
        mel = rng.standard_normal((T, 80)).astype(np.float32)
        got = enc.compute_embedding(mel).cpu()
        assert float((got - cpu.compute_embedding(mel)).abs().max()) <= 1e-5


def test_decode_kernel_past_one_launch_at_full_width(cuda):
    """Full width past what one launch holds at T=152 (304 rows): B=312
    runs as two slices, rows 0-159 and 160-311; the first slice's rows stop
    at once, so it leaves at step 10 and runs again to 40. The same outputs
    as plain."""
    from your_voice_tts_torch.ops.taco2_decode import batch_slices

    B = 312
    w, enc, pinp, mask, thresh = full_width_case(cuda, B, range(160))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert batch_slices(w["dims"], B, 152, sms) == [(0, 160), (160, 312)]
    kw = dict(r=2, max_steps=40, seed=7, thresh=thresh, chunk=10)
    before = tacotron2_decode_cuda.launches
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron2_decode_cuda.launches == before + 3
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1] * 160 + [40] * 152
    assert_decode_holds(got, ref)


# kernel 1's attention variants (models/attention.py VARIANTS;
# tests/test_torch_attention_variants.py holds their plain version against
# the JAX package's Pallas kernel)


def variant_case(cuda, B, variant, stop_rows=None, T=13, width=None):
    """decode_case's smoke widths (or, with width="full",
    configs/ljspeech_tacotron2.json's, T=152, the stop row's bias at -10)
    with an attention variant. Returns (w, enc, pinp or None, mask,
    keywords of the decode: norm and the variant's flags)."""
    import dataclasses

    from your_voice_tts_torch.config import load_config

    if width == "full":
        cfg = dataclasses.replace(load_config("configs/ljspeech_tacotron2.json").model, r=2,
                                  **VARIANTS[variant])
        model = Tacotron2(60, cfg, n_mels=80, r_init=7, device=cuda, seed=2)
        with torch.no_grad():
            model.decoder.stopnet.bias.fill_(-10.0)
        E, H2 = 512, 1024
    else:
        cfg = ModelConfig(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
                          attention_rnn_dim=48, attention_dim=24, attention_location_filters=8,
                          attention_location_kernel_size=15, prenet_dim=24, postnet_dim=32,
                          **VARIANTS[variant])
        model = Tacotron2(30, cfg, n_mels=20, r_init=3, device=cuda, seed=1)
        E, H2 = 32, 48
    g = torch.Generator().manual_seed(0)
    enc = (0.5 * torch.randn(B, T, E, generator=g)).to(cuda)
    w = model.decoder.decode_weights(torch.bfloat16)
    c = w["o_w"][-1, H2:H2 + E].float()
    for row in (min(3, B - 1),) if stop_rows is None else stop_rows:
        enc[row] += (20.0 if width == "full" else 8.0) * c / (c @ c)
    pinp = model.decoder.attention.preprocess_inputs(enc)
    lengths = (T - torch.arange(B, device=cuda) % T).clamp_min(2)
    kw = dict(norm=model.decoder.attention.norm, **model.decoder.attn_kernel_flags())
    return w, enc, None if pinp is None else pinp.detach(), sequence_mask(lengths, T), kw


def assert_variant_holds(w, enc, pinp, mask, kw, got):
    """assert_decode_holds against the plain version over the steps
    `held_steps` holds for the variant's options: every step of a variant
    that takes no maximum, a window's fork step too, a forward mask's
    fork a tie of the plain version's alignment before the mask."""
    premask = []
    ref = tacotron2_decode_plain(w, enc, pinp, mask, premask=premask, **kw)
    n, fork, gap = held_steps(got, ref, premask,
                              **{k: v for k, v in kw.items() if k in ATTN_OPTIONS})
    if fork is None:
        return assert_decode_holds(got, ref)
    assert n > 0 and (gap is None or gap <= 2e-3), (fork, gap)
    assert_decode_holds([t[:n] for t in got[:3]] + [ref[3]],
                        [t[:n] for t in ref[:3]] + [ref[3]])


@pytest.mark.parametrize("B", [1, 11])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_attention_variant_matches_plain(cuda, variant, B):
    """Each attention variant, one launch a decode, against the plain
    version at smoke widths; one row pushed to stop at once."""
    w, enc, pinp, mask, akw = variant_case(cuda, B, variant)
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, **akw)
    before = tacotron2_decode_cuda.launches
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron2_decode_cuda.launches == before + 1
    assert int(got[3][min(3, B - 1)]) == 1
    assert_variant_holds(w, enc, pinp, mask, kw, got)
    assert torch.equal(tacotron2_decode(w, enc, pinp, mask, **kw)[0], got[0])


@pytest.mark.parametrize("variant", ["graves", "forward_ta_mask"])
def test_decode_attention_variant_in_batch_slices(cuda, monkeypatch, variant):
    """A batch past one launch's plan (a smaller limit of shared memory
    stands in for a larger batch) with Graves's and the options' state in
    each block: slices of whole batch tiles, the first slice's rows stop at
    once and it runs again; the same outputs as plain."""
    from your_voice_tts_torch.ops import taco2_decode as dec

    B, T = 40, 13
    w, enc, pinp, mask, akw = variant_case(cuda, B, variant, stop_rows=range(16))
    route = dec.attention_route(w, **{k: v for k, v in akw.items() if k in ATTN_OPTIONS})
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = dec.launch_plan(w["dims"], 16, T, sms, route)
    pre = -(-plan["PPB"] * w["dims"]["A"] * 4 // 16) * 16 * plan["PRE_SMEM"]
    monkeypatch.setattr(dec, "SMEM_LIMIT", plan["smem_bytes"] - plan["WBUF"] * 512 - pre)
    assert dec.batch_slices(w["dims"], B, T, sms, functools.partial(
        dec.launch_plan, route=route)) == [(0, 16), (16, 32), (32, 40)]
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, **akw)
    before = tacotron2_decode_cuda.launches
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron2_decode_cuda.launches > before + 3         # a slice ran again
    assert got[3][:16].tolist() == [1] * 16
    assert_variant_holds(w, enc, pinp, mask, kw, got)


@pytest.mark.parametrize("variant", ["graves", "forward_ta_mask", "window_forward"])
def test_decode_attention_variant_at_full_width(cuda, variant):
    """Full width, B=8, T=152, 40 steps, dropout on; row 0 stops at once.
    Graves reads its 2 MB l1 in R3's query product."""
    w, enc, pinp, mask, akw = variant_case(cuda, 8, variant, stop_rows=[0], T=152,
                                           width="full")
    kw = dict(r=2, max_steps=40, seed=7, **akw)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1] + [40] * 7
    assert_variant_holds(w, enc, pinp, mask, kw, got)


def test_decode_attention_variant_with_stream_state(cuda):
    """Forward attention with a stream in and out: the attention state
    starts afresh, the LSTM state streams; chunk 2 from chunk 1's stream."""
    B = 11
    w, enc, pinp, mask, akw = variant_case(cuda, B, "forward_ta")
    stream = seeded_stream(cuda, B)
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, return_stream=True, **akw)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, stream=stream, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, stream=stream, **kw)
    assert_decode_holds(got[:4], ref[:4])
    assert_stream_holds(got[4], ref[4])
    got2 = tacotron2_decode_cuda(w, enc, pinp, mask, stream=got[4], **kw)
    ref2 = tacotron2_decode_plain(w, enc, pinp, mask, stream=ref[4], **kw)
    assert_decode_holds(got2[:4], ref2[:4])


def test_decode_attention_variant_refusals(cuda):
    """What the kernel lacks raises, and nothing launches: Graves with a
    location option, the agent without its weights, a probe launch off the
    location route, more Graves components than a warp's lanes."""
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_probe_cuda

    w, enc, pinp, mask, _ = variant_case(cuda, 3, "graves")
    loc_w, _, loc_pinp, _, _ = variant_case(cuda, 3, "forward")
    before = tacotron2_decode_cuda.launches
    kw = dict(r=2, max_steps=4)
    with pytest.raises(ValueError, match="Graves attention takes none"):
        tacotron2_decode_cuda(w, enc, pinp, mask, windowing=True, **kw)
    with pytest.raises(ValueError, match="shape mismatch"):
        tacotron2_decode_cuda(w, enc, loc_pinp, mask, **kw)
    with pytest.raises(ValueError, match="transition agent needs its weights"):
        tacotron2_decode_cuda(loc_w, enc, loc_pinp, mask, forward_attn=True, trans_agent=True,
                              **kw)
    with pytest.raises(TypeError, match="unknown attention options"):
        tacotron2_decode_cuda(loc_w, enc, loc_pinp, mask, window=True, **kw)
    with pytest.raises(ValueError, match="probe launches take the location route only"):
        from your_voice_tts_torch.ops.taco2_decode import _launch
        _launch(loc_w, enc, loc_pinp, mask, r=2, max_steps=4, norm="sigmoid", thresh=0.6,
                prenet_dropout=True, seed=0, chunk=4, probe=1, forward_attn=True)
    wide = {**w, "dims": dict(w["dims"], GK=33)}
    with pytest.raises(ValueError, match="Graves components"):
        tacotron2_decode_cuda(wide, enc, pinp, mask, **kw)
    tacotron2_decode_probe_cuda(loc_w, enc, loc_pinp, mask, "barriers_only", r=2, max_steps=4)
    assert tacotron2_decode_cuda.launches == before


@pytest.mark.parametrize("variant", ["graves", "window_forward"])
def test_decode_attention_variant_profile_times_every_round(cuda, variant):
    """The profiling instantiation of a variant's route runs every step
    and times each round."""
    from your_voice_tts_torch.ops.taco2_decode import ROUNDS, tacotron2_decode_profile_cuda

    w, enc, pinp, mask, akw = variant_case(cuda, 11, variant)
    kw = dict(r=2, max_steps=20, seed=5, chunk=50, **akw)
    prof = tacotron2_decode_profile_cuda(w, enc, pinp, mask, **kw)
    assert list(prof["rounds"]) == list(ROUNDS) and prof["steps"] == 50
    assert all(v["work_max_us"] >= v["work_mean_us"] > 0 for v in prof["rounds"].values())


def seeded_stream(cuda, B, H=48, n_mels=20, seed=3):
    """((h1, c1), (h2, c2), frame) on the card, float32, from a seed."""
    g = torch.Generator().manual_seed(seed)
    h1, h2 = (torch.tanh(torch.randn(B, H, generator=g)).to(cuda) for _ in range(2))
    c1, c2 = (torch.randn(B, H, generator=g).to(cuda) for _ in range(2))
    return (h1, c1), (h2, c2), torch.randn(B, n_mels, generator=g).to(cuda)


def stream_tensors(stream):
    (h1, c1), (h2, c2), frame = stream
    return [h1, c1, h2, c2, frame]


def assert_stream_holds(got, ref, tol=5e-3):
    """The five stream tensors: shapes equal, within the frames' 5e-3."""
    for a, b in zip(stream_tensors(got), stream_tensors(ref)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("B", [1, 11])
def test_decode_kernel_with_stream_state(cuda, B):
    """Kernel 1's stream branch against plain: chunk 1 fresh, chunk 2 from
    each side's chunk-1 stream, and a seeded stream given to both; one row
    stops at once. Asking for the stream changes no output bit."""
    w, enc, pinp, mask = decode_case(cuda, B)
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, return_stream=True)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert_decode_holds(got[:4], ref[:4])
    assert_stream_holds(got[4], ref[4])
    bare = tacotron2_decode_cuda(w, enc, pinp, mask, r=2, max_steps=30, seed=5, chunk=7)
    assert all(torch.equal(a, b) for a, b in zip(bare, got[:4]))
    for stream_got, stream_ref in ((got[4], ref[4]),
                                   (seeded_stream(cuda, B),) * 2):
        before = [t.clone() for t in stream_tensors(stream_got)]
        got2 = tacotron2_decode_cuda(w, enc, pinp, mask, stream=stream_got, **kw)
        ref2 = tacotron2_decode_plain(w, enc, pinp, mask, stream=stream_ref, **kw)
        assert_decode_holds(got2[:4], ref2[:4])
        assert_stream_holds(got2[4], ref2[4])
        assert not torch.allclose(got2[0], got[0], atol=1e-2)
        assert all(torch.equal(a, b) for a, b in zip(before, stream_tensors(stream_got)))


@pytest.mark.parametrize("B", [3, 11])
def test_decode_kernel_stream_freezes_at_the_all_done_boundary(cuda, B):
    """Every row stops at its first step: the kernel leaves at step 7, and
    its stream is the state there, as plain's and as a 7-step launch's."""
    w, enc, pinp, mask = decode_case(cuda, B, stop_rows=range(B))
    kw = dict(r=2, seed=5, chunk=7, stream=seeded_stream(cuda, B), return_stream=True)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, max_steps=30, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, max_steps=30, **kw)
    assert got[3].tolist() == [1] * B and not got[1][7:].any()
    assert_decode_holds(got[:4], ref[:4])
    assert_stream_holds(got[4], ref[4])
    seven = tacotron2_decode_cuda(w, enc, pinp, mask, max_steps=7, **kw)
    assert all(torch.equal(a, b) for a, b in zip(stream_tensors(seven[4]),
                                                stream_tensors(got[4])))
    assert not got[4][2].any()


def test_decode_kernel_stream_in_batch_slices(cuda, monkeypatch):
    """A stream through a batch cut into slices: the first slice's rows
    stop at once, it leaves at step 7 and runs again, from a fresh copy of
    its rows of the stream, to the others' step count; the stream out is
    plain's over the whole batch."""
    from your_voice_tts_torch.ops import taco2_decode as dec

    B, T = 40, 13
    w, enc, pinp, mask = decode_case(cuda, B, stop_rows=range(16))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    monkeypatch.setattr(dec, "SMEM_LIMIT", fixed_smem(dec, w["dims"], 16, T, sms))
    assert dec.batch_slices(w["dims"], B, T, sms) == [(0, 16), (16, 32), (32, 40)]
    stream = seeded_stream(cuda, B)
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, prenet_dropout=True, stream=stream,
              return_stream=True)
    before = tacotron2_decode_cuda.launches
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron2_decode_cuda.launches > before + 3         # a slice ran again
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    assert_decode_holds(got[:4], ref[:4])
    assert_stream_holds(got[4], ref[4])


@pytest.mark.parametrize("probe", ["barriers_only", "copies_only", "dots_only"])
def test_decode_probe_launches_run(cuda, probe):
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_probe_cuda

    w, enc, pinp, mask = decode_case(cuda, 11)
    before = tacotron2_decode_cuda.launches
    tacotron2_decode_probe_cuda(w, enc, pinp, mask, probe, r=2, max_steps=20)
    torch.cuda.synchronize()
    assert tacotron2_decode_cuda.launches == before     # probes are not counted


def test_decode_profile_launch_times_every_round(cuda):
    """The profiling instantiation serves (the same outputs) and returns
    each round's work and barrier wait; it is not counted as a launch."""
    from your_voice_tts_torch.ops.taco2_decode import ROUNDS, tacotron2_decode_profile_cuda

    w, enc, pinp, mask = decode_case(cuda, 11)
    before = tacotron2_decode_cuda.launches
    prof = tacotron2_decode_profile_cuda(w, enc, pinp, mask, r=2, max_steps=20, norm="sigmoid",
                                         thresh=0.6, prenet_dropout=True, seed=0, chunk=50)
    assert tacotron2_decode_cuda.launches == before and prof["steps"] == 50
    assert list(prof["rounds"]) == list(ROUNDS)
    assert all(v["work_max_us"] >= v["work_mean_us"] > 0 and v["wait_mean_us"] >= 0
               for v in prof["rounds"].values())


def test_decode_kernel_refuses_what_it_does_not_take(cuda):
    """The wrapper raises and does not fall back: no launch is counted and
    no plain decode runs in its place."""
    w, enc, pinp, mask = decode_case(cuda, 3)
    before = tacotron2_decode_cuda.launches
    kw = dict(r=2, max_steps=4)
    with pytest.raises(ValueError, match="norm"):
        tacotron2_decode_cuda(w, enc, pinp, mask, norm="relu", **kw)
    with pytest.raises(ValueError, match="shape"):
        tacotron2_decode_cuda(w, enc, pinp[:, :, :8], mask, **kw)
    with pytest.raises(ValueError, match="chunk"):
        tacotron2_decode_cuda(w, enc, pinp, mask, chunk=0, **kw)
    cpu_w = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in w.items()
             if k != "packed"}
    with pytest.raises(ValueError, match="is on cpu"):
        tacotron2_decode_cuda(cpu_w, enc, pinp, mask, **kw)
    from your_voice_tts_torch.ops import taco2_decode as dec

    with pytest.MonkeyPatch.context() as mp:              # not even one batch tile fits
        mp.setattr(dec, "SMEM_LIMIT", 8 * 1024)
        with pytest.raises(ValueError, match="shared memory"):
            tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    w32 = {**w, "dtype": torch.float32}
    with pytest.raises(ValueError, match="bf16"):
        tacotron2_decode_cuda(w32, enc, pinp, mask, **kw)
    assert tacotron2_decode_cuda.launches == before


# n_fft, hop, B, T, a phase per row: M = B * T off multiples of 64 and 128,
# T = 2, B = 1, n_fft 128 (128-wide tiles), 384 (three of them), 2048, a
# hop off multiples of 4 (scalar OLA and emit), full width; 2048 at hops 64
# and 65 (31 shifts a side, 16-byte and scalar OLA); 4096 at hop 1024 (the
# OLA in two passes a row; at B=2, T=9 the loop at momentum 0.95 carries
# its 4096-long f32 sums' order to rel L2 1.005e-2 after three iterations,
# about as far as a relative 1e-6 nudge of the magnitudes carries the plain
# version, 9.7e-3, on an H100: `wavernn_ab.py --mode gl_spread`) and 2176
# at hop 545 (17 tiles of 128, a scalar OLA whose second pass is partly
# past the row)
GL_CASES = [(256, 64, 3, 37, False), (1024, 256, 2, 20, False), (128, 32, 3, 43, True),
            (2048, 512, 1, 2, False), (384, 96, 2, 7, True), (256, 50, 2, 9, False),
            (1024, 256, 8, 500, True), (2048, 64, 1, 20, False), (2048, 65, 2, 9, True),
            (4096, 1024, 4, 40, True), (2176, 545, 2, 9, False)]


def gl_inputs(cuda, n_fft, B, T, per_row):
    """Seeded magnitudes [B, T, Kf] and an initial phase, [B, T, Kf] or
    shared [T, Kf], on the card."""
    g = torch.Generator().manual_seed(0)
    mag = (torch.randn(B, T, n_fft // 2 + 1, generator=g).abs() + 0.1).to(cuda)
    shape = (B, T, n_fft // 2 + 1) if per_row else (T, n_fft // 2 + 1)
    return mag, (torch.rand(shape, generator=g) * 2 * np.pi).to(cuda)


@pytest.mark.parametrize("n_fft,hop,B,T,per_row", GL_CASES)
def test_griffin_lim_kernel_matches_plain(cuda, n_fft, hop, B, T, per_row):
    """One and three FGLA iterations: bf16 loop state on both sides."""
    mag, phase = gl_inputs(cuda, n_fft, B, T, per_row)
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
    for n_fft, hop in ((320, 80), (2176, 1088)):     # n_fft % 128, hop > 1024
        consts = packed_constants(n_fft, hop, hann_window(n_fft, n_fft), torch.bfloat16, cuda)
        kf = n_fft // 2 + 1
        with pytest.raises(ValueError, match="n_fft % 128"):
            griffin_lim_wave_cuda(torch.ones(1, 4, kf, device=cuda),
                                  torch.zeros(4, kf, device=cuda), consts, n_iters=1)
    model = Tacotron2(30, ModelConfig(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
                                      attention_rnn_dim=48, attention_dim=24, prenet_dim=24,
                                      postnet_dim=32), n_mels=20, device=cuda)
    w32 = model.decoder.decode_weights(torch.float32)
    enc = torch.zeros(1, 4, 32, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        tacotron2_decode_cuda(w32, enc, torch.zeros(1, 4, 24, device=cuda),
                              torch.ones(1, 4, dtype=torch.bool, device=cuda), r=2, max_steps=2)


def train_case(dtype, norm, location, dropout, cuda, widths=(24, 32, 48, 40, 24), B=11, T=13,
               steps=9, K=15, scale=0.3):
    """Smoke widths (P, E, H1, H2, A; filter K) with odd batch and text
    sizes, seeded random weights (N(0, scale^2)) and inputs, on the card.
    Widths that are not multiples of 8 take the kernels' element-by-element
    staging."""
    from your_voice_tts_torch.ops.taco2_train import prepare_train_weights

    g = torch.Generator().manual_seed(3)
    r = lambda *s, k=scale: (k * torch.randn(*s, generator=g)).to(dtype).to(cuda)  # noqa: E731
    P, E, H1, H2, A = widths
    w = prepare_train_weights((r(4 * H1, P + E), r(4 * H1, H1), r(4 * H1)), r(A, H1),
                              r(8, 2, K) if location else None, r(A, 8) if location else None,
                              r(1, A), r(1), (r(4 * H2, H1 + E), r(4 * H2, H2), r(4 * H2)))
    x = {"prenet_t": r(steps, B, P, k=1.0), "enc": r(B, T, E, k=1.0), "pinp": r(B, T, A),
         "maskf": sequence_mask(torch.arange(T, T - B, -1).clamp_min(2), T).float().to(cuda)}
    masks = [None, None]
    if dropout:
        masks = [torch.where(torch.rand(steps, B, H, generator=g) < 0.9, 1 / 0.9, 0.0)
                 .to(dtype).to(cuda) for H in (H1, H2)]
    return w, x, masks


TRAIN_CASES = [(torch.bfloat16, "sigmoid", True, True, (24, 32, 48, 40, 24)),
               (torch.bfloat16, "softmax", True, False, (24, 32, 48, 40, 24)),
               (torch.float32, "sigmoid", False, True, (24, 32, 48, 40, 24)),
               (torch.float32, "softmax", True, True, (24, 32, 48, 40, 24)),
               (torch.bfloat16, "sigmoid", True, True, (20, 28, 44, 36, 22))]


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


SMOKE = (24, 32, 48, 40, 24)
FULL_WIDTH = (256, 512, 1024, 1024, 128)
# both scans' cases: TRAIN_CASES at B=11, T_in=13, K=15, 9 steps, then the
# edges: B not a multiple of 8 (5) and above 32 (40) and 64 (70: two batch
# slices of the tensor-core products); T_in not in four equal parts (37)
# and too short for four (3: a cluster of two); K=1; location off; full
# width
SCAN_CASES = [c + (11, 13, 15, 9, 0.3) for c in TRAIN_CASES] + [
    (torch.bfloat16, "sigmoid", True, True, SMOKE, 5, 13, 15, 9, 0.3),
    (torch.bfloat16, "softmax", True, True, SMOKE, 40, 13, 15, 9, 0.3),
    (torch.bfloat16, "sigmoid", True, False, SMOKE, 70, 13, 15, 5, 0.3),
    (torch.float32, "sigmoid", True, True, SMOKE, 40, 37, 15, 9, 0.3),
    (torch.bfloat16, "sigmoid", True, False, SMOKE, 11, 37, 15, 9, 0.3),
    (torch.bfloat16, "softmax", True, True, SMOKE, 11, 3, 15, 9, 0.3),
    (torch.float32, "softmax", True, False, SMOKE, 5, 3, 15, 9, 0.3),
    (torch.bfloat16, "sigmoid", True, True, SMOKE, 11, 13, 1, 9, 0.3),
    (torch.float32, "softmax", True, True, SMOKE, 11, 37, 1, 9, 0.3),
    (torch.bfloat16, "softmax", False, True, SMOKE, 11, 37, 15, 9, 0.3),
    (torch.bfloat16, "sigmoid", True, True, FULL_WIDTH, 32, 128, 31, 24, 0.03)]


@pytest.mark.parametrize("dtype,norm,location,dropout,widths,B,T,K,steps,scale", SCAN_CASES)
def test_train_fwd_kernel_matches_plain(cuda, dtype, norm, location, dropout, widths, B, T, K,
                                        steps, scale):
    """Every forward stack: rel L2 within 1e-5 in float32 (sum order only)
    and 1e-2 in bf16 (1-ulp flips of stored bf16 values, 2^-8 relative);
    2 launches a step plus one."""
    from your_voice_tts_torch.ops.taco2_train import (taco2_train_fwd, taco2_train_fwd_cuda,
                                                      taco2_train_fwd_plain)

    w, x, (m_a, m_d) = train_case(dtype, norm, location, dropout, cuda, widths, B=B, T=T,
                                  steps=steps, K=K, scale=scale)
    args = (w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], m_a, m_d)
    before = taco2_train_fwd_cuda.launches
    got = taco2_train_fwd_cuda(*args, norm=norm)
    assert taco2_train_fwd_cuda.launches - before == 2 * steps + 1
    ref = taco2_train_fwd_plain(*args, norm=norm)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert rel_l2(got[k], ref[k]) <= tol, (k, rel_l2(got[k], ref[k]))
    assert torch.equal(taco2_train_fwd(*args, norm=norm)["align"], got["align"])


@pytest.mark.parametrize("dtype,norm,B,T", [(torch.bfloat16, "sigmoid", 40, 37),
                                             (torch.float32, "softmax", 11, 13)])
def test_train_fwd_dependent_launches_change_nothing(cuda, dtype, norm, B, T):
    """The forward's programmatic dependent launches give the bits of the
    same launches run one after another (the serial probe); the probe is
    not counted."""
    from your_voice_tts_torch.ops.taco2_train import (taco2_train_fwd_cuda,
                                                      taco2_train_fwd_probe_cuda)

    w, x, (m_a, m_d) = train_case(dtype, norm, True, True, cuda, B=B, T=T)
    args = (w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], m_a, m_d)
    got = taco2_train_fwd_cuda(*args, norm=norm)
    before = taco2_train_fwd_cuda.launches
    ref = taco2_train_fwd_probe_cuda(*args, norm=norm, probe="serial")
    torch.cuda.synchronize()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert taco2_train_fwd_cuda.launches == before


def test_train_fwd_probes_run(cuda):
    """Every probe launch of the forward scan (the attention or the LSTM
    products stopped after each phase, the serial launches) runs, returns
    the outputs' shapes and is not counted."""
    from your_voice_tts_torch.ops.taco2_train import (FWD_PROBES, taco2_train_fwd_cuda,
                                                      taco2_train_fwd_probe_cuda)

    w, x, (m_a, m_d) = train_case(torch.bfloat16, "softmax", True, True, cuda, B=11, T=13)
    args = (w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], m_a, m_d)
    ref = taco2_train_fwd_cuda(*args, norm="softmax")
    before = taco2_train_fwd_cuda.launches
    for name in FWD_PROBES:
        got = taco2_train_fwd_probe_cuda(*args, norm="softmax", probe=name)
        torch.cuda.synchronize()
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    assert taco2_train_fwd_cuda.launches == before


@pytest.mark.parametrize("dtype,T", [(torch.bfloat16, 600), (torch.float32, 400),
                                     (torch.bfloat16, 1400)])
def test_train_fwd_long_text_reads_the_encoder_from_global_memory(cuda, dtype, T):
    """Full width past the text length whose encoder columns fit a block's
    shared memory (T_in 484 in bf16, 296 in float32): the attention forward
    reads them from global memory and holds the plain version at the
    tolerances of test_train_fwd_kernel_matches_plain. Past T_in 1,460 the
    rest of its shared memory no longer fits, and the wrapper raises."""
    from your_voice_tts_torch.ops.taco2_train import (taco2_train_fwd_cuda,
                                                      taco2_train_fwd_plain)

    w, x, (m_a, m_d) = train_case(dtype, "softmax", True, True, cuda, FULL_WIDTH, B=3, T=T,
                                  steps=4, K=31, scale=0.03)
    args = (w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], m_a, m_d)
    got = taco2_train_fwd_cuda(*args, norm="softmax")
    ref = taco2_train_fwd_plain(*args, norm="softmax")
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for k in ref:
        assert rel_l2(got[k], ref[k]) <= tol, (k, rel_l2(got[k], ref[k]))
    w, x, (m_a, m_d) = train_case(dtype, "softmax", True, True, cuda, FULL_WIDTH, B=1, T=1500,
                                  steps=1, K=31, scale=0.03)
    with pytest.raises(ValueError, match="shared memory"):
        taco2_train_fwd_cuda(w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], m_a, m_d)


@pytest.mark.parametrize("which", ["lstm", "attn"])
def test_train_fwd_refused_cluster_raises(cuda, monkeypatch, which):
    """A cluster the card cannot place (32 blocks, past the hardware's 16)
    makes the forward scan raise; nothing falls back to the plain version."""
    from your_voice_tts_torch.ops import taco2_train as tt

    plan = tt.fwd_plan

    def too_large(dims, B, T):
        p = plan(dims, B, T)
        (p if which == "lstm" else p["attn"])["cluster"] = 32
        return p

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(tt, "fwd_plan", too_large)
    monkeypatch.setattr(tt, "taco2_train_fwd_plain", no_plain)
    w, x, (m_a, m_d) = train_case(torch.bfloat16, "sigmoid", True, True, cuda)
    with pytest.raises(RuntimeError, match="taco2_train_fwd_scan"):
        tt.taco2_train_fwd(w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], m_a, m_d)
    torch.cuda.synchronize()


def train_bwd_args(w, x, m_a, m_d, norm, cuda):
    """The plain forward's residuals and seeded cotangents: the backward's
    arguments."""
    from your_voice_tts_torch.ops.taco2_train import taco2_train_fwd_plain

    fwd = taco2_train_fwd_plain(w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], m_a, m_d,
                                norm=norm)
    sh = lambda s: torch.cat([torch.zeros_like(s[:1]), s[:-1]])  # noqa: E731
    res = {k: fwd[k] for k in ("g_a", "g_d", "c_a", "c_d")}
    res.update(c_a_prev=sh(fwd["c_a"]), c_d_prev=sh(fwd["c_d"]), att_prev=sh(fwd["align"]),
               cum_prev=sh(torch.cumsum(fwd["align"], 0)))
    g = torch.Generator().manual_seed(4)
    cot = [torch.randn(*s.shape, generator=g).to(s.dtype).to(cuda)
           for s in (fwd["dech"], fwd["ctx"], fwd["align"])]
    return (w, res, *cot, x["enc"], x["pinp"], x["maskf"], m_a, m_d)


@pytest.mark.parametrize("dtype,norm,location,dropout,widths,B,T,K,steps,scale", SCAN_CASES)
def test_train_bwd_kernel_matches_plain(cuda, dtype, norm, location, dropout, widths, B, T, K,
                                        steps, scale):
    """The plain forward's residuals and seeded cotangents on both sides;
    every output rel L2 within 1e-4 in float32 and 2e-2 in bf16; four
    launches a step."""
    from your_voice_tts_torch.ops.taco2_train import taco2_train_bwd_cuda, taco2_train_bwd_plain

    w, x, (m_a, m_d) = train_case(dtype, norm, location, dropout, cuda, widths, B=B, T=T,
                                  steps=steps, K=K, scale=scale)
    args = train_bwd_args(w, x, m_a, m_d, norm, cuda)
    before = taco2_train_bwd_cuda.launches
    got = taco2_train_bwd_cuda(*args, norm=norm)
    assert taco2_train_bwd_cuda.launches - before == 4 * steps
    ref = taco2_train_bwd_plain(*args, norm=norm)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert rel_l2(got[k], ref[k]) <= tol, (k, rel_l2(got[k], ref[k]))


@pytest.mark.parametrize("dtype,norm,B,T", [(torch.bfloat16, "sigmoid", 40, 37),
                                             (torch.float32, "softmax", 11, 13)])
def test_train_bwd_dependent_launches_change_nothing(cuda, dtype, norm, B, T):
    """The scan's programmatic dependent launches give the bits of the same
    launches run one after another (the serial probe), and the probe is not
    counted."""
    from your_voice_tts_torch.ops.taco2_train import (taco2_train_bwd_cuda,
                                                      taco2_train_bwd_probe_cuda)

    w, x, (m_a, m_d) = train_case(dtype, norm, True, True, cuda, B=B, T=T)
    args = train_bwd_args(w, x, m_a, m_d, norm, cuda)
    got = taco2_train_bwd_cuda(*args, norm=norm)
    before = taco2_train_bwd_cuda.launches
    ref = taco2_train_bwd_probe_cuda(*args, norm=norm, probe="serial")
    torch.cuda.synchronize()
    assert taco2_train_bwd_cuda.launches == before
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_train_bwd_probes_run(cuda):
    """Every probe launch of the backward scan (the attention backward
    stopped after each phase, and the serial launches) runs, returns the
    outputs' shapes and is not counted."""
    from your_voice_tts_torch.ops.taco2_train import (BWD_PROBES, taco2_train_bwd_cuda,
                                                      taco2_train_bwd_probe_cuda)

    w, x, (m_a, m_d) = train_case(torch.bfloat16, "softmax", True, True, cuda, B=11, T=13)
    args = train_bwd_args(w, x, m_a, m_d, "softmax", cuda)
    ref = taco2_train_bwd_cuda(*args, norm="softmax")
    before = taco2_train_bwd_cuda.launches
    for name in BWD_PROBES:
        got = taco2_train_bwd_probe_cuda(*args, norm="softmax", probe=name)
        torch.cuda.synchronize()
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    assert taco2_train_bwd_cuda.launches == before


@pytest.mark.parametrize("which", ["d", "a", "attn"])
def test_train_bwd_refused_cluster_raises(cuda, monkeypatch, which):
    """A cluster the card cannot place (32 blocks, past the hardware's 16)
    makes the scan raise; nothing falls back to the plain version."""
    from your_voice_tts_torch.ops import taco2_train as tt

    plan = tt.bwd_plan

    def too_large(dims, B, T):
        p = plan(dims, B, T)
        p[which]["cluster"] = 32
        return p

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(tt, "bwd_plan", too_large)
    monkeypatch.setattr(tt, "taco2_train_bwd_plain", no_plain)
    w, x, (m_a, m_d) = train_case(torch.bfloat16, "sigmoid", True, True, cuda)
    args = train_bwd_args(w, x, m_a, m_d, "sigmoid", cuda)
    with pytest.raises(RuntimeError, match="taco2_train_bwd_scan"):
        tt.taco2_train_bwd(*args)
    torch.cuda.synchronize()


# --- the training scans at the speaker-conditioned widths -------------------

@pytest.mark.parametrize("E,T", [(768, 128), (1024, 128), (1024, 320)])
def test_train_kernels_at_conditioned_widths(cuda, E, T):
    """Full width with the memory E = 512 + spk_dim wide (768: 256-wide
    d-vectors; 1,024: the 512-wide speaker table): at T_in 128 the forward's
    attention stages the encoder's columns, at E = 1,024 and T_in 320 (past
    the staged limit of 297) it reads them from global memory. Both scans
    hold their plain versions at test_train_fwd_kernel_matches_plain's and
    test_train_bwd_kernel_matches_plain's bf16 tolerances."""
    from your_voice_tts_torch.ops.taco2_train import (attn_fwd_smem, fwd_plan, t_in_limits,
                                                      taco2_train_bwd_cuda,
                                                      taco2_train_bwd_plain,
                                                      taco2_train_fwd_cuda,
                                                      taco2_train_fwd_plain)

    widths = (256, E, 1024, 1024, 128)
    w, x, (m_a, m_d) = train_case(torch.bfloat16, "sigmoid", True, True, cuda, widths, B=8,
                                  T=T, steps=6, K=31, scale=0.03)
    staged = attn_fwd_smem(T, 128, 31, 1024, E, fwd_plan(w["dims"], 8, T)["attn"]["cluster"],
                           2)[1]
    assert staged == (T <= t_in_limits(w["dims"], 2)["fwd_staged"]) == (T == 128)
    args = (w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], m_a, m_d)
    got = taco2_train_fwd_cuda(*args)
    ref = taco2_train_fwd_plain(*args)
    torch.cuda.synchronize()
    for k in ref:
        assert rel_l2(got[k], ref[k]) <= 1e-2, (k, rel_l2(got[k], ref[k]))
    bargs = train_bwd_args(w, x, m_a, m_d, "sigmoid", cuda)
    got = taco2_train_bwd_cuda(*bargs)
    ref = taco2_train_bwd_plain(*bargs)
    torch.cuda.synchronize()
    for k in ref:
        assert rel_l2(got[k], ref[k]) <= 2e-2, (k, rel_l2(got[k], ref[k]))


def test_attention_shared_memory_mirrors_the_c_layout(cuda):
    """`attn_fwd_smem` and `attn_bwd_smem`, which `t_in_limits` and the
    wrapper's docstring read, give the C layout functions' bytes at every
    memory width, T_in around each limit, both element sizes and every
    cluster size."""
    from your_voice_tts_torch.ops.taco2_train import (_lib, attn_bwd_smem, attn_fwd_smem,
                                                      t_in_limits)

    lib = _lib()
    for E in (512, 768, 1024):
        for esize in (2, 4):
            lim = t_in_limits({"A": 128, "K": 31, "H1": 1024, "E": E}, esize)
            for T in (3, 37, 128, *(v + d for v in lim.values() for d in (0, 1))):
                for cs in (1, 2, 4):
                    assert attn_fwd_smem(T, 128, 31, 1024, E, cs, esize)[0] == \
                        lib.taco2_train_attn_fwd_smem(T, 128, 31, 1024, E, cs, esize == 2)
                    assert attn_bwd_smem(T, 128, 31, E, 1024, 1024, cs, esize) == \
                        lib.taco2_train_attn_bwd_smem(T, 128, 31, E, 1024, 1024, cs,
                                                      esize == 2)


@pytest.mark.parametrize("kind", ["table", "dvec+gst"])
def test_conditioned_train_step_on_the_card(cuda, kind):
    """A speaker-conditioned Tacotron2 at smoke widths (the 512-wide table,
    E = 544; or 24-wide d-vectors with GST, E = 56) in float32, dropout off:
    the loss and every gradient leaf, the table's and the GST's included,
    on the kernels against the plain versions on the card, within 1e-4 of
    each leaf's largest magnitude (float32 sums in another order), and the
    GST's running statistics moved the same."""
    import dataclasses

    import your_voice_tts_torch.models.decoder_grad as dg
    from your_voice_tts_torch.config import GSTConfig, load_config
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.models.losses import TacotronLoss
    from your_voice_tts_torch.ops.taco2_train import taco2_train_bwd_plain, taco2_train_fwd_plain

    cfg = load_config("configs/smoke_synthetic.json")
    sp = dict(use_speaker_embedding=True)
    if kind != "table":
        sp.update(use_external_speaker_embedding_file=True, speaker_embedding_dim=24,
                  use_gst=True, gst=GSTConfig(gst_embedding_dim=32, gst_num_heads=4,
                                              gst_style_tokens=6))
    cfg = dataclasses.replace(cfg, speakers=dataclasses.replace(cfg.speakers, **sp))
    model = setup_model(60, cfg, device=cuda, num_speakers=4,
                        speaker_embedding_dim=sp.get("speaker_embedding_dim", 0))
    model.train()
    g = torch.Generator().manual_seed(0)
    B, T, Tm = 5, 17, 40
    tl = torch.tensor([17, 15, 12, 9, 6])
    ml = torch.tensor([40, 33, 28, 21, 14])
    text = torch.randint(1, 60, (B, T), generator=g) * (torch.arange(T) < tl[:, None])
    mel = torch.randn(B, Tm, 20, generator=g) * (torch.arange(Tm) < ml[:, None])[..., None]
    stop = (torch.arange(Tm // 2) >= ((ml + 1) // 2 - 1)[:, None]).float()
    kw = dict(speaker_ids=torch.tensor([0, 3, 1, 2, 1], device=cuda),
              speaker_embeddings=torch.randn(B, 24, generator=g).to(cuda))
    crit = TacotronLoss("Tacotron2", stopnet_pos_weight=10.0, ga_alpha=5.0)
    bufs0 = {k: v.clone() for k, v in model.named_buffers()}
    out = {}
    for route, fns in (("kernel", (dg.taco2_train_fwd, dg.taco2_train_bwd)),
                       ("plain", (taco2_train_fwd_plain, taco2_train_bwd_plain))):
        kept = dg.taco2_train_fwd, dg.taco2_train_bwd
        dg.taco2_train_fwd, dg.taco2_train_bwd = fns
        try:
            with torch.no_grad():
                for k, v in model.named_buffers():
                    v.copy_(bufs0[k])
            o = model(text.to(cuda), tl.to(cuda), mel.to(cuda), mel_lengths=ml.to(cuda), r=2,
                      **kw)
            loss, _ = crit(o, mel.to(cuda), ml.to(cuda), stop.to(cuda), tl.to(cuda), step=0,
                           r=2)
            params = [p for p in model.parameters() if p.requires_grad]
            out[route] = (loss.item(), torch.autograd.grad(loss, params), o["state"])
        finally:
            dg.taco2_train_fwd, dg.taco2_train_bwd = kept
    (lk, gk, sk), (lp, gp, stp) = out["kernel"], out["plain"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert any(n.startswith("speaker_embedding" if kind == "table" else "gst.") for n in names)
    gscale = max(float(c.abs().max()) for c in gp)
    for n, a, c in zip(names, gk, gp):
        err = float((a - c).abs().max()) / max(float(c.abs().max()), 1e-2 * gscale)
        assert err <= 1e-4, (n, err)
    for k in stp:
        torch.testing.assert_close(sk[k], stp[k], rtol=1e-5, atol=1e-6)


def wavernn_case(mode, bits, cuda, n_mels=20, B=3, L=96, width=32, model_out=None):
    """A small WaveRNN (R = F = width, aux 4) with seeded random weights and
    inputs on the card."""
    from your_voice_tts_torch.ops.wavernn_gen import generation_weights
    from your_voice_tts_torch.vocoder.models.wavernn import WaveRNN

    model = WaveRNN(n_mels=n_mels, bits=bits, rnn_dims=width, fc_dims=width, compute_dims=16,
                    res_out_dims=16, num_res_blocks=2, mode=mode, num_mixtures=4,
                    device=cuda, seed=1)
    if model_out is not None:
        model_out.append(model)
    g = torch.Generator().manual_seed(2)
    return (generation_weights(model), torch.randn(B, L, n_mels, generator=g).to(cuda),
            torch.randn(B, L, 16, generator=g).to(cuda))


def hold_wavernn(w, cond, aux, **kw):
    """Kernel against plain on the same draws: mu-law classes identical at
    every row-step, samples within 1e-5 (float32 sums in another order)."""
    from your_voice_tts_torch.ops.wavernn_gen import wavernn_generate_cuda, wavernn_generate_plain
    from your_voice_tts_torch.vocoder.models.wavernn import encode_mulaw

    got = wavernn_generate_cuda(w, cond, aux, 7, **kw)
    ref = wavernn_generate_plain(w, cond, aux, 7, **kw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == cond.shape[:2] and bool(torch.isfinite(got).all())
    if kw["mode"] == "mulaw":
        assert torch.equal(encode_mulaw(got, kw["bits"]), encode_mulaw(ref, kw["bits"]))
    assert float((got - ref).abs().max()) <= 1e-5
    return got


@pytest.mark.parametrize("B,bits,mode,greedy", [
    (1, 8, "mulaw", True), (1, 8, "mulaw", False), (1, 8, "mol", False), (1, 8, "gauss", False),
    (9, 8, "mulaw", True), (9, 8, "mulaw", False), (9, 8, "mol", False), (9, 8, "gauss", True),
    (3, 6, "mulaw", False), (3, 6, "mulaw", True)])
def test_wavernn_kernel_at_batch_edges(cuda, B, bits, mode, greedy):
    """One row (a sub-tile of 1), 9 rows (a full sub-tile of 8 and a partial
    one), 6 bits (64 classes in a 128-padded Gumbel row)."""
    w, cond, aux = wavernn_case(mode, bits, cuda, B=B, L=64)
    hold_wavernn(w, cond, aux, bits=bits, mode=mode, num_mixtures=4, greedy=greedy)


@pytest.mark.parametrize("mode,greedy", [("mulaw", False), ("mulaw", True), ("gauss", False)])
def test_wavernn_kernel_at_wide_units(cuda, mode, greedy):
    """R = F = 768: six units a block, so the weight slice leaves room for
    one 8-row tile and 9 rows take two tiles a stage."""
    from your_voice_tts_torch.ops.wavernn_gen import launch_shape

    w, cond, aux = wavernn_case(mode, 8, cuda, B=9, L=32, width=768)
    shape = launch_shape(9, 32, 20, 4, 768, 768, w["fc3_w"].shape[0], mode, 4)
    assert shape["tile_rows"] == 8 and shape["tiles"] == 2
    hold_wavernn(w, cond, aux, bits=8, mode=mode, num_mixtures=4, greedy=greedy)


def test_wavernn_launch_plan_at_the_default_config(cuda):
    """WaveRNNConfig's widths: five barriers a step, a 500-frame row's 22
    folds in one tile, a 1400-frame mel's 60 in two."""
    from your_voice_tts_torch.ops.wavernn_gen import launch_shape

    for B, tiles in ((22, 1), (60, 2)):
        shape = launch_shape(B, 6600, 80, 32, 512, 512, 1024)
        assert shape["barriers_per_step"] == 5 and shape["tiles"] == tiles
        assert shape["blocks_per_sm"] >= 1 and shape["smem_bytes"] <= 232_448


@pytest.mark.parametrize("probe", ["no_dots", "no_staging", "no_sampling", "barriers_only"])
def test_wavernn_probe_launches_run(cuda, probe):
    """Each probe launch runs to its end on the grid of the full one, and
    counts no launch."""
    from your_voice_tts_torch.ops.wavernn_gen import wavernn_generate_cuda, wavernn_probe_cuda

    w, cond, aux = wavernn_case("mulaw", 8, cuda, B=9, L=32)
    before = wavernn_generate_cuda.launches
    wavernn_probe_cuda(w, cond, aux, probe, bits=8)
    torch.cuda.synchronize()
    assert wavernn_generate_cuda.launches == before


def test_wavernn_model_sees_a_weight_edit_between_calls(cuda):
    """WaveRNN keeps its packed layout between calls and packs again after
    an in-place edit: the second call follows the edited weights."""
    from your_voice_tts_torch.ops.wavernn_gen import generation_weights, wavernn_generate_plain
    from your_voice_tts_torch.vocoder.models.wavernn import encode_mulaw

    models = []
    _, cond, aux = wavernn_case("mulaw", 8, cuda, B=3, L=48, model_out=models)
    model = models[0]
    first = model._decode(cond, aux, 7)
    packed = model.packed_weights()
    assert model.packed_weights() is packed
    with torch.no_grad():
        model.fc3.bias[5] += 50.0                       # class 5 wins every draw
    second = model._decode(cond, aux, 7)
    assert model.packed_weights() is not packed
    ref = wavernn_generate_plain(generation_weights(model), cond, aux, 7, bits=8)
    torch.cuda.synchronize()
    assert not torch.equal(first, second)
    assert torch.equal(encode_mulaw(second, 8), encode_mulaw(ref, 8))


@pytest.mark.parametrize("mode,bits,greedy,n_mels", [
    ("mulaw", 8, True, 20), ("mulaw", 6, False, 20), ("mol", 8, False, 20),
    ("gauss", 8, False, 20), ("mulaw", 8, False, 18)])
def test_wavernn_kernel_matches_plain(cuda, mode, bits, greedy, n_mels):
    """Same hash-PRNG draws on both sides: mu-law classes identical over
    all 96 steps, samples within 1e-5 (float32 sums in another order).
    n_mels 18 makes the stream width 34, not a multiple of 4: the kernel's
    element-by-element staging."""
    from your_voice_tts_torch.ops.wavernn_gen import (wavernn_generate, wavernn_generate_cuda,
                                                      wavernn_generate_plain)
    from your_voice_tts_torch.vocoder.models.wavernn import encode_mulaw

    w, cond, aux = wavernn_case(mode, bits, cuda, n_mels)
    kw = dict(bits=bits, mode=mode, num_mixtures=4, greedy=greedy)
    got = wavernn_generate_cuda(w, cond, aux, 7, **kw)
    ref = wavernn_generate_plain(w, cond, aux, 7, **kw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (3, 96) and bool(torch.isfinite(got).all())
    if mode == "mulaw":
        assert torch.equal(encode_mulaw(got, bits), encode_mulaw(ref, bits))
    assert float((got - ref).abs().max()) <= 1e-5
    assert torch.equal(wavernn_generate(w, cond, aux, 7, **kw), got)


def test_wavernn_kernel_refuses_what_it_does_not_take(cuda):
    from your_voice_tts_torch.ops.wavernn_gen import wavernn_generate_cuda

    w, cond, aux = wavernn_case("mulaw", 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        wavernn_generate_cuda(w, cond.double(), aux, 0, bits=8)
    with pytest.raises(ValueError, match="must be"):
        wavernn_generate_cuda(w, cond, aux[:, :, :15], 0, bits=8)
    with pytest.raises(ValueError, match="contiguous"):
        wavernn_generate_cuda(w, cond.transpose(0, 1).contiguous().transpose(0, 1), aux, 0,
                              bits=8)
    with pytest.raises(ValueError, match="needs"):
        wavernn_generate_cuda(w, cond, aux, 0, bits=6)


def taco1_case(cuda, norm="sigmoid", r=2, memory=5, B=11, T=13, push_rows=(3,), seed=1,
               location=True, K=15):
    """A small Tacotron(1) decoder (width 32, 20 mels, attention 24, filter
    K, r_init 5) with seeded random weights, on the card; `push_rows` pushed
    to stop at once through the folded stop row's context direction."""
    from your_voice_tts_torch.models.tacotron import Tacotron

    cfg = ModelConfig(model="Tacotron", r=r, memory_size=memory, tacotron_width=32,
                      attention_dim=24, attention_location_filters=8,
                      attention_location_kernel_size=K, attention_norm=norm,
                      location_attn=location)
    dec = Tacotron(30, cfg, n_mels=20, num_freq=129, r_init=5, device=cuda, seed=seed).decoder
    w = dec.decode_weights(torch.bfloat16)
    d = w["dims"]
    g = torch.Generator().manual_seed(seed)
    enc = (0.5 * torch.randn(B, T, d["E"], generator=g)).to(cuda)
    s = w["m_w"][-1, :d["D"]].float()
    v = w["pj_w"][:, d["H"]:d["H"] + d["E"]].float().T @ s
    for row in push_rows:
        enc[row] += 20.0 * v / (v @ v)
    pinp = dec.attention.preprocess_inputs(enc).detach()
    mask = sequence_mask((T - torch.arange(B, device=cuda) % T).clamp_min(2), T)
    return w, enc, pinp, mask


# norm, r, memory, prenet dropout, B, location features, filter taps, T
TACO1_CASES = [("sigmoid", 2, 5, True, 11, True, 15, 13),
               ("softmax", 5, 5, True, 11, True, 15, 13),
               ("sigmoid", 3, 5, False, 11, True, 15, 13),
               ("sigmoid", 4, 2, True, 11, True, 15, 13),
               ("sigmoid", 2, 5, True, 1, True, 15, 13),
               ("softmax", 2, 5, True, 8, True, 15, 13),
               ("sigmoid", 5, 2, True, 40, True, 15, 13),
               ("softmax", 2, 5, True, 11, False, 15, 13),
               ("sigmoid", 3, 5, True, 11, True, 35, 40),
               ("softmax", 4, 5, False, 8, True, 35, 40)]


@pytest.mark.parametrize("norm,r,memory,dropout,B,location,K,T", TACO1_CASES)
def test_taco1_decode_kernel_matches_plain(cuda, norm, r, memory, dropout, B, location, K, T):
    """One persistent launch a decode, held against the plain version: bf16
    on both sides, the same hash-PRNG dropout masks, f32 sums in other
    orders; r past the memory keeps the step's last frames; one row pushed
    to stop at once. Filters past 32 taps: a warp stages the window 32 taps
    a pass."""
    from your_voice_tts_torch.ops.taco1_decode import (tacotron1_decode, tacotron1_decode_cuda,
                                                       tacotron1_decode_plain)

    row = min(3, B - 1)
    w, enc, pinp, mask = taco1_case(cuda, norm, r, memory, B=B, T=T, push_rows=(row,),
                                    location=location, K=K)
    kw = dict(r=r, max_steps=30, seed=5, chunk=7, norm=norm, prenet_dropout=dropout)
    before = tacotron1_decode_cuda.launches
    got = tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron1_decode_cuda.launches == before + 1
    ref = tacotron1_decode_plain(w, enc, pinp, mask, **kw)
    torch.cuda.synchronize()
    assert int(got[3][row]) == 1
    assert_decode_holds(got, ref)
    assert torch.equal(tacotron1_decode(w, enc, pinp, mask, **kw)[0], got[0])


@pytest.mark.parametrize("B", [3, 11])
def test_taco1_decode_kernel_exits_early_on_the_device(cuda, B):
    """Every row stops at its first step, inside the first chunk: the
    kernel leaves at the first chunk boundary, as `_drive` does, writes 7
    steps to its device int, and the later chunks come back zero."""
    from your_voice_tts_torch.ops.taco1_decode import (_launch, tacotron1_decode_cuda,
                                                       tacotron1_decode_plain)

    w, enc, pinp, mask = taco1_case(cuda, B=B, push_rows=range(B))
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, norm="sigmoid", prenet_dropout=True)
    got = tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron1_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1] * B
    assert_decode_holds(got, ref)
    assert got[1][:7].any() and not got[1][7:].any() and not got[2][7:].any()
    assert int(_launch(w, enc, pinp, mask, thresh=0.6, probe=0, **kw)[3].item()) == 7
    kw["max_steps"] = 7                            # no boundary inside the decode
    assert int(_launch(w, enc, pinp, mask, thresh=0.6, probe=0, **kw)[3].item()) == 7


def test_taco1_decode_kernel_in_batch_slices(cuda, monkeypatch):
    """A batch one launch cannot hold (a smaller limit of shared memory
    stands in for a larger batch) runs as slices of whole batch tiles; every
    row of the first slice stops at once, so that slice leaves at the first
    chunk boundary and runs again to the others' step count: the same
    outputs as one launch over the whole batch, and as plain."""
    from your_voice_tts_torch.ops import taco1_decode as dec
    from your_voice_tts_torch.ops.taco2_decode import batch_slices

    B, T = 40, 13
    w, enc, pinp, mask = taco1_case(cuda, B=B, T=T, push_rows=range(16))
    kw = dict(r=2, max_steps=30, seed=5, chunk=7, prenet_dropout=True)
    one = dec.tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
    G = dec._blocks(enc.device)
    monkeypatch.setattr(dec, "SMEM_LIMIT", dec.launch_plan(w["dims"], 16, T, G)["smem_bytes"])
    assert batch_slices(w["dims"], B, T, G, plan=dec.launch_plan) == [(0, 16), (16, 32),
                                                                       (32, 40)]
    before = dec.tacotron1_decode_cuda.launches
    got = dec.tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
    ref = dec.tacotron1_decode_plain(w, enc, pinp, mask, **kw)
    assert_decode_holds(got, ref)
    for a, b in zip(got, one):
        assert torch.equal(a, b)
    rans = [min(-(-int(ref[3][b0:b1].max()) // 7) * 7, 35) for b0, b1 in
            [(0, 16), (16, 32), (32, 40)]]
    assert rans[0] == 7 < max(rans) and got[3][:16].tolist() == [1] * 16
    again = sum(r < max(rans) for r in rans)
    assert dec.tacotron1_decode_cuda.launches == before + 3 + again


def taco1_full_width_case(cuda, B, push_rows, T=160, spk_dim=None):
    """The Tacotron(1) path's widths (width 256, memory 5, 80 mels, r_init
    7, attention 128, filter 31), seeded random weights, the stop bias at
    -10 and `push_rows` pushed to stop at once. spk_dim conditions the
    model on 4 speakers (d-vectors of that width, or with 0 its 256-wide
    table): the memory is E = 256 + 256 = 512 wide."""
    from your_voice_tts_torch.models.tacotron import Tacotron

    cfg = ModelConfig(model="Tacotron", r=7, memory_size=5, tacotron_width=256,
                      attention_dim=128)
    spk = {} if spk_dim is None else dict(num_speakers=4, speaker_embedding_dim=spk_dim)
    dec = Tacotron(60, cfg, n_mels=80, num_freq=513, r_init=7, device=cuda, seed=2,
                   **spk).decoder
    with torch.no_grad():
        dec.stopnet.bias.fill_(-10.0)
    w = dec.decode_weights(torch.bfloat16)
    d = w["dims"]
    g = torch.Generator().manual_seed(4)
    enc = (0.5 * torch.randn(B, T, d["E"], generator=g)).to(cuda)
    v = w["pj_w"][:, d["H"]:d["H"] + d["E"]].float().T @ w["m_w"][-1, :d["D"]].float()
    enc[list(push_rows)] += 60.0 * v / (v @ v)
    pinp = dec.attention.preprocess_inputs(enc).detach()
    mask = sequence_mask(T - 4 * (torch.arange(B, device=cuda) % 32), T)
    return w, enc, pinp, mask


def test_taco1_decode_kernel_at_full_width(cuda):
    """Full width, B=8, T=160, 40 steps, r = 7 past the memory of 5 frames,
    dropout on; row 0 stops at once; one unit group a block on the H100."""
    from your_voice_tts_torch.ops.taco1_decode import (tacotron1_decode_cuda,
                                                       tacotron1_decode_plain)

    w, enc, pinp, mask = taco1_full_width_case(cuda, 8, [0])
    assert w["dims"]["H"] == 256 and w["dims"]["OW"] == 560 and w["dims"]["K"] == 31
    kw = dict(r=7, max_steps=40, seed=7)
    got = tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron1_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1] + [40] * 7
    assert_decode_holds(got, ref)


@pytest.mark.parametrize("spk_dim", [256, 0])
@pytest.mark.parametrize("B", [8, 1])
def test_taco1_decode_kernel_at_e512(cuda, spk_dim, B):
    """A speaker-conditioned Tacotron(1)'s memory, the CBHG's 256 columns
    and a 256-wide d-vector or table row: E = 512, full width, T=160, 40
    steps, r = 7, dropout on; row 0 stops at once. The resident a_x and
    projection matrices, the staged context and the context chunks all
    grow with E; one launch, the same outputs as plain."""
    from your_voice_tts_torch.ops.taco1_decode import (_blocks, launch_plan,
                                                       tacotron1_decode_cuda,
                                                       tacotron1_decode_plain)

    w, enc, pinp, mask = taco1_full_width_case(cuda, B, [0], spk_dim=spk_dim)
    assert w["dims"]["E"] == 512
    plan = launch_plan(w["dims"], B, 160, _blocks(enc.device))
    assert plan["E16"] == 512 and plan["RES"] == 168
    kw = dict(r=7, max_steps=40, seed=7)
    before = tacotron1_decode_cuda.launches
    got = tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron1_decode_cuda.launches == before + 1
    ref = tacotron1_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1] + [40] * (B - 1)
    assert_decode_holds(got, ref)


def test_taco1_decode_kernel_at_e512_past_one_launch(cuda):
    """E = 512 past what one launch holds at T=160 (72 rows): B=80 runs as
    slices of whole tiles; the same outputs as plain."""
    from your_voice_tts_torch.ops.taco1_decode import (_blocks, launch_plan,
                                                       tacotron1_decode_cuda,
                                                       tacotron1_decode_plain)
    from your_voice_tts_torch.ops.taco2_decode import batch_slices

    B = 80
    w, enc, pinp, mask = taco1_full_width_case(cuda, B, range(0, B, 7), spk_dim=256)
    slices = batch_slices(w["dims"], B, 160, _blocks(enc.device), plan=launch_plan)
    assert len(slices) == 2
    kw = dict(r=7, max_steps=20, seed=7)
    before = tacotron1_decode_cuda.launches
    got = tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
    assert tacotron1_decode_cuda.launches - before >= 2
    ref = tacotron1_decode_plain(w, enc, pinp, mask, **kw)
    assert got[3].tolist() == [1 if b % 7 == 0 else 20 for b in range(B)]
    assert_decode_holds(got, ref)


def test_gst_on_the_card_matches_the_cpu(cuda):
    """The GST at its default widths (80 mels, 256 / 4 heads / 10 tokens,
    projected to 512; cuDNN convolutions and GRU, TF32 off) against the
    same weights on the CPU, BatchNorm running statistics moved off (0, 1):
    1e-5 in float32; its bf16 copy within 5e-2 of float32."""
    from your_voice_tts_torch.models.common import compute_copy
    from your_voice_tts_torch.models.gst import GST

    g = torch.Generator().manual_seed(0)
    cpu = GST(80, 512)
    cpu.init_random_(g)
    with torch.no_grad():
        for blk in cpu.ref.convs:
            blk.bn.running_mean.normal_(0.0, 0.3, generator=g)
            blk.bn.running_var.uniform_(0.5, 2.0, generator=g)
    cpu.eval()
    card = GST(80, 512).to(cuda).eval()
    card.load_state_dict(cpu.state_dict())
    mel = torch.randn(4, 173, 80, generator=g)
    with torch.no_grad():
        ref = cpu(mel)
        got = card(mel.to(cuda)).cpu()
        assert float((got - ref).abs().max()) <= 1e-5
        holder = torch.nn.Module()
        holder.gst = card
        half = compute_copy(holder, "gst", torch.bfloat16)(mel.to(cuda, torch.bfloat16))
    assert half.dtype == torch.bfloat16
    assert float((half.float().cpu() - ref).abs().max()) <= 5e-2


@pytest.mark.parametrize("probe", ["barriers_only", "copies_only", "dots_only"])
def test_taco1_probe_launches_run(cuda, probe):
    from your_voice_tts_torch.ops.taco1_decode import (tacotron1_decode_cuda,
                                                       tacotron1_decode_probe_cuda)

    w, enc, pinp, mask = taco1_case(cuda)
    before = tacotron1_decode_cuda.launches
    tacotron1_decode_probe_cuda(w, enc, pinp, mask, probe, r=2, max_steps=20)
    torch.cuda.synchronize()
    assert tacotron1_decode_cuda.launches == before     # probes are not counted


def test_taco1_profile_launch_times_every_round(cuda):
    """The profiling instantiation serves (the same outputs) and returns
    each round's work and barrier wait; it is not counted as a launch."""
    from your_voice_tts_torch.ops.taco1_decode import (ROUNDS, tacotron1_decode_cuda,
                                                       tacotron1_decode_profile_cuda)

    w, enc, pinp, mask = taco1_case(cuda)
    before = tacotron1_decode_cuda.launches
    prof = tacotron1_decode_profile_cuda(w, enc, pinp, mask, r=2, max_steps=20)
    assert tacotron1_decode_cuda.launches == before and prof["steps"] == 50
    assert list(prof["rounds"]) == list(ROUNDS)
    assert all(v["work_max_us"] >= v["work_mean_us"] > 0 and v["wait_mean_us"] >= 0
               for v in prof["rounds"].values())


@pytest.mark.parametrize("n_fft,win,hop,B,T,per_row", [
    (256, 256, 64, 3, 37, False), (2048, 1102, 275, 2, 20, False), (128, 128, 32, 1, 2, True),
    (1024, 1024, 256, 3, 43, True), (384, 384, 96, 2, 7, False), (2048, 1102, 275, 8, 500, True),
    (4096, 4096, 1024, 1, 5, False), (2176, 2176, 545, 2, 9, True)])
def test_griffin_lim_full_kernel_matches_plain(cuda, n_fft, win, hop, B, T, per_row):
    """One and three FGLA iterations to the complex spectrum: bf16 loop
    state on both sides."""
    from your_voice_tts_torch.ops.griffin_lim import (griffin_lim_full, griffin_lim_full_cuda,
                                                      griffin_lim_full_plain)

    mag, phase = gl_inputs(cuda, n_fft, B, T, per_row)
    consts = packed_constants(n_fft, hop, hann_window(win, n_fft), torch.bfloat16, cuda)
    for n in (1, 3):
        got = griffin_lim_full_cuda(mag, phase, consts, n_iters=n, momentum=0.95)
        ref = griffin_lim_full_plain(mag, phase, consts, n_iters=n, momentum=0.95)
        assert got.shape == ref.shape == mag.shape and got.dtype == torch.complex64
        assert float((got - ref).abs().norm() / ref.abs().norm()) <= 1e-2
    assert torch.equal(griffin_lim_full(mag, phase, consts, n_iters=3, momentum=0.95), got)


@pytest.mark.parametrize("route,n_fft,hop,B,T", [("wave", 1024, 256, 3, 43),
                                                 ("full", 2048, 275, 2, 20),
                                                 ("wave", 128, 32, 1, 2),
                                                 ("full", 4096, 1024, 1, 5)])
def test_fgla_dependent_launches_change_nothing(cuda, route, n_fft, hop, B, T):
    """The packed loop's dependent launches give the bits of the same
    launches issued one after another (the serial probe), which counts no
    launch; the launches `gl_fgla` reports issuing are 3n + 2 (wave) or
    3n + 1 (full)."""
    from your_voice_tts_torch.ops.griffin_lim import fgla_serial_cuda, griffin_lim_full_cuda

    mag, phase = gl_inputs(cuda, n_fft, B, T, True)
    consts = packed_constants(n_fft, hop, hann_window(n_fft, n_fft), torch.bfloat16, cuda)
    fn = griffin_lim_wave_cuda if route == "wave" else griffin_lim_full_cuda
    before = fn.launches
    got = fn(mag, phase, consts, n_iters=5, momentum=0.95)
    assert fn.launches - before == 3 * 5 + (2 if route == "wave" else 1)
    ref = fgla_serial_cuda(mag, phase, consts, n_iters=5, momentum=0.95, route=route)
    assert fn.launches - before == 17 - (route == "full")
    assert torch.equal(got, ref)


def gl_iteration_case(cuda, n_fft, win, hop, B, T):
    """Seeded magnitudes [B, T, Kf], the spectrum from a shared seeded
    phase, and the unpacked bf16 constants, on the card."""
    from your_voice_tts_torch.ops.griffin_lim import unpacked_constants

    g = torch.Generator().manual_seed(1)
    mag = (torch.randn(B, T, n_fft // 2 + 1, generator=g).abs() + 0.1).to(cuda)
    ph = (torch.rand(T, n_fft // 2 + 1, generator=g) * 2 * np.pi).to(cuda)
    consts = unpacked_constants(n_fft, hop, hann_window(win, n_fft), torch.bfloat16, cuda)
    return mag * torch.cos(ph), mag * torch.sin(ph), mag, consts


# (1024, 256, 2, 40) one row tile short of 128; (256, 64, 2, 1,056) a batch
# past the whole-loop cap, as the router sends it; (2048, 1102, 275, 2, 20)
# the scalar OLA (hop % 4 != 0) at a 12.5 ms hop
@pytest.mark.parametrize("n_fft,win,hop,B,T", [(256, 256, 64, 3, 37), (1024, 1024, 256, 2, 40),
                                               (256, 256, 64, 2, 1056),
                                               (2048, 1102, 275, 2, 20)])
def test_gl_iteration_kernel_matches_plain(cuda, n_fft, win, hop, B, T):
    """One and three plain iterations on the unpacked layout: bf16 products
    on both sides."""
    from your_voice_tts_torch.ops.griffin_lim import (gl_iteration, gl_iteration_cuda,
                                                      gl_iteration_plain)

    Fr, Fi, mag, consts = gl_iteration_case(cuda, n_fft, win, hop, B, T)
    for n in (1, 3):
        got = gl_iteration_cuda(Fr, Fi, mag, consts, n_iters=n)
        ref = gl_iteration_plain(Fr, Fi, mag, consts, n_iters=n)
        for a, b in zip(got, ref):
            assert a.shape == b.shape == mag.shape
            assert float((a - b).norm() / b.norm()) <= 1e-2
    assert torch.equal(gl_iteration(Fr, Fi, mag, consts, n_iters=3)[0], got[0])


def test_gl_iteration_kernel_at_no_iteration(cuda):
    """n_iters = 0 launches nothing and returns the spectrum unchanged."""
    from your_voice_tts_torch.ops.griffin_lim import gl_iteration_cuda

    Fr, Fi, mag, consts = gl_iteration_case(cuda, 256, 256, 64, 2, 9)
    before = gl_iteration_cuda.launches
    got = gl_iteration_cuda(Fr, Fi, mag, consts, n_iters=0)
    assert gl_iteration_cuda.launches == before
    assert torch.equal(got[0], Fr) and torch.equal(got[1], Fi)


@pytest.mark.parametrize("n_fft,win,hop,B,T", [(1024, 1024, 256, 3, 43), (2048, 1102, 275, 1, 20),
                                               (384, 384, 96, 2, 7)])
def test_gl_iteration_dependent_launches_change_nothing(cuda, n_fft, win, hop, B, T):
    """Kernel 4's dependent launches give the bits of the same launches
    issued one after another (the serial probe, which counts no launch);
    the launches `gl_plain` reports issuing are 3n."""
    from your_voice_tts_torch.ops.griffin_lim import gl_iteration_cuda, gl_iteration_serial_cuda

    Fr, Fi, mag, consts = gl_iteration_case(cuda, n_fft, win, hop, B, T)
    before = gl_iteration_cuda.launches
    got = gl_iteration_cuda(Fr, Fi, mag, consts, n_iters=5)
    assert gl_iteration_cuda.launches - before == 15
    ref, issued = gl_iteration_serial_cuda(Fr, Fi, mag, consts, n_iters=5)
    assert issued == 15 and gl_iteration_cuda.launches - before == 15
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_gl_iteration_refused_plan_raises(cuda, monkeypatch):
    """`gl_plain` refuses a plan its kernels cannot run (here tiles of 64
    columns) before it launches anything."""
    from your_voice_tts_torch.ops import griffin_lim as gl

    Fr, Fi, mag, consts = gl_iteration_case(cuda, 256, 256, 64, 2, 9)
    plan = gl.gl_iteration_plan
    monkeypatch.setattr(gl, "gl_iteration_plan", lambda n_fft, hop, M, sms: {
        **plan(n_fft, hop, M, sms), **gl.product_plan(n_fft, M, 64)})
    before = gl.gl_iteration_cuda.launches
    with pytest.raises(RuntimeError, match="gl_plain"):
        gl.gl_iteration_cuda(Fr, Fi, mag, consts, n_iters=2)
    assert gl.gl_iteration_cuda.launches == before


@pytest.mark.parametrize("B,T,n_fft,hop", [(2, 64, 1024, 256), (3, 64, 256, 64),
                                           (1, 1056, 256, 64)])
def test_griffin_lim_router_on_the_card(cuda, B, T, n_fft, hop):
    """Each route on the card against the same route's plain versions on the
    CPU: the waveforms agree (bf16 loop state, one iteration)."""
    from your_voice_tts_torch.ops.griffin_lim import gl_constants, griffin_lim_batch

    g = torch.Generator().manual_seed(2)
    mag = torch.randn(B, T, n_fft // 2 + 1, generator=g).abs() + 0.1
    ph = torch.rand(T, n_fft // 2 + 1, generator=g) * 2 * np.pi
    w = hann_window(n_fft, n_fft)
    got = griffin_lim_batch(mag.to(cuda), ph.to(cuda), gl_constants(n_fft, hop, w, device=cuda),
                            n_iters=1, momentum=0.9).cpu()
    ref = griffin_lim_batch(mag, ph, gl_constants(n_fft, hop, w), n_iters=1, momentum=0.9)
    assert got.shape == ref.shape == (B, hop * (T - 1))
    assert float((got - ref).norm() / ref.norm()) <= 1e-2


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    from your_voice_tts_torch.ops.griffin_lim import (gl_iteration_cuda, griffin_lim_full_cuda,
                                                      unpacked_constants)
    from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode_cuda

    consts32 = packed_constants(256, 64, hann_window(256, 256), torch.float32, cuda)
    with pytest.raises(ValueError, match="bf16"):
        griffin_lim_full_cuda(torch.ones(1, 4, 129, device=cuda),
                              torch.zeros(4, 129, device=cuda), consts32, n_iters=1)
    u = unpacked_constants(256, 64, hann_window(256, 256), torch.bfloat16, "cpu")
    x = torch.ones(1, 4, 129, device=cuda)
    with pytest.raises(ValueError, match="bf16 constants"):
        gl_iteration_cuda(x, x, x, u)
    w, enc, pinp, mask = taco1_case(cuda)
    with pytest.raises(ValueError, match="r_init"):
        tacotron1_decode_cuda(w, enc, pinp, mask, r=6, max_steps=2)
    with pytest.raises(ValueError, match="shape"):
        tacotron1_decode_cuda(w, enc[:, :, :8], pinp, mask, r=2, max_steps=2)
    from your_voice_tts_torch.ops import taco1_decode as dec

    before = tacotron1_decode_cuda.launches
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    with pytest.MonkeyPatch.context() as mp:              # more blocks than fit the card
        mp.setattr(dec, "_blocks", lambda dev: 4 * sms + 8)
        with pytest.raises(RuntimeError, match="co-resident"):
            tacotron1_decode_cuda(w, enc, pinp, mask, r=2, max_steps=2)
    with pytest.MonkeyPatch.context() as mp:              # not even one batch tile fits
        mp.setattr(dec, "SMEM_LIMIT", 8 * 1024)
        with pytest.raises(ValueError, match="shared memory"):
            tacotron1_decode_cuda(w, enc, pinp, mask, r=2, max_steps=2)
    assert tacotron1_decode_cuda.launches == before


def test_registered_decode_op_launches_the_kernel(cuda):
    """`yvt::taco2_decode` on the card is the kernel (one launch counted, the
    packed layout passed in, not rebuilt) and holds its plain version; every
    row stops at once, so the frames past the last step run are zero on
    both."""
    from your_voice_tts_torch.ops import library
    from your_voice_tts_torch.ops.taco2_decode import pack_weights

    w, enc, pinp, mask = decode_case(cuda, 5, stop_rows=range(5))
    pack_weights(w)
    spec, tensors = library.flatten_weights(w)
    assert any(n.startswith("packed.") for n in __import__("json").loads(spec)["names"])
    seed = torch.tensor([5], device=cuda)
    kw = dict(r=2, max_steps=120, norm="sigmoid", thresh=0.6, prenet_dropout=True)
    before = tacotron2_decode_cuda.launches
    got = library.decode("taco2", spec, tensors, enc, pinp, mask, seed, **kw)
    assert tacotron2_decode_cuda.launches == before + 1
    ref = tacotron2_decode_plain(w, enc, pinp, mask, seed=5, chunk=50, **kw)
    assert_decode_holds(got, ref)
    assert got[0].shape == (120, 5, w["dims"]["OW"]) and got[3].tolist() == [1] * 5
    for t in (got, ref):            # the decode left at the first chunk boundary, step 50
        assert not t[0][1:].any() and t[1][:50].any() and not t[1][50:].any()
        assert not t[2][50:].any()


def test_cuda_artifact_launches_the_kernels(cuda, tmp_path):
    """A smoke-width Tacotron2 exported on the card and loaded: its call
    launches the decode kernel and the gl-full kernel (hop 64), runs no
    plain version, and equals its unexported program (lengths exact, wav
    1e-5). A Tacotron(1) artifact past 1,024 frames launches kernels 8 and
    4 likewise."""
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.config import AudioConfig
    from your_voice_tts_torch.infer.export import (ExportedSynthesizer, export_serving,
                                                   make_serving_fn)
    from your_voice_tts_torch.models.tacotron import Tacotron
    from your_voice_tts_torch.ops import griffin_lim as gl
    from your_voice_tts_torch.ops import taco1_decode as t1
    from your_voice_tts_torch.ops import taco2_decode as t2

    class Cfg:
        def __init__(self, model):
            self.model, self.audio, self.data = model, AudioConfig(
                num_mels=20, fft_size=256, sample_rate=8000, hop_length=64, win_length=256,
                griffin_lim_iters=4, mel_fmax=None), None

    small = dict(embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48, attention_rnn_dim=48,
                 attention_dim=24, attention_location_filters=8,
                 attention_location_kernel_size=15, prenet_dim=24, postnet_dim=32)
    cases = [("taco2", Cfg(ModelConfig(r=2, max_decoder_steps=10, **small)),
              t2.tacotron2_decode_cuda, gl.griffin_lim_full_cuda),
             ("taco1", Cfg(ModelConfig(model="Tacotron", r=7, memory_size=5, tacotron_width=32,
                                       attention_dim=24, max_decoder_steps=160)),
              t1.tacotron1_decode_cuda, gl.gl_iteration_cuda)]
    for name, cfg, decode, gl_kernel in cases:
        model = (Tacotron2(30, cfg.model, n_mels=20, device=cuda, seed=2) if name == "taco2"
                 else Tacotron(30, cfg.model, n_mels=20, num_freq=129, device=cuda, seed=2))
        with torch.no_grad():                                 # no row stops by chance
            model.decoder.stopnet.bias.fill_(-10.0)
        ap = AudioProcessor(cfg.audio, cuda)
        out = str(tmp_path / name)
        manifest = export_serving(model, cfg, ap, out, batch_sizes=(3,), text_buckets=(16,))
        assert manifest["platforms"] == ["cuda"]
        exp = ExportedSynthesizer(out)
        text = np.random.default_rng(3).integers(1, 30, (3, 16)).astype(np.int64)
        lens = np.array([16, 12, 7], np.int64)
        plain = []
        with pytest.MonkeyPatch.context() as mp:
            for mod, fn in ((t2, "tacotron2_decode_plain"), (t1, "tacotron1_decode_plain"),
                            (gl, "griffin_lim_full_plain"), (gl, "gl_iteration_plain")):
                mp.setattr(mod, fn, lambda *a, _fn=fn, **k: plain.append(_fn))
            before = (decode.launches, gl_kernel.launches)
            wav, ml = exp(text, lens, seed=4)
            assert decode.launches == before[0] + 1 and gl_kernel.launches > before[1]
        assert not plain
        with torch.no_grad():
            ref_wav, ref_ml = make_serving_fn(model, cfg, ap)(
                torch.from_numpy(text).to(cuda), torch.from_numpy(lens).to(cuda),
                torch.tensor([4], device=cuda))
        np.testing.assert_array_equal(ml, ref_ml.cpu().numpy())
        np.testing.assert_allclose(wav, ref_wav.cpu().numpy(), atol=1e-5)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0


# ------------------------------------------- Tacotron(1) training, the importer

def upstream_tacotron2_state_dict(n_chars: int, seed: int = 0) -> dict:
    """An upstream (mozilla/TTS layer naming) Tacotron2 state dict at the
    smoke config's widths, seeded random values, the stopnet's bias at -10
    (no row stops by chance): what bin/import_checkpoint reads from a
    .pth.tar. Built from shapes alone: the replicas of
    tests/test_torch_import.py need JAX, which the card machine lacks."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def put(name, *shape, scale=0.2):
        sd[name] = scale * torch.randn(*shape, generator=g)

    def convbn(prefix, i, o, k):
        put(f"{prefix}.convolution1d.weight", o, i, k)
        put(f"{prefix}.convolution1d.bias", o)
        bn = f"{prefix}.batch_normalization"
        put(f"{bn}.weight", o), put(f"{bn}.bias", o), put(f"{bn}.running_mean", o)
        sd[f"{bn}.running_var"] = 0.5 + torch.rand(o, generator=g)

    E, H, A, F, K, P, PD, M, r = 32, 48, 24, 8, 15, 24, 32, 20, 2
    put("embedding.weight", n_chars, E, scale=0.3)
    for i in range(3):
        convbn(f"encoder.convolutions.{i}", E, E, 5)
    for sfx in ("", "_reverse"):
        put(f"encoder.lstm.weight_ih_l0{sfx}", 2 * E, E), put(f"encoder.lstm.weight_hh_l0{sfx}",
                                                             2 * E, E // 2)
        put(f"encoder.lstm.bias_ih_l0{sfx}", 2 * E), put(f"encoder.lstm.bias_hh_l0{sfx}", 2 * E)
    put("decoder.prenet.linear_layers.0.linear_layer.weight", P, M)
    put("decoder.prenet.linear_layers.1.linear_layer.weight", P, P)
    put("decoder.prenet.linear_layers.0.linear_layer.bias", P)
    put("decoder.prenet.linear_layers.1.linear_layer.bias", P)
    for rnn, n_in in (("attention_rnn", P + E), ("decoder_rnn", H + E)):
        put(f"decoder.{rnn}.weight_ih", 4 * H, n_in), put(f"decoder.{rnn}.weight_hh", 4 * H, H)
        put(f"decoder.{rnn}.bias_ih", 4 * H), put(f"decoder.{rnn}.bias_hh", 4 * H)
    a = "decoder.attention"
    put(f"{a}.query_layer.linear_layer.weight", A, H)
    put(f"{a}.inputs_layer.linear_layer.weight", A, E)
    put(f"{a}.v.linear_layer.weight", 1, A), put(f"{a}.v.linear_layer.bias", 1)
    put(f"{a}.location_layer.location_conv1d.weight", F, 2, K)
    put(f"{a}.location_layer.location_dense.linear_layer.weight", A, F)
    put("decoder.linear_projection.linear_layer.weight", M * r, H + E)
    put("decoder.linear_projection.linear_layer.bias", M * r)
    put("decoder.stopnet.1.linear_layer.weight", 1, H + M * r)
    sd["decoder.stopnet.1.linear_layer.bias"] = torch.full((1,), -10.0)
    chans = [M] + [PD] * 4 + [M]
    for i in range(5):
        convbn(f"postnet.convolutions.{i}", chans[i], chans[i + 1], 5)
    return sd


def test_imported_tacotron2_serves_on_the_card(cuda, tmp_path):
    """An upstream checkpoint at the smoke widths through
    bin/import_checkpoint, served by Synthesizer on the card: the decode
    (kernel 1) and the whole-loop Griffin-Lim at the smoke hop (kernel 3)
    launch; its mel, alignments, stops and lengths against the CPU's plain
    route of the same import at the decode's tolerances."""
    import os

    from your_voice_tts_torch.bin import import_checkpoint
    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.ops.griffin_lim import griffin_lim_full_cuda
    from your_voice_tts_torch.text import symbols

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_path = os.path.join(root, "configs/smoke_synthetic.json")
    src, out = tmp_path / "ref.pth.tar", tmp_path / "imported.npz"
    torch.save({"model": upstream_tacotron2_state_dict(len(symbols)), "r": 2, "step": 9}, src)
    import_checkpoint.main([str(src), cfg_path, str(out)])
    card, cpu = (Synthesizer(cfg_path, str(out), device=d) for d in (cuda, "cpu"))
    texts = ["The imported model speaks.", "On the card and on the host."]
    for c in (tacotron2_decode_cuda, griffin_lim_full_cuda):
        c.launches = 0
    wavs = card.tts_many(texts)
    assert tacotron2_decode_cuda.launches > 0 and griffin_lim_full_cuda.launches > 0
    assert all(np.isfinite(w).all() and len(w) > 0 for w in wavs)
    text, lengths = _pad_texts([text_to_seq(t, card.cfg) for t in texts])
    got, ref = (s.model.inference(text, lengths, seed=3) for s in (card, cpu))
    assert_decode_holds([got[k].cpu() for k in ("decoder_outputs", "alignments", "stop_probs",
                                                "mel_lengths")],
                        [ref[k] for k in ("decoder_outputs", "alignments", "stop_probs",
                                          "mel_lengths")])


def taco1_trainer(device, corpus, **training):
    """A Tacotron(1) Trainer at the smoke widths (tacotron_width 32) on
    `corpus`, on `device`; float32 unless `training` says otherwise."""
    import dataclasses
    import os

    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs/smoke_synthetic.json"))
    ds = dataclasses.replace(cfg.data.datasets[0], path=corpus)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
        model=dataclasses.replace(cfg.model, model="Tacotron", tacotron_width=32, memory_size=5,
                                  attention_dim=24, max_decoder_steps=40),
        training=dataclasses.replace(cfg.training, **{"mixed_precision": False, **training}))
    return Trainer(cfg, verbose=False, device=device)


def test_taco1_train_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One Tacotron(1) train step's loss parts (1e-4 relative) and
    gradients (1e-3 relative L2 over all leaves), card against CPU, from
    the same weights and batch, dropout off, TF32 off: chip_smoke.py's
    taco1-train tolerances at the smoke widths."""
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=8, sr=8000)
    cpu, card = taco1_trainer("cpu", corpus), taco1_trainer(cuda, corpus)
    card.model.load_state_dict(cpu.model.state_dict())
    batch = next(cpu.train_data.batches(4, 2, shuffle=False))
    got = {}
    for name, tr in (("cpu", cpu), ("card", card)):
        total, parts, _ = tr._loss_fn(tr._tensors(batch), 2, None)
        grads = torch.autograd.grad(total, tr.params)
        got[name] = ({k: float(v.detach()) for k, v in parts.items()},
                     torch.cat([g.flatten().double().cpu() for g in grads]))
    (pc, gc), (pk, gk) = got["cpu"], got["card"]
    for k, v in pc.items():
        assert abs(pk[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, pk[k], v)
    assert float((gk - gc).norm() / gc.norm()) <= 1e-3


def test_taco1_test_run_launches_its_kernels(cuda, tmp_path):
    """Trainer.test_run on the card for Tacotron(1): the decode (kernel 8)
    and the Griffin-Lim kernel gl_route picks for the decoded frames (at
    the smoke hop, the whole loop: kernel 3) launch, and the results are
    finite."""
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.ops.griffin_lim import (gl_iteration_cuda, gl_route,
                                                      griffin_lim_full_cuda)
    from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode_cuda

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=8, sr=8000)
    trainer = taco1_trainer(cuda, corpus)
    counters = (tacotron1_decode_cuda, griffin_lim_full_cuda, griffin_lim_wave_cuda,
                gl_iteration_cuda)
    for c in counters:
        c.launches = 0
    results = trainer.test_run(1)
    frames = max(r["mel_postnet_spec"].shape[1] for r in results)
    route = gl_route(-(-frames // 32) * 32, 256, 64)
    want = {"full": griffin_lim_full_cuda, "wave": griffin_lim_wave_cuda,
            "iteration": gl_iteration_cuda}[route]
    assert tacotron1_decode_cuda.launches > 0 and want.launches > 0
    assert all(np.isfinite(r["wav"]).all() for r in results)


@pytest.mark.parametrize("kind, scans", [("bidirectional", 2), ("accumulated", 2),
                                         ("forward_ta_mask", 0), ("graves", 0)])
def test_train_step_routes_on_the_card(cuda, tmp_path, kind, scans):
    """One `Trainer.train_step` at smoke widths, float32, dropout off, on the
    card against the CPU from the same weights: a bidirectional-decoder
    model and an A = 2 step on kernels 5 and 6 (two scans each way a step),
    forward attention with the agent and the mask and Graves on the step
    loop (none); every loss part within 1e-5 relative and the gradients
    handed to the update within 1e-4 rel L2 (float32 sums in another
    order)."""
    import dataclasses

    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.ops.taco2_train import taco2_train_bwd_cuda, taco2_train_fwd_cuda
    from your_voice_tts_torch.train.trainer import Trainer

    cfg = load_config("configs/smoke_synthetic.json")
    model = {"bidirectional": dict(bidirectional_decoder=True),
             "forward_ta_mask": dict(use_forward_attn=True, transition_agent=True,
                                     forward_attn_mask=True),
             "graves": dict(attention_type="graves")}.get(kind, {})
    ds = dataclasses.replace(cfg.data.datasets[0],
                             path=make_synthetic_corpus(str(tmp_path), n_items=8, sr=8000))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
        model=dataclasses.replace(cfg.model, **model),
        training=dataclasses.replace(cfg.training, mixed_precision=False,
                                     grad_accum_steps=2 if kind == "accumulated" else 1))
    g = np.random.default_rng(0)
    ml = np.array([40, 33, 28, 21])
    batch = {"text": g.integers(1, 60, (4, 17)).astype(np.int32),
             "text_lengths": np.array([17, 15, 12, 9], np.int32),
             "mel": (g.standard_normal((4, 40, 20)) * (np.arange(40) < ml[:, None])[..., None]
                     ).astype(np.float32),
             "mel_lengths": ml.astype(np.int32),
             "stop_targets": (np.arange(20) >= ((ml + 1) // 2 - 1)[:, None]).astype(np.float32)}
    got = {}
    trainers = {d: Trainer(cfg, device=d, verbose=False) for d in ("cpu", "cuda")}
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    for dev, t in trainers.items():
        t.generator, seen, step = None, {}, t.optimizer.step
        t.optimizer.step = lambda grads, _s=step, _seen=seen: (
            _seen.__setitem__("g", torch.cat([x.double().flatten().cpu() for x in grads]))
            or _s(grads))
        taco2_train_fwd_cuda.launches = taco2_train_bwd_cuda.launches = 0
        got[dev] = t.train_step(batch, 2), seen["g"]
    assert (taco2_train_fwd_cuda.launches, taco2_train_bwd_cuda.launches) == (
        scans * (2 * 20 + 1), scans * 4 * 20)
    (mc, gc), (mk, gk) = got["cpu"], got["cuda"]
    for k, v in mc.items():
        assert abs(mk[k] - v) <= 1e-5 * abs(v) + 1e-8, (k, mk[k], v)
    assert float((gk - gc).norm() / gc.norm()) <= 1e-4


@pytest.mark.parametrize("variant", ["graves", "forward_ta_mask"])
def test_taco1_variant_serves_and_trains_on_the_card(cuda, variant):
    """A Tacotron(1) with Graves or forward attention (agent, mask) at smoke
    widths, float32, dropout off: `inference` on the card (the step loop)
    against the CPU, frames and alignments 1e-4, lengths equal, with kernel
    8 never launched; one teacher-forced pass + loss's gradients card
    against CPU, 1e-3 rel L2 (the taco1 train step's card gate)."""
    import dataclasses

    from your_voice_tts_torch.models.tacotron import Tacotron
    from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode_cuda

    flags = {"graves": dict(attention_type="graves"),
             "forward_ta_mask": dict(use_forward_attn=True, transition_agent=True,
                                     forward_attn_mask=True)}[variant]
    cfg = dataclasses.replace(ModelConfig(model="Tacotron", r=2, memory_size=5,
                                          tacotron_width=32, attention_dim=24,
                                          prenet_dropout=False), **flags)
    models = {d: Tacotron(40, cfg, n_mels=20, num_freq=33, device=d, seed=3)
              for d in ("cpu", cuda)}
    g = np.random.default_rng(1)
    text = torch.from_numpy(g.integers(1, 40, (3, 12)))
    lens = torch.tensor([12, 9, 6])
    tacotron1_decode_cuda.launches = 0
    out = {d: m.inference(text, lens, max_decoder_steps=40) for d, m in models.items()}
    assert tacotron1_decode_cuda.launches == 0
    for k in ("decoder_outputs", "alignments"):
        np.testing.assert_allclose(out[cuda][k].cpu().numpy(), out["cpu"][k].numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert torch.equal(out[cuda]["mel_lengths"].cpu(), out["cpu"]["mel_lengths"])
    mels = torch.from_numpy(g.standard_normal((3, 24, 20)).astype(np.float32))
    grads = {}
    for d, m in models.items():
        m.train()
        o = m(text.to(d), lens.to(d), mels.to(d), mel_lengths=torch.tensor([24, 20, 14]).to(d))
        loss = sum((o[k].float() ** 2).mean() for k in ("decoder_outputs", "postnet_outputs",
                                                       "stop_logits"))
        grads[d] = torch.cat([x.flatten().double().cpu()
                              for x in torch.autograd.grad(loss, list(m.parameters()))])
    assert float((grads[cuda] - grads["cpu"]).norm() / grads["cpu"].norm()) <= 1e-3


def vocoder_step(trainer, mel, audio, noise, g_state=None):
    """One train_step recording the gradients each optimizer is handed;
    a GAN's discriminator step starts from `g_state` (the generator's
    weights) where given. Returns (metrics, gradients, the generator's
    weights as the discriminator step started)."""
    seen, at_d = [], {}
    opts = [trainer.optimizer] if hasattr(trainer, "model") else [trainer.g_opt, trainer.d_opt]
    for o in opts:
        o.step = lambda g, _s=o.step: seen.extend(x.detach().double().cpu() for x in g) or _s(g)
    if hasattr(trainer, "model"):
        return {"loss": trainer.train_step(mel, audio)}, seen, at_d
    d_loss = trainer.d_loss

    def same_generator(*a, **k):
        at_d.update({n: t.detach().cpu().clone()
                     for n, t in trainer.generator.state_dict().items()})
        if g_state is not None:
            with torch.no_grad():
                for n, t in trainer.generator.state_dict().items():
                    t.copy_(g_state[n])
        return d_loss(*a, **k)

    trainer.d_loss = same_generator
    return trainer.train_step(mel, audio, noise=noise), seen, at_d


@pytest.mark.parametrize("model", ["melgan", "pwgan", "wavernn"])
def test_vocoder_trainer_step_on_the_card_matches_the_cpu(cuda, tmp_path, model):
    """One vocoder trainer step at smoke widths, float32, from the same
    weights on the same batch (PWGAN's noise injected), the GAN ones past
    the discriminator's start, each device's discriminator step from the
    CPU step's updated generator: every metric 1e-4 relative; WaveRNN's
    gradients 1e-4 rel L2, a GAN's (through the STFT loss, ill-conditioned
    in float32) no farther from the CPU's float64 step's than max(1e-4, 2 x
    the CPU float32 step's distance), as chip_smoke.py's vocoder-train
    holds them."""
    import copy
    import dataclasses

    from your_voice_tts_torch.data.formatters import ljspeech
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.vocoder.config import load_vocoder_config
    from your_voice_tts_torch.vocoder.train_gan import GANTrainer
    from your_voice_tts_torch.vocoder.train_wavernn import WaveRNNTrainer

    items = ljspeech(make_synthetic_corpus(str(tmp_path), n_items=3, sr=8000))
    cfg = load_vocoder_config("configs/melgan_smoke.json")
    cfg = dataclasses.replace(cfg, model=model, training=dataclasses.replace(
        cfg.training, seq_len=512, mixed_precision=False, steps_to_start_discriminator=0))
    if model == "pwgan":
        cfg = dataclasses.replace(cfg, pwgan=dataclasses.replace(
            cfg.pwgan, upsample_factors=(4, 4, 4), num_layers=6, stacks=2))
    if model == "wavernn":
        cfg = dataclasses.replace(cfg, wavernn=dataclasses.replace(
            cfg.wavernn, upsample_factors=(4, 4, 4), rnn_dims=64, fc_dims=64))
    cls = WaveRNNTrainer if model == "wavernn" else GANTrainer
    cpu, card = (cls(cfg, items, verbose=False, device=d) for d in ("cpu", cuda))
    nets = (lambda t: [t.model]) if model == "wavernn" else (
        lambda t: [t.generator, t.discriminator])
    for a, b in zip(nets(cpu), nets(card)):
        b.load_state_dict(a.state_dict())
    f64 = None
    if model != "wavernn":
        f64 = copy.deepcopy(cpu)
        for n in nets(f64):
            n.double()
        f64.dtype = torch.float64
    mel, audio = cpu.dataset.sample_batch(2, np.random.default_rng(0))
    noise = [torch.from_numpy(np.random.default_rng(s).standard_normal(audio.shape)
                              .astype(np.float32)) for s in (1, 2)]
    mc, gc, g_state = vocoder_step(cpu, mel, audio, tuple(noise))
    mk, gk, _ = vocoder_step(card, mel, audio, tuple(x.to(cuda) for x in noise), g_state or None)
    for k, v in mc.items():
        assert abs(mk[k] - v) <= 1e-4 * abs(v) + 1e-8, (k, mk[k], v)
    cat = lambda gs: torch.cat([x.flatten() for x in gs])  # noqa: E731
    dist = lambda a, b: float((cat(a) - cat(b)).norm() / cat(b).norm())  # noqa: E731
    if f64 is None:
        assert dist(gk, gc) <= 1e-4
    else:
        _, g64, _ = vocoder_step(f64, mel, audio, tuple(x.double() for x in noise), g_state)
        assert dist(gk, g64) <= max(1e-4, 2 * dist(gc, g64)), (dist(gk, g64), dist(gc, g64))


def test_capture_trace_holds_the_kernel_launches(cuda, tmp_path):
    """Trainer.capture_trace around one Tacotron2 train step on the card
    (smoke config, kernels 5 and 6): the trace file holds the launches of
    the forward scan's attention kernel and the backward scan's attention
    and cell kernels (csrc/taco2_train.cu)."""
    import dataclasses
    import json
    import os

    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.train.trainer import Trainer

    cfg = load_config("configs/smoke_synthetic.json")
    ds = dataclasses.replace(cfg.data.datasets[0],
                             path=make_synthetic_corpus(str(tmp_path / "c"), n_items=4, sr=8000))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)))
    trainer = Trainer(cfg, device=cuda, verbose=False)
    batch = next(trainer.train_data.batches(2, 2))
    out = trainer.capture_trace(str(tmp_path / "trace"), trainer.train_step, batch, 2)
    assert np.isfinite(out["loss"])
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name, encoding="utf-8") as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    for own in ("attn_fwd_kernel", "attn_bwd_kernel", "cell_bwd_kernel"):
        assert any(own in k for k in kernels), (own, sorted(set(kernels))[:30])


def parallel_asset_config():
    """The trained ParallelTTS asset's config: the smoke config with model
    ParallelTTS, max_decoder_steps 512, r 1."""
    import dataclasses

    from your_voice_tts_torch.config import load_config

    cfg = load_config("configs/smoke_synthetic.json")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, model="ParallelTTS", max_decoder_steps=512, r=1))


def test_parallel_tts_serves_on_the_card(cuda):
    """The trained ParallelTTS asset on the card against the CPU (float32,
    TF32 off): durations, lengths and alignments equal, mels within 1e-5;
    `tts_many` on the card launches the Griffin-Lim kernel its frames
    route to (the smoke hop: the whole loop, kernel 3) and no plain
    version."""
    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.ops import griffin_lim
    from your_voice_tts_torch.ops.griffin_lim import gl_iteration_cuda, griffin_lim_full_cuda

    cfg, ckpt = parallel_asset_config(), "assets/bench_trained_parallel.npz"
    card, cpu = Synthesizer(cfg, ckpt, device=cuda), Synthesizer(cfg, ckpt, device="cpu")
    texts = ["Hi there.", "The quick brown fox jumps over the lazy dog."]
    text, lengths = _pad_texts([text_to_seq(t, cfg) for t in texts])
    got, ref = card.model.inference(text, lengths), cpu.model.inference(text, lengths)
    for k in ("durations", "mel_lengths", "alignments"):
        assert torch.equal(got[k].cpu(), ref[k]), k
    assert float((got["postnet_outputs"].cpu() - ref["postnet_outputs"]).abs().max()) <= 1e-5
    counters = (griffin_lim_full_cuda, griffin_lim_wave_cuda, gl_iteration_cuda)
    for c in counters:
        c.launches = 0
    plain = griffin_lim.griffin_lim_full_plain
    griffin_lim.griffin_lim_full_plain = None          # a call would raise
    try:
        wavs = card.tts_many(texts)
    finally:
        griffin_lim.griffin_lim_full_plain = plain
    assert griffin_lim_full_cuda.launches > 0
    assert not griffin_lim_wave_cuda.launches and not gl_iteration_cuda.launches
    assert all(np.isfinite(w).all() and len(w) > 0 for w in wavs)


def test_extract_durations_runs_kernel_5_on_the_card(cuda, tmp_path):
    """bin/extract_durations with the trained Tacotron2 teacher over a
    small synthetic corpus: on the card the teacher-forced pass launches
    the training forward kernel (kernel 5), and the rows equal the CPU's."""
    from your_voice_tts_torch.bin import extract_durations
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.ops.taco2_train import taco2_train_fwd_cuda

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=6, sr=8000)
    args = ["--config", "configs/smoke_synthetic.json", "--checkpoint",
            "assets/bench_trained_smoke.npz", "--data_path", corpus, "--batch_size", "4"]
    taco2_train_fwd_cuda.launches = 0
    card = extract_durations.main(args + ["--output", str(tmp_path / "card.npz"),
                                          "--device", "cuda"])
    assert taco2_train_fwd_cuda.launches > 0
    cpu = extract_durations.main(args + ["--output", str(tmp_path / "cpu.npz"),
                                         "--device", "cpu"])
    assert sorted(card) == sorted(cpu)
    for k, v in cpu.items():
        np.testing.assert_array_equal(card[k], v)


def test_parallel_train_step_on_the_card_matches_the_cpu(cuda):
    """One ParallelTTS training step (`bin/train_parallel.step_grads`,
    dropout off) of a GST + energy model with the conv encoder, card
    against CPU from the same weights and batch, in float64: the loss parts
    and the gradients within 1e-6 (float32's ReLU inputs and L1 residuals
    can fall on either side of their kink, chip_smoke.py `kink_inputs`)."""
    import copy
    import dataclasses

    from your_voice_tts_torch.bin.train_parallel import step_grads
    from your_voice_tts_torch.config import GSTConfig
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.models.parallel_tts import ParallelTTSLoss, uniform_durations
    from your_voice_tts_torch.text import symbols

    cfg = parallel_asset_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, parallel_encoder="conv",
                                       parallel_energy_predictor=True),
        speakers=dataclasses.replace(cfg.speakers, use_gst=True, gst=GSTConfig(
            gst_embedding_dim=32, gst_num_heads=2, gst_style_tokens=4)))
    cpu = setup_model(len(symbols), cfg, device="cpu").double()
    card = copy.deepcopy(cpu).to(cuda)
    g = torch.Generator().manual_seed(0)
    tl, ml = torch.tensor([12, 9, 5]), torch.tensor([40, 27, 13])
    b = {"text": torch.randint(1, len(symbols), (3, 12), generator=g) * (
             torch.arange(12)[None] < tl[:, None]),
         "text_lengths": tl, "mel_lengths": ml,
         "mel": torch.randn(3, 40, 20, generator=g, dtype=torch.float64),
         "durations": uniform_durations(tl, ml, 12)}
    got = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        parts, grads = step_grads(model, ParallelTTSLoss(), {k: v.to(dev) for k, v in b.items()})
        got[name] = ({k: float(v.detach()) for k, v in parts.items()},
                     torch.cat([x.flatten().cpu() for x in grads]))
    (pc, gc), (pk, gk) = got["cpu"], got["card"]
    assert "loss_energy" in pc
    for k, v in pc.items():
        assert abs(pk[k] - v) <= 1e-6 * abs(v), k
    assert float((gk - gc).norm() / gc.norm()) <= 1e-6
