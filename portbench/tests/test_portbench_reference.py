"""The plain reference against the port's CPU path at narrow widths, the
operation and byte counts against counts worked by hand, and the
precision modes the control uses."""

import numpy as np
import pytest
import torch
from conftest import narrow

from portbench import counts
from portbench.reference import dsp as ref_dsp
from portbench.reference import melgan as ref_melgan
from portbench.reference import precision
from portbench.reference import tacotron2 as ref_taco
from portbench.reference.text import text_ids
from portbench.system import plugs
from portbench.weights import draw

SENTENCES = ["Hello there, general word.", "Mr. Smith paid the co. bill.",
             "A longer line of several plain words, with a comma and an end."]


def tts_weight_spec(conf):
    return plugs(conf)[0].weight_spec(conf)


def vocoder_weight_spec(conf):
    return plugs(conf)[1].weight_spec(conf)


def port_model(conf, weights):
    from your_voice_tts_torch.config import config_from_dict
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.text import symbols

    cfg = config_from_dict(conf["tts"])
    model = setup_model(len(symbols), cfg, device="cpu")
    model.load_state_dict(weights)
    return cfg, model


def test_text_ids_equal_the_ports():
    from your_voice_tts_torch.text import text_to_sequence

    for s in SENTENCES:
        assert text_ids(s) == list(text_to_sequence(s, "english_cleaners"))
    with pytest.raises(ValueError):
        text_ids("In 1999.")


def test_weights_are_drawn_from_the_seed_and_fit_the_port():
    conf, _ = narrow("tacotron2-ljspeech-melgan.serve-c64")
    a = draw(tts_weight_spec(conf), 2 ** 31 + 3, "cpu")
    b = draw(tts_weight_spec(conf), 2 ** 31 + 3, "cpu")
    c = draw(tts_weight_spec(conf), 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.attention_rnn.weight_ih"],
                           c["decoder.attention_rnn.weight_ih"])
    assert float(a["decoder.stopnet.bias"]) == -10.0
    port_model(conf, a)  # strict load: every name and shape the port has


def test_encoder_decode_postnet_equal_the_ports_float32_path():
    """Teacher forcing on the port's own free-running frames reproduces
    them when both sides run float32 (the port's plain decode at
    decode_dtype float32)."""
    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq

    conf, _ = narrow("tacotron2-ljspeech.bulk-b448")
    W = draw(tts_weight_spec(conf), 11, "cpu")
    cfg, model = port_model(conf, W)
    text, lengths = _pad_texts([text_to_seq(s, cfg) for s in SENTENCES])
    out = model.inference(text, lengths, decode_dtype=torch.float32)
    r, nm = conf["tts"]["r"], conf["tts"]["audio"]["num_mels"]
    dec = out["decoder_outputs"]
    B, S = dec.shape[0], dec.shape[1] // r
    fed = torch.cat([torch.zeros(B, 1, nm), dec.reshape(B, S, r * nm)[:, :-1, -nm:]], 1)
    ids = torch.as_tensor(text)
    lens = torch.as_tensor(lengths)
    memory = ref_taco.encode(W, ids, lens)
    frames, stops, aligns, n = ref_taco.decode_teacher_forced(
        W, memory, lens, fed, torch.arange(B), r=r, n_mels=nm, seed=0,
        thresh=conf["tts"]["stop_threshold"])
    torch.testing.assert_close(frames, dec.reshape(B, S, r * nm), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(torch.sigmoid(stops), out["stop_probs"], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(aligns, out["alignments"], rtol=1e-4, atol=1e-5)
    assert n.tolist() == out["mel_lengths"].tolist()
    torch.testing.assert_close(ref_taco.postnet(W, dec), out["postnet_outputs"],
                               rtol=1e-4, atol=1e-5)


def test_melgan_equals_the_ports():
    from your_voice_tts_torch.vocoder.models.melgan import MelganGenerator

    conf, _ = narrow("tacotron2-ljspeech-melgan.serve-c64")
    m = conf["vocoder"]["melgan"]
    W = draw(vocoder_weight_spec(conf), 5, "cpu")
    gen = MelganGenerator(80, tuple(m["upsample_factors"]), m["base_channels"],
                          m["num_res_blocks"], m["kernel_size"], device="cpu")
    gen.load_state_dict(W)
    mel = torch.randn(2, 12, 80, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ref_melgan.generate(W, mel, m), gen(mel), rtol=1e-4, atol=1e-5)


def test_griffin_lim_matches_the_ports_quality_from_the_same_phase():
    """FGLA amplifies rounding, so the two waveforms differ sample by
    sample; their spectral convergence against the served magnitudes
    agrees, and the port's magnitudes are the reference's."""
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.config import config_from_dict

    conf, _ = narrow("tacotron2-ljspeech.bulk-b448")
    cfg = config_from_dict(conf["tts"])
    ap = AudioProcessor(cfg.audio, "cpu", seed=9)
    ref = ref_dsp.Audio(conf["tts"]["audio"])
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 10, 22, generator=g)
    mel = torch.nn.functional.interpolate(x[:, None], size=(60, 80), mode="bilinear")[:, 0]
    mel = mel * 1.5 - 1.0
    wav = ap.inv_melspectrogram_batch([mel[0].numpy().T])[0]
    phase = torch.rand((64, 513), generator=torch.Generator().manual_seed(9)) * (2.0 * np.pi)
    buf = torch.full((1, 64, 80), -4.0)
    buf[:, :60] = mel
    torch.testing.assert_close(ref.magnitudes(buf)[0, :60],
                               ap.gl_magnitudes("mel", mel)[0], rtol=1e-4, atol=1e-6)
    y = ref.wave_of(ref.griffin_lim(ref.magnitudes(buf), phase), 64)[0, :256 * 59]
    mag = ref.magnitudes(mel)[0]
    sc_ref = ref.spectral_convergence(y, mag)
    sc_port = ref.spectral_convergence(ref.preemphasis(torch.from_numpy(wav)), mag)
    assert abs(sc_port / sc_ref - 1) < 0.02
    assert ref.endpoint(wav) == ap.find_endpoint(wav)


@pytest.mark.parametrize("mode,lo,hi", [("f32", 0, 0), ("tf32", 1e-5, 1e-3),
                                        ("bf16", 1e-4, 5e-3), ("fp8", 5e-3, 0.1)])
def test_precision_modes_round_as_named(mode, lo, hi):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    err = float(((precision.rounder(mode)(x) - x).norm() / x.norm()))
    assert lo <= err <= hi


def test_counts_against_hand_worked_shapes():
    tts = {"r": 2, "gradual_training": [[0, 3, 8]], "prenet_dim": 4, "attention_rnn_dim": 8,
           "decoder_rnn_dim": 8, "encoder_dim": 4, "attention_dim": 2,
           "attention_location_kernel_size": 3, "postnet_dim": 4,
           "audio": {"num_mels": 2, "fft_size": 8, "hop_length": 2, "griffin_lim_iters": 1}}
    call = {"rows": 2, "padded": 5, "frames": [4, 3]}
    d = counts.decode(tts, call)
    # NM 2, P 4, H 8, E 4, A 2, K 3, OW 6; steps 2 + 2 = 4
    macs = 4 * 2 + 4 * 4 + 4 * 8 * (4 + 4 + 8) + 2 * 8 + 4 * 8 * (8 + 4 + 8) + 7 * (8 + 4)
    assert macs == 1276
    assert d["bf16_flops"] == 2 * 1276 * 4
    assert d["f32_flops"] == (5 * 2 * 16 + 2 * 5 * 4) * 4
    weights = 2 * (1276 + 2 * 3 * 2) + 4 * (8 + 32 + 32 + 7 + 2 + 1)
    assert d["bytes"] == weights + 2 * 5 * (8 + 8 + 1) + 4 * 4 * (6 + 5 + 1)
    gl = counts.griffin_lim(tts["audio"], call)
    assert gl["bf16_flops"] == 3 * 2 * 7 * 8 * 8
    assert gl["bytes"] == 7 * 5 * 4 + 32 * 5 * 4 + 2 * 64 * 2 + (2 * 3 + 2 * 2) * 4
    mg = counts.melgan({"base_channels": 4, "kernel_size": 3, "upsample_factors": [2],
                        "num_res_blocks": 1}, 3, 2)
    # conv_in 3*2*4*3, up 3*4*2*4, res 6*2*2*5, conv_out 6*2*3
    assert mg["f32_flops"] == 2 * (72 + 96 + 120 + 36)
    assert counts.encoder(tts, call) == 2 * 2 * 5 * (3 * 16 * 5 + 2 * 4 * 2 * 6 + 8)
    assert counts.postnet(tts, call) == 2 * (2 * 4 + 3 * 16 + 4 * 2) * 5 * 7
    assert counts.seconds(67e12, 0, 0) == pytest.approx(1.0)
    assert counts.seconds(0, 0, 3.35e12) == pytest.approx(1.0)
