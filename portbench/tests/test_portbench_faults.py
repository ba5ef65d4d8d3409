"""`correct` comes out false when the timed path is broken underneath: the
harness runs on the CPU at narrow widths (no look for a card), with one
fault planted in the program's objects for the run. Each fault the
serving and bulk cells can have: a step that returns its state unchanged
(the decode's frames frozen after its first step; Griffin-Lim that never
iterates), half of the batch left out (its rows answered with the other
half's outputs), a token or an answer altered where it is produced (one
decoder frame, one vocoder sample, one byte of a WAV). The exchange between chips does not
exist on these one-chip cells. Beside them, the control: the reference in
the program's place one precision below the configuration's reads above
the program on every number that has a control, at three seeds."""

import time

import pytest
import torch
from conftest import narrow

from portbench import control, harness

SERVE = "tacotron2-ljspeech-melgan.serve-c64"
BULK = "tacotron2-ljspeech.bulk-b448"


def frozen_decode(monkeypatch):
    from your_voice_tts_torch.models import tacotron2

    orig = tacotron2.Decoder.inference

    def inference(self, *a, **kw):
        dec, aligns, stops, lengths = orig(self, *a, **kw)
        r = a[3] if len(a) > 3 else kw["r"]
        return dec[:, :r].repeat(1, dec.shape[1] // r, 1), aligns, stops, lengths
    monkeypatch.setattr(tacotron2.Decoder, "inference", inference)


def griffin_lim_unmoved(monkeypatch):
    from your_voice_tts_torch import audio

    orig = audio.AudioProcessor._inverse

    def _inverse(self, kind, spec_norm):
        iters = self.cfg.griffin_lim_iters
        object.__setattr__(self.cfg, "griffin_lim_iters", 0)
        try:
            return orig(self, kind, spec_norm)
        finally:
            object.__setattr__(self.cfg, "griffin_lim_iters", iters)
    monkeypatch.setattr(audio.AudioProcessor, "_inverse", _inverse)


def half_batch(monkeypatch):
    from your_voice_tts_torch.infer import synthesis, synthesizer

    orig = synthesis.synthesis_batch

    def synthesis_batch(model, texts, *a, **kw):
        half = orig(model, texts[:(len(texts) + 1) // 2], *a, **kw)
        out = [dict(half[i % len(half)], text=t) for i, t in enumerate(texts)]
        return out
    monkeypatch.setattr(synthesizer, "synthesis_batch", synthesis_batch)


def altered_frame(monkeypatch):
    from your_voice_tts_torch.models import tacotron2

    orig = tacotron2.Decoder.inference

    def inference(self, *a, **kw):
        dec, aligns, stops, lengths = orig(self, *a, **kw)
        dec = dec.clone()
        dec[:, dec.shape[1] // 2] += 0.5
        return dec, aligns, stops, lengths
    monkeypatch.setattr(tacotron2.Decoder, "inference", inference)


def altered_answer(monkeypatch):
    from your_voice_tts_torch.infer import synthesizer

    orig = synthesizer.Synthesizer.encode_wav_bytes

    def encode_wav_bytes(self, wav):
        b = bytearray(orig(self, wav))
        b[len(b) // 2] ^= 0x10
        return bytes(b)
    monkeypatch.setattr(synthesizer.Synthesizer, "encode_wav_bytes", encode_wav_bytes)


def altered_samples(monkeypatch):
    from your_voice_tts_torch.infer import synthesizer

    orig = synthesizer.Synthesizer._tts_many

    def _tts_many(self, *a, **kw):
        out = [w.copy() for w in orig(self, *a, **kw)]
        for w in out:
            w[len(w) // 3] += 0.25
        return out
    monkeypatch.setattr(synthesizer.Synthesizer, "_tts_many", _tts_many)


def altered_vocoder(monkeypatch):
    from your_voice_tts_torch.vocoder import synthesizer

    orig = synthesizer.VocoderSynthesizer.mel_to_wav

    def mel_to_wav(self, mel, *a, **kw):
        wav = orig(self, mel, *a, **kw).copy()
        wav[len(wav) // 2] += 0.25
        return wav
    monkeypatch.setattr(synthesizer.VocoderSynthesizer, "mel_to_wav", mel_to_wav)


def run(workload, seed=2 ** 31 + 21):
    conf, mix = narrow(workload)
    return harness.run(workload, seed, 4.0, False, time.perf_counter(), device="cpu",
                       conf=conf, mix=mix)


@pytest.mark.parametrize("workload", [SERVE, BULK])
def test_a_sound_run_is_correct(workload):
    line = run(workload)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("workload,fault,fails", [
    (SERVE, frozen_decode, "decode_gap"),
    (SERVE, half_batch, "answer_mismatch"),
    (SERVE, altered_frame, "decode_gap"),
    (SERVE, altered_vocoder, "vocoder_gap"),
    (SERVE, altered_answer, "answer_mismatch"),
    (BULK, frozen_decode, "decode_gap"),
    (BULK, griffin_lim_unmoved, "vocoder_gap"),
    (BULK, half_batch, "answer_mismatch"),
    (BULK, altered_samples, "answer_mismatch"),
])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, workload, fault, fails):
    fault(monkeypatch)
    line = run(workload)
    assert line["correct"] is False
    n = line["checks"][fails]
    assert n["value"] > n["limit"], line["checks"]


@pytest.mark.parametrize("workload", [SERVE, BULK])
def test_the_control_reads_above_the_program(workload):
    """At three seeds, every number with a control reads higher under the
    control than under the program, the decode's by three times or more."""
    conf, mix = narrow(workload)
    for seed in (3, 4, 2 ** 31 + 5):
        with torch.no_grad():
            got = control.readings(workload, seed, 3.0, device="cpu", conf=conf, mix=mix)
        prog, ctl = got["program"], got["control"]
        assert ctl["decode_gap"] >= 3 * prog["decode_gap"], got
        assert ctl["postnet_gap"] > prog["postnet_gap"], got
        assert ctl["vocoder_gap"] > prog["vocoder_gap"], got
