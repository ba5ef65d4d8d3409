"""The MelGAN generator as the vocoder: the plug that a configuration names
under "plugs" -> "vocoder" (the names a vocoder plug gives are listed in
plugs/griffin_lim.py). Its widths are the configuration's "vocoder" ->
"melgan" group; it runs float32 cuDNN with TF32 off, so the control
computes it in TF32. A waveform is judged sample by sample against the
float32 reference on the served mel."""

from __future__ import annotations

import torch

from portbench import counts
from portbench.reference import melgan as ref
from portbench.weights import draw, subseed

KERNELS = ()
CONTROL = {"melgan": "tf32"}


def vocoder_config(conf: dict, cfg):
    from your_voice_tts_torch.vocoder.config import MelganConfig, VocoderConfig

    v = conf["vocoder"]
    m = dict(v["melgan"], upsample_factors=tuple(v["melgan"]["upsample_factors"]))
    return VocoderConfig(model=v["model"], audio=cfg.audio, melgan=MelganConfig(**m))


def weight_spec(conf: dict) -> list:
    return ref.weight_spec(conf["vocoder"]["melgan"], conf["tts"]["audio"]["num_mels"])


def install(system) -> None:
    """Keep each kept row's waveform as `mel_to_wav` returns it (rows are
    voiced one at a time, in batch order)."""
    cap, voc = system.capture, system.synth.vocoder
    orig = voc.mel_to_wav

    def mel_to_wav(mel, *a, **kw):
        wav = orig(mel, *a, **kw)
        i = cap.local.scratch.get("voc_row", 0)
        cap.local.scratch["voc_row"] = i + 1
        if i in cap.local.keep:
            cap.rows.setdefault(cap.local.texts[i], {})["wav"] = wav
        return wav
    voc.mel_to_wav = system.timed("mel_to_wav", mel_to_wav)


def prepare(system, rows, conf: dict, device) -> None:
    pass


def reference(rows, conf: dict, seed: int, device, modes: dict) -> list:
    W = draw(weight_spec(conf), subseed(seed, "vocoder"), device)
    return [ref.generate(W, torch.as_tensor(x["postnet"].T[None], device=device),
                         conf["vocoder"]["melgan"], modes.get("melgan", "f32"))[0]
            for x in rows]


def gap(row: dict, got, want, audio, device, served: bool) -> float:
    """The largest sample gap over the reference's RMS."""
    return float((got - want).abs().max() / torch.sqrt((want ** 2).mean()))


def flops(conf: dict, call: dict) -> tuple[float, float]:
    nm = conf["tts"]["audio"]["num_mels"]
    return sum(counts.melgan(conf["vocoder"]["melgan"], f, nm)["f32_flops"]
               for f in call["frames"]), 0.0
