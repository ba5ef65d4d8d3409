"""Griffin-Lim (FGLA) on the card as the vocoder: the plug that a
configuration names under "plugs" -> "vocoder".

A vocoder plug gives the harness, by these names:
- KERNELS: the port's CUDA kernels its path builds;
- CONTROL: its part's precision below the configuration's (FGLA's bf16
  products in fp8);
- vocoder_config(conf, cfg): the port's vocoder configuration, or None
  where the audio processor voices the mel itself;
- weight_spec(conf): its seeded weights, or None;
- install(system): the capture of each kept row's untrimmed waveform;
- prepare(system, rows, conf, device): what the reference needs of the
  program's run before its state is freed;
- reference(rows, conf, seed, device, modes): each row's waveform from its
  served mel;
- gap(row, got, want, audio, device, served): the compared number;
- flops(conf, call): the call's operations (float32, bf16).

FGLA at momentum 0.95 amplifies rounding into other waveforms of equal
quality, so a waveform is judged by its spectral convergence against the
served magnitudes, over float32 FGLA's from the same initial phase (drawn
again from the seed).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts
from portbench.reference import dsp

KERNELS = ("griffin_lim",)
CONTROL = {"griffin_lim": "fp8"}
weight_spec = None


def vocoder_config(conf: dict, cfg):
    return None


def install(system) -> None:
    """Keep each kept row's untrimmed waveform, where in its batch's phase
    draws it lies, and every draw's frame bucket in order."""
    cap, ap = system.capture, system.synth.ap
    orig_inv, orig_inverse = ap.inv_melspectrogram_batch, ap._inverse
    cap.draws = []                       # the frame bucket of each phase draw, in order

    def inv_melspectrogram_batch(mels):
        base = len(cap.draws)
        wavs = orig_inv(mels)
        for i in cap.local.keep:
            if i < len(wavs):
                cap.rows.setdefault(cap.local.texts[i], {}).update(
                    wav=wavs[i], draw_base=base, batch_frames=[m.shape[1] for m in mels])
        return wavs

    def _inverse(kind, spec_norm):
        cap.draws.append(int(spec_norm.shape[1]))
        return orig_inverse(kind, spec_norm)

    ap.inv_melspectrogram_batch = system.timed("inv_melspectrogram_batch",
                                               inv_melspectrogram_batch)
    ap._inverse = _inverse


def prepare(system, rows, conf: dict, device) -> None:
    """Each row's initial phase, drawn again: the processor's generator,
    seeded as served, makes one [frame bucket, n_freq] draw a launch,
    launches in order of frame bucket, then of 128-row chunks."""
    n_freq = conf["tts"]["audio"]["fft_size"] // 2 + 1
    want = {}
    bucket = counts.frame_bucket
    for r in rows:
        fr = r["batch_frames"]
        k = r["draw_base"]
        mine = bucket(fr[r["row"]])
        for tb in sorted({bucket(f) for f in fr}):
            members = [i for i, f in enumerate(fr) if bucket(f) == tb]
            if tb == mine:
                k += members.index(r["row"]) // 128
                break
            k += -(-len(members) // 128)
        want.setdefault(k, []).append(r)
        r["bucket"] = mine
    g = torch.Generator().manual_seed(system.gl_seed)
    draws = system.capture.draws
    for k in range(max(want) + 1):
        ph = torch.rand((draws[k], n_freq), generator=g) * (2.0 * np.pi)
        for r in want.get(k, []):
            r["phase"] = ph.to(device)


def reference(rows, conf: dict, seed: int, device, modes: dict) -> list:
    """The served span of Griffin-Lim over each row padded to its frame
    bucket, rows of one bucket together, from the row's own phase."""
    audio = dsp.Audio(conf["tts"]["audio"], device)
    out = [None] * len(rows)
    for tb in sorted({x["bucket"] for x in rows}):
        idx = [i for i, x in enumerate(rows) if x["bucket"] == tb]
        buf = torch.full((len(idx), tb, audio.n_mels), -audio.max_norm, device=device)
        for j, i in enumerate(idx):
            spec = rows[i]["postnet"]
            buf[j, :spec.shape[1]] = torch.as_tensor(spec.T, device=device)
        phase = torch.stack([rows[i]["phase"] for i in idx])
        full = audio.griffin_lim(audio.magnitudes(buf), phase, modes.get("griffin_lim", "f32"))
        wav = audio.wave_of(full, tb)
        for j, i in enumerate(idx):
            out[i] = wav[j, :audio.hop * (rows[i]["postnet"].shape[1] - 1)]
    return out


def gap(row: dict, got, want, audio, device, served: bool) -> float:
    """Spectral convergence against the served magnitudes over the float32
    reference's, less 1 (the program's waveform carries the preemphasis
    filter's inverse; the reference's does not)."""
    mag = audio.magnitudes(torch.as_tensor(row["postnet"].T[None], device=device))[0]
    y = got if served else audio.preemphasis(got)
    return audio.spectral_convergence(y, mag) / audio.spectral_convergence(want, mag) - 1


def flops(conf: dict, call: dict) -> tuple[float, float]:
    return 0.0, counts.griffin_lim(conf["tts"]["audio"], call)["bf16_flops"]
