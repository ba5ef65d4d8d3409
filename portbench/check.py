"""What decides `correct`: the served outputs of a sample of the requests
the window completed, held against the plain reference.

The sample is drawn from the seed among the rows the capture kept (a
share of the texts, marked by a hash of the seed and the text) and always
holds the longest text the window served. For each row the reference
works out again, from the same seeded weights and the served text, what
the configuration's plugs compare (portbench/plugs/<name>.py): the
model's layers (for Tacotron2 the ids, the teacher-forced decode, the
lengths, the postnet) and the vocoder's waveform on the served mel. This
file compares, for every model, the trimming of the served waveform and
its WAV bytes, both exactly.

`numbers(sample, ..., served=None)` compares the program's outputs; the
control (`control.py`) passes the reference's own outputs at the precision
below the configuration's (the plugs' CONTROL) in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import dsp
from .system import plugs

FIELDS = ("text", "postnet", "wav", "trimmed")


def control_modes(conf: dict) -> dict:
    """The precision below the configuration's, for each part of it."""
    model, vocoder = plugs(conf)
    return {**model.CONTROL, **vocoder.CONTROL}


def sample(system, result: dict, seed: int, rows: int) -> list[dict]:
    """Up to `rows` captured rows that completed in the window: the longest
    text among them, then others drawn from the seed."""
    done = {text for _, _, text in result["completed"]}
    kept = [r for t, r in system.capture.rows.items() if t in done]
    if not kept:
        raise RuntimeError("no captured row completed in the window")
    for r in kept:                 # what the capture left on the device, read now
        for k, v in r.items():
            if isinstance(v, torch.Tensor):
                r[k] = v.item() if v.dim() == 0 else v.cpu().numpy()
    # a row answered without passing through every layer for its own text
    # (no decode, no waveform of its own) was never served: it fails
    fields = FIELDS + system.model_plug.FIELDS
    unserved = [r for r in kept if not all(k in r for k in fields)]
    kept = [r for r in kept if all(k in r for k in fields)]
    if not kept:
        return [{"unserved": len(unserved)}]
    kept.sort(key=lambda r: r["text"])
    longest = max(kept, key=lambda r: len(r["text"]))
    rest = [r for r in kept if r is not longest]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), size=min(rows - 1, len(rest)), replace=False) if rest else []
    out = [longest] + [rest[i] for i in sorted(pick)]
    for r in out:
        r["answer"] = result["answers"].get(r["text"])
    out[0]["unserved"] = len(unserved)
    return out


def reference(rows, conf: dict, seed: int, device, modes: dict | None = None) -> dict:
    """The reference's outputs for the sample at `modes` (float32
    throughout by default; the control's `control_modes`)."""
    modes = modes or {}
    model, vocoder = plugs(conf)
    out = model.reference(rows, conf, seed, device, modes)
    out["vocoder"] = vocoder.reference(rows, conf, seed, device, modes)
    return out


def numbers(rows, conf: dict, ref: dict, served: dict | None, device) -> dict:
    """The compared numbers, each the worst over the sample. `served`:
    outputs standing in for the program's (the control), or None to read
    the program's own from the sample."""
    model, vocoder = plugs(conf)
    out = model.numbers(rows, conf, ref, served, device)
    audio = dsp.Audio(conf["tts"]["audio"], device)
    out["vocoder_gap"] = 0.0
    for i, x in enumerate(rows):
        got = (torch.as_tensor(x["wav"], device=device) if served is None
               else served["vocoder"][i])
        out["vocoder_gap"] = max(out["vocoder_gap"], vocoder.gap(
            x, got, ref["vocoder"][i], audio, device, served is not None))
    if served is not None:
        return out
    out.update(trim_mismatch=0, answer_mismatch=sum(x.get("unserved", 0) for x in rows))
    for x in rows:
        wav = np.asarray(x["wav"], np.float32)
        end = audio.endpoint(wav)
        out["trim_mismatch"] += int(not np.array_equal(x["trimmed"], wav[:end]))
        ans = x["answer"]
        is_bytes = isinstance(ans, (bytes, bytearray))
        want = audio.wav_bytes(wav[:end]) if is_bytes else wav[:end]
        out["answer_mismatch"] += int(ans is None or not (
            ans == want if is_bytes else np.array_equal(np.asarray(ans), want)))
    return out


def check(system, result: dict, conf: dict, mix: dict, seed: int, device) -> dict:
    """The run's compared numbers beside their limits (conf["limits"]), once
    the program's state is freed."""
    rows = sample(system, result, seed, mix["sample"]["rows"])
    if "text" not in rows[0]:
        raise RuntimeError(f"no row of the window was served whole: {rows[0]}")
    system.vocoder_plug.prepare(system, rows, conf, device)
    system.close()
    with torch.no_grad():
        ref = reference(rows, conf, seed, device)
        got = numbers(rows, conf, ref, None, device)
    return {k: {"value": v, "limit": conf["limits"][k]} for k, v in got.items()}
