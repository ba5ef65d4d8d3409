"""Tacotron2 as the benchmark serves and checks it: the plug that a
configuration names under "plugs" -> "model".

A model plug gives the harness, by these names:
- KERNELS: the port's CUDA kernels its serving path builds;
- CONTROL: the precision below the configuration's, per part, for the
  control (`control.py`): the decode's bf16 products in fp8, the encoder
  and postnet (float32, TF32 off) in TF32;
- FIELDS: what a served row has to have been captured with;
- weight_spec(conf): the seeded weights both sides load;
- install(system): the capture around the model's `inference`;
- keep_result(row, res): what it keeps of a row of `synthesis_batch`;
- reference(rows, conf, seed, device, modes) and numbers(...): the plain
  reference's outputs for the sample and the compared numbers;
- flops(conf, call): the call's model operations (float32, bf16).

The decode is checked teacher-forced (reference/tacotron2.py): frames,
stop logits and alignments against the reference's prediction from the
frames the program fed back; the ids and the lengths exactly; the postnet
over the served frames.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts
from portbench.reference import tacotron2 as ref
from portbench.reference.text import SYMBOL_ID, text_ids
from portbench.weights import draw, subseed

KERNELS = ("taco2_decode",)
CONTROL = {"decode": "fp8", "encoder": "tf32", "postnet": "tf32"}
FIELDS = ("ids", "decoder", "postnet", "mel_length", "row", "padded", "stop_probs",
          "alignment")


def weight_spec(conf: dict) -> list:
    m = conf["tts"]
    r_init = max([m["r"]] + [row[1] for row in m.get("gradual_training") or []])
    # the program's table also holds the ARPAbet entries after the characters
    n_symbols = len(SYMBOL_ID) + conf["arpabet_symbols"]
    return ref.weight_spec(m, n_symbols, m["audio"]["num_mels"], r_init)


def install(system) -> None:
    """Keep, for each captured row, the ids and batch row it was served at,
    the padded text length, the decoder's frames and its length; and each
    call's padded length for the counts."""
    cap, model = system.capture, system.synth.model
    orig = model.inference

    def inference(text, text_lengths, *a, **kw):
        out = orig(text, text_lengths, *a, **kw)
        cap.local.call["padded"] = int(text.shape[1])
        keep = [i for i in cap.local.keep if i < text.shape[0]]
        if keep:
            # copies on the device, read after the window (check.sample):
            # the capture makes the host wait for nothing
            dec = out["decoder_outputs"][keep].clone()
            lens = out["mel_lengths"][keep].clone()
            for j, i in enumerate(keep):
                cap.rows.setdefault(cap.local.texts[i], {}).update(
                    ids=np.array(text[i]), length=int(text_lengths[i]), row=i,
                    padded=int(text.shape[1]), decoder=dec[j], mel_length=lens[j])
        return out
    model.inference = system.timed("model.inference", inference)


def keep_result(row: dict, res: dict) -> None:
    row.update(stop_probs=res["stop_tokens"], alignment=res["alignment"])


def reference(rows, conf: dict, seed: int, device, modes: dict) -> dict:
    """Frames, stop logits, alignments and lengths teacher-forced on the
    served frames; the postnet over the served frames; the ids."""
    tts = conf["tts"]
    nm, r = tts["audio"]["num_mels"], tts["r"]
    W = draw(weight_spec(conf), subseed(seed, "tts"), device)
    B = len(rows)
    ids = [torch.tensor(text_ids(x["text"]), dtype=torch.long, device=device) for x in rows]
    dec = torch.stack([torch.as_tensor(x["decoder"], device=device) for x in rows])
    S = dec.shape[1] // r
    groups = dec.reshape(B, S, r * nm)
    # the frame fed into each step: the served last frame of the step before
    fed = torch.cat([torch.zeros(B, 1, nm, device=device), groups[:, :-1, -nm:]], 1)
    frames, stops, aligns, lens = [None] * B, [None] * B, [None] * B, [None] * B
    # rows served at one padded text length encode and decode together: a
    # row's last convolutions see the batch's padding symbols up to that
    # length, as served
    for Tp in sorted({x["padded"] for x in rows}):
        idx = [i for i, x in enumerate(rows) if x["padded"] == Tp]
        tok = torch.zeros(len(idx), Tp, dtype=torch.long, device=device)
        for j, i in enumerate(idx):
            tok[j, :min(len(ids[i]), Tp)] = ids[i][:Tp]
        n = torch.tensor([min(len(ids[i]), Tp) for i in idx], device=device)
        memory = ref.encode(W, tok, n, modes.get("encoder", "f32"))
        f, s, a, ln = ref.decode_teacher_forced(
            W, memory, n, fed[idx], torch.tensor([rows[i]["row"] for i in idx], device=device),
            r=r, n_mels=nm, seed=conf["dropout_seed"], thresh=tts["stop_threshold"],
            prenet_dropout=tts["prenet_dropout"], mode=modes.get("decode", "f32"))
        for j, i in enumerate(idx):
            frames[i], stops[i], aligns[i], lens[i] = f[j], s[j], a[j], int(ln[j])
    post = ref.postnet(W, dec, modes.get("postnet", "f32"))
    return {"frames": frames, "stop_logits": stops, "aligns": aligns, "lengths": lens,
            "postnet": post, "ids": ids}


def _logit(p):
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


def numbers(rows, conf: dict, want: dict, served: dict | None, device) -> dict:
    """The worst gap over the sample of each compared number; with `served`
    None the program's own outputs (and the exact counts), else the
    control's in their place."""
    tts = conf["tts"]
    nm, r = tts["audio"]["num_mels"], tts["r"]
    out = {k: 0.0 for k in ("decode_gap", "stop_gap", "align_gap", "postnet_gap")}
    if served is None:
        out.update(ids_mismatch=0, length_mismatch=0)
    for i, x in enumerate(rows):
        live = max(1, x["mel_length"] // r)
        ref_f = want["frames"][i][:live]
        if served is None:
            got_f = torch.as_tensor(x["decoder"], device=device).reshape(-1, r * nm)[:live]
            got_s = torch.as_tensor(_logit(x["stop_probs"][:live]), device=device).float()
            got_a = torch.as_tensor(x["alignment"][:live], device=device)
            got_post = torch.as_tensor(x["postnet"].T, device=device)
            ids = want["ids"][i].cpu().numpy()
            got = np.asarray(x["ids"])
            out["ids_mismatch"] += int(not (x["length"] == len(ids)
                                            and np.array_equal(got[:len(ids)], ids)
                                            and not got[len(ids):].any()))
            out["length_mismatch"] += int(x["mel_length"] != want["lengths"][i])
        else:
            got_f = served["frames"][i][:live]
            got_s = served["stop_logits"][i][:live]
            got_a = served["aligns"][i][:live]
            got_post = served["postnet"][i][:x["postnet"].shape[1]]
        rms = torch.sqrt((ref_f ** 2).sum(-1).mean()).clamp_min(1e-12)
        out["decode_gap"] = max(out["decode_gap"],
                                float(torch.linalg.norm(got_f - ref_f, dim=-1).max() / rms))
        out["stop_gap"] = max(out["stop_gap"],
                              float((got_s - want["stop_logits"][i][:live]).abs().max()))
        out["align_gap"] = max(out["align_gap"], float(
            (got_a - want["aligns"][i][:live, :got_a.shape[-1]]).abs().sum(-1).max()))
        ref_post = want["postnet"][i][:x["postnet"].shape[1]]
        out["postnet_gap"] = max(out["postnet_gap"], float(
            (got_post - ref_post).abs().max() / torch.sqrt((ref_post ** 2).mean())))
    return out


def flops(conf: dict, call: dict) -> tuple[float, float]:
    """(float32, bf16) operations of one call: encoder and key projection,
    the decode (bf16 products, float32 attention), the postnet."""
    tts = conf["tts"]
    d = counts.decode(tts, call)
    return d["f32_flops"] + counts.encoder(tts, call) + counts.postnet(tts, call), \
        d["bf16_flops"]
