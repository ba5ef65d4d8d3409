"""The serving kernels as registered operators (torch.library), so that a
program traced by torch.export (`infer/export.py`) carries them as ops of
its graph and a loaded artifact launches them:

- `yvt::taco2_decode` over `ops/taco2_decode.py tacotron2_decode` (kernel 1);
- `yvt::taco1_decode` over `ops/taco1_decode.py tacotron1_decode` (kernel 8);
- `yvt::taco1_step_decode` over Tacotron(1)'s step loop
  (`models/tacotron.py TacotronDecoder._decode_loop`), which has no kernel:
  the decode of the configs kernel 8 does not serve;
- `yvt::griffin_lim` over `ops/griffin_lim.py griffin_lim_batch` (kernels
  2-4, by the route of the frame count).

Each op's implementation is the existing wrapper, which runs the plain
version for CPU tensors and launches the kernel, or raises, for CUDA
tensors; its launch counter counts the launches an artifact makes. Each op
has a fake implementation with static output shapes, which is all the
tracer sees.

A decode's weights (`prepare_weights` output, with the kernel's packed
layout where it was built) cross the op boundary as a list of tensors and
a JSON spec of their names and of the dict's other entries (dims, dtype,
scalar biases); `flatten_weights` / `unflatten_weights` convert. The decode
runs with no stream. The seed is an int64 tensor [1]; the op reads it on
the host, as the kernel takes it. Griffin-Lim's constants are built once a
(n_fft, hop, window, device) and kept.
"""

from __future__ import annotations

import json

import torch

from . import griffin_lim as gl
from . import taco1_decode as t1
from . import taco2_decode as t2

NS = "yvt"


def flatten_weights(w: dict) -> tuple[str, list[torch.Tensor]]:
    """A decode's weight dict -> (spec, tensors): every tensor once (one
    that appears under two names is listed once), nested layouts under
    dotted names ("packed.a", "resident.132.w"), and the rest in the
    spec."""
    names, index, tensors, seen, meta = [], [], [], {}, {}

    def add(name, t):
        if id(t) not in seen:
            seen[id(t)] = len(tensors)
            tensors.append(t)
        names.append(name)
        index.append(seen[id(t)])

    for k, v in w.items():
        if isinstance(v, torch.Tensor):
            add(k, v)
        elif k == "packed":
            for kk, t in v.items():
                add(f"packed.{kk}", t)
        elif k == "resident":
            for blocks, d in v.items():
                for kk, t in d.items():
                    add(f"resident.{blocks}.{kk}", t)
        elif k == "dtype":
            meta[k] = str(v).removeprefix("torch.")
        else:
            meta[k] = v
    return json.dumps({"names": names, "index": index, "meta": meta}), tensors


def unflatten_weights(spec: str, tensors) -> dict:
    """The inverse of `flatten_weights`."""
    s = json.loads(spec)
    w = {k: (getattr(torch, v) if k == "dtype" else v) for k, v in s["meta"].items()}
    for name, i in zip(s["names"], s["index"]):
        parts = name.split(".")
        if parts[0] == "packed":
            w.setdefault("packed", {})[parts[1]] = tensors[i]
        elif parts[0] == "resident":
            w.setdefault("resident", {}).setdefault(int(parts[1]), {})[parts[2]] = tensors[i]
        else:
            w[name] = tensors[i]
    return w


def _decode_fake(weights, enc_out, spec):
    OW = json.loads(spec)["meta"]["dims"]["OW"]

    def fake(max_steps: int):
        B, T = enc_out.shape[:2]
        f = lambda *s: enc_out.new_empty(*s, dtype=torch.float32)  # noqa: E731
        return (f(max_steps, B, OW), f(max_steps, B, T), f(max_steps, B),
                enc_out.new_empty(B, dtype=torch.int64))
    return fake


@torch.library.custom_op(f"{NS}::taco2_decode", mutates_args=())
def taco2_decode(weights: list[torch.Tensor], enc_out: torch.Tensor, pinp: torch.Tensor | None,
                 mask: torch.Tensor, seed: torch.Tensor, spec: str, r: int, max_steps: int,
                 norm: str, thresh: float, prenet_dropout: bool, windowing: bool,
                 win_back: int, win_front: int, forward_attn: bool, trans_agent: bool,
                 forward_attn_mask: bool
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`tacotron2_decode` (no stream): (frames [max_steps, B, OW],
    alignments [max_steps, B, T], stop probabilities [max_steps, B],
    lengths [B] in r-groups)."""
    out = t2.tacotron2_decode(
        unflatten_weights(spec, weights), enc_out, pinp, mask, r=r, max_steps=max_steps,
        norm=norm, thresh=thresh, prenet_dropout=prenet_dropout, seed=int(seed.reshape(-1)[0]),
        windowing=windowing, win_back=win_back, win_front=win_front, forward_attn=forward_attn,
        trans_agent=trans_agent, forward_attn_mask=forward_attn_mask)
    return tuple(t.contiguous() for t in out)


@taco2_decode.register_fake
def _(weights, enc_out, pinp, mask, seed, spec, r, max_steps, *_):
    return _decode_fake(weights, enc_out, spec)(max_steps)


@torch.library.custom_op(f"{NS}::taco1_decode", mutates_args=())
def taco1_decode(weights: list[torch.Tensor], enc_out: torch.Tensor, pinp: torch.Tensor,
                 mask: torch.Tensor, seed: torch.Tensor, spec: str, r: int, max_steps: int,
                 norm: str, thresh: float, prenet_dropout: bool
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`tacotron1_decode`: its four outputs, as `taco2_decode`'s."""
    out = t1.tacotron1_decode(
        unflatten_weights(spec, weights), enc_out, pinp, mask, r=r, max_steps=max_steps,
        norm=norm, thresh=thresh, prenet_dropout=prenet_dropout, seed=int(seed.reshape(-1)[0]))
    return tuple(t.contiguous() for t in out)


@taco1_decode.register_fake
def _(weights, enc_out, pinp, mask, seed, spec, r, max_steps, *_):
    return _decode_fake(weights, enc_out, spec)(max_steps)


@torch.library.custom_op(f"{NS}::taco1_step_decode", mutates_args=())
def taco1_step_decode(weights: list[torch.Tensor], enc_out: torch.Tensor,
                      lengths: torch.Tensor, seed: torch.Tensor, spec: str, r: int,
                      max_steps: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tacotron(1)'s step loop (`TacotronDecoder._decode_loop`, the decode
    of Graves, windowing, forward attention, the agent and location
    features off, which kernel 8 does not serve) on the decoder that
    `spec` and `weights` describe (`models.tacotron.step_decoder`), eager
    on enc_out's device: frames [max_steps, B, n_mels * r] and stop
    probabilities [max_steps, B] in enc_out's dtype, alignments
    [max_steps, B, T] float32, lengths [B] in r-groups. It reads whether
    every row is done every 50 steps and draws the prenet's dropout from
    the hash PRNG keyed by the seed, as the live route does."""
    from ..models.tacotron import step_decoder

    out = step_decoder(spec, weights)._decode_loop(enc_out, lengths, max_steps, r,
                                                   int(seed.reshape(-1)[0]))
    return tuple(t.contiguous() for t in out)


@taco1_step_decode.register_fake
def _(weights, enc_out, lengths, seed, spec, r, max_steps):
    n_mels = json.loads(spec)["meta"]["decoder"]["n_mels"]
    B, T = enc_out.shape[:2]
    return (enc_out.new_empty(max_steps, B, n_mels * r), enc_out.new_empty(
        max_steps, B, T, dtype=torch.float32), enc_out.new_empty(max_steps, B),
        enc_out.new_empty(B, dtype=torch.int64))


_GL_CONSTS: dict = {}


def gl_constants_for(n_fft: int, hop: int, window: torch.Tensor) -> dict:
    """`gl_constants` (bf16, as `AudioProcessor` builds them) for this
    window on its device, built once and kept."""
    win = window.detach().float().cpu().numpy()
    key = (n_fft, hop, win.tobytes(), str(window.device))
    if key not in _GL_CONSTS:
        _GL_CONSTS[key] = gl.gl_constants(n_fft, hop, win, torch.bfloat16, window.device)
    return _GL_CONSTS[key]


@torch.library.custom_op(f"{NS}::griffin_lim", mutates_args=())
def griffin_lim(mag: torch.Tensor, phase: torch.Tensor, window: torch.Tensor, n_fft: int,
                hop: int, n_iters: int, momentum: float) -> torch.Tensor:
    """`griffin_lim_batch`: magnitudes [B, T, n_fft/2 + 1] and one phase
    [T, n_fft/2 + 1] every row shares -> waveforms [B, hop * (T - 1)]."""
    return gl.griffin_lim_batch(mag, phase, gl_constants_for(n_fft, hop, window),
                                n_iters=n_iters, momentum=momentum).contiguous()


@griffin_lim.register_fake
def _(mag, phase, window, n_fft, hop, n_iters, momentum):
    return mag.new_empty(mag.shape[0], hop * (mag.shape[1] - 1), dtype=torch.float32)


def decode(kind: str, spec: str, weights: list, enc_out, pinp, mask, seed, *, r: int,
           max_steps: int, norm: str, thresh: float, prenet_dropout: bool, **attn):
    """The registered decode of `kind` ("taco2" or "taco1") with its
    weights as `flatten_weights` gives them; `attn`: kernel 1's attention
    options (`ATTN_OPTIONS`)."""
    kw = dict(r=r, max_steps=max_steps, norm=norm, thresh=thresh,
              prenet_dropout=bool(prenet_dropout))
    if kind == "taco1":
        if attn:
            raise ValueError("the Tacotron(1) decode takes no attention options")
        return torch.ops.yvt.taco1_decode(weights, enc_out, pinp, mask, seed, spec, **kw)
    o = t2.attn_options(attn)
    return torch.ops.yvt.taco2_decode(weights, enc_out, pinp, mask, seed, spec, **kw,
                                      **{k: o[k] for k in t2.ATTN_OPTIONS})
