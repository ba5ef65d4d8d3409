"""GE2E d-vector network (the JAX package's speaker_encoder/model.py): a
stack of LSTM-with-projection layers over mel frames; the embedding is the
L2-normalized projection output at the last frame.

The JAX package has no Pallas kernel here, so the layers are torch's
nn.LSTM (cuDNN on the card), differentiable for training
(speaker_encoder/train.py; cuDNN's LSTM backward wants training mode). The
JAX layout keeps one bias a layer: the LSTM's second bias stays zero and
out of training. Runs on CUDA unless given another device.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..nn.rnn import run_rnn
from ..train.checkpoint import jax_layouts, params_from_jax, read_checkpoint


class LSTMWithProjection(nn.Module):
    """LSTM(hidden) with an output projection to `proj`, gate order (i, f, g,
    o). recur_on_proj=True (the JAX package's default, an LSTMP): the
    projected output is also the next step's recurrent input, which is
    torch's nn.LSTM with proj_size (its second bias zero). False: a plain
    nn.LSTM recurring on its own hidden, then a bias-free Linear projection
    of its output sequence (the reference's layout)."""

    def __init__(self, in_dim: int, hidden: int, proj: int, recur_on_proj: bool = True):
        super().__init__()
        self.recur_on_proj = recur_on_proj
        if recur_on_proj:
            if proj >= hidden:
                raise ValueError(f"an LSTM recurring on its projection needs proj < hidden "
                                 f"(nn.LSTM's proj_size); got proj {proj}, hidden {hidden}")
            self.lstm = nn.LSTM(in_dim, hidden, batch_first=True, proj_size=proj)
        else:
            self.lstm = nn.LSTM(in_dim, hidden, batch_first=True)
            self.proj = nn.Linear(hidden, proj, bias=False)

    @property
    def jax_layout(self) -> str:
        return "lstmp" if self.recur_on_proj else "lstm_proj"

    def forward(self, xs):
        """[B, T, in] -> [B, T, proj]."""
        ys, _ = run_rnn(self.lstm, xs)
        return ys if self.recur_on_proj else self.proj(ys)


class SpeakerEncoder(nn.Module):
    """num_layers x LSTMP(lstm_dim -> proj_dim) -> L2-normalized proj_dim-wide
    d-vector (defaults: 3 x 768 -> 256, the reference's)."""

    def __init__(self, input_dim: int = 80, proj_dim: int = 256, lstm_dim: int = 768,
                 num_layers: int = 3, recur_on_proj: bool = True, device=None, seed: int = 0):
        """Seeded random weights, U(-1/sqrt(lstm_dim), 1/sqrt(lstm_dim)) as the
        JAX package's (the second LSTM bias zero), until a checkpoint is
        loaded; on `device`, CUDA unless given."""
        super().__init__()
        dims = [input_dim] + [proj_dim] * num_layers
        self.layers = nn.ModuleList(LSTMWithProjection(dims[i], lstm_dim, proj_dim, recur_on_proj)
                                    for i in range(num_layers))
        self.proj_dim = proj_dim
        g = torch.Generator().manual_seed(seed)
        s = 1.0 / math.sqrt(lstm_dim)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if "bias_hh" in name:
                    p.zero_()
                    p.requires_grad_(False)
                else:
                    p.uniform_(-s, s, generator=g)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, mels):
        """mels [B, T, n_mels] -> embeddings [B, proj_dim], L2-normalized."""
        x = mels
        for layer in self.layers:
            x = layer(x)
        emb = x[:, -1]
        return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-8)

    @torch.no_grad()
    def compute_embedding(self, mel, num_frames: int = 160, overlap: float = 0.5):
        """The d-vector of one utterance, mel [T, n_mels]: a mel of at most
        num_frames frames is tiled to num_frames and embedded once; a longer
        one is cut into windows of num_frames at a hop of num_frames x
        (1 - overlap), whose embeddings are averaged and re-normalized."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        T = mel.shape[0]
        if T <= num_frames:
            mel = mel.repeat(-(-num_frames // T), 1)[:num_frames]
            return self(mel[None])[0]
        hop = max(1, int(num_frames * (1 - overlap)))
        starts = list(range(0, T - num_frames + 1, hop)) or [0]
        mean = self(torch.stack([mel[s: s + num_frames] for s in starts])).mean(0)
        return mean / mean.norm().clamp_min(1e-8)


def params_to_jax(tensors: dict) -> dict:
    """A SpeakerEncoder's parameters, or anything laid out like them (its
    gradients, Adam's moments), as {name: tensor} -> {keystr: numpy
    float32} in the JAX package's layout: each layer's wx [in, 4H], wh
    [rec, 4H], b [4H] (the LSTM's two biases summed) and proj [H, P]. The
    inverse of `train.checkpoint.params_from_jax` with `jax_layouts`."""
    out: dict[str, np.ndarray] = {}
    npy = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    for name, t in tensors.items():
        m = re.fullmatch(r"layers\.(\d+)\.(lstm\.\w+|proj\.weight)", name)
        if m is None:
            raise KeyError(f"not a speaker-encoder parameter: {name}")
        key = f"['layers'][{m.group(1)}]"
        leaf = {"lstm.weight_ih_l0": "wx", "lstm.weight_hh_l0": "wh", "lstm.bias_ih_l0": "b",
                "lstm.weight_hr_l0": "proj", "proj.weight": "proj"}.get(m.group(2))
        if leaf is None:
            if m.group(2) != "lstm.bias_hh_l0":
                raise KeyError(f"not a speaker-encoder parameter: {name}")
            continue
        arr = npy(t)
        if leaf == "b":
            hh = tensors.get(name.replace("bias_ih", "bias_hh"))
            out[f"{key}['b']"] = arr + (0 if hh is None else npy(hh))
        else:
            out[f"{key}['{leaf}']"] = np.ascontiguousarray(arr.T)
    return out


def arch_from_checkpoint(path: str) -> dict:
    """SpeakerEncoder's constructor arguments from a checkpoint's parameter
    shapes: wx of layer 0 gives (input_dim, 4 lstm_dim), proj gives proj_dim,
    and wh's first dim tells recur_on_proj (== proj_dim) from the
    reference's recurrence (== lstm_dim); proj_dim == lstm_dim reads as
    True."""
    with np.load(path) as z:
        shapes = {k[len("params::"):]: z[k].shape for k in z.files
                  if k.startswith("params::['layers']")}
    layers = {int(re.match(r"\['layers'\]\[(\d+)\]", k).group(1)) for k in shapes}
    wx, proj, wh = (shapes[f"['layers'][0]['{n}']"] for n in ("wx", "proj", "wh"))
    lstm_dim, proj_dim = wx[1] // 4, proj[1]
    return {"input_dim": wx[0], "proj_dim": proj_dim, "lstm_dim": lstm_dim,
            "num_layers": len(layers),
            "recur_on_proj": wh[0] == proj_dim if proj_dim != lstm_dim else True}


def load_encoder(checkpoint: str, default_input_dim: int = 80, device=None) -> SpeakerEncoder:
    """A SpeakerEncoder built to a JAX-package checkpoint and loaded from it
    (strict). The architecture comes from the meta's "speaker_encoder"
    record where it has one, else from the parameter shapes
    (`arch_from_checkpoint`). The checkpoint's model state (the GE2E loss's
    scale and offset) is training state and is not read."""
    params, _, meta = read_checkpoint(checkpoint)
    kw = meta.get("speaker_encoder") or arch_from_checkpoint(checkpoint)
    enc = SpeakerEncoder(input_dim=kw.get("input_dim", default_input_dim),
                         proj_dim=kw.get("proj_dim", 256), lstm_dim=kw.get("lstm_dim", 768),
                         num_layers=kw.get("num_layers", 3),
                         recur_on_proj=kw.get("recur_on_proj", True), device=device)
    enc.load_state_dict(params_from_jax(params, {}, jax_layouts(enc)), strict=True)
    return enc
