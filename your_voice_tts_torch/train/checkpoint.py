"""Checkpoint bridge: the JAX package's `.npz` checkpoints, read without JAX.

The format (JAX package train/checkpoint.py) is one `.npz` whose entries are
``<section>::<keypath>`` leaves — section ``params`` or ``model_state``,
keypath a ``jax.tree_util.keystr`` string such as
``['decoder']['attention_rnn']['wx']`` or ``['blocks'][0]['bn']['mean']`` —
plus a ``__meta__`` JSON blob (``r``, ``step``, ...).

`read_checkpoint` rebuilds the nested dict/list trees from those key paths;
`params_from_jax` turns the trees into the ``state_dict`` of the port's
Tacotron2, Tacotron(1), ParallelTTS or WaveRNN (whose checkpoints hold no
model state), running the
layout map of the JAX package's utils/torch_import.py in reverse:

- Dense ``w`` [in, out] -> ``weight`` [out, in];
- Conv1d ``w`` [k, in, out] -> ``weight`` [out, in, k];
- LSTM ``wx`` [in, 4H] / ``wh`` [H, 4H] / one summed ``b`` -> ``weight_ih``,
  ``weight_hh``, ``bias`` (the encoder's nn.LSTM gets the summed bias as
  ``bias_ih`` and a zero ``bias_hh``);
- GRU ``wx`` [in, 3H] / ``wh`` [H, 3H] / ``bx`` / ``bh`` -> ``weight_ih``,
  ``weight_hh``, ``bias_ih``, ``bias_hh`` (torch.nn.GRUCell: WaveRNN's, the
  Tacotron(1) decoder's); a CBHG's ``gru_fwd`` / ``gru_bwd`` pair -> its
  bidirectional nn.GRU ``gru`` (``..._l0`` and ``..._l0_reverse``);
- BatchNorm ``scale``/``bias`` + state ``mean``/``var`` -> ``weight``/``bias``
  + ``running_mean``/``running_var``; LayerNorm ``scale``/``bias`` ->
  ``weight``/``bias`` (ParallelTTS's, no state);
- modules whose port class names a ``jax_layout`` (`jax_layouts`), which
  the generic rules above would misread:
  - ``"conv_transpose"``, a ConvTranspose1d: ``w`` [k, in, out] with the
    kernel axis flipped -> ``weight`` [in, out, k];
  - ``"lstmp"`` / ``"lstm_proj"``, the speaker encoder's LSTM with
    projection: ``wx`` / ``wh`` / ``b`` -> its nn.LSTM ``lstm`` (``..._l0``,
    zero ``bias_hh``), ``proj`` [H, P] -> ``lstm.weight_hr_l0`` (recurring on
    the projection) or the Linear ``proj.weight``;
  - ``"gru"``, a GRU over a sequence (the GST reference encoder's):
    ``wx`` / ``wh`` / ``bx`` / ``bh`` -> its nn.GRU's ``..._l0``;
  - ``"conv2d_bn"``, a GST convolution: ``w`` [3, 3, in, ch] (HWIO) ->
    ``conv.weight`` [ch, in, 3, 3] (OIHW), ``b`` -> ``conv.bias``, and the
    BatchNorm's state ``mean`` / ``var``, kept beside ``w`` rather than
    under ``bn``, -> ``bn.running_mean`` / ``bn.running_var``;
- the GST style tokens ``tokens`` -> ``tokens``.

`load_generator` reads the generator (the ``['g']`` subtree) of a GAN
vocoder checkpoint, which also holds the discriminator.

`save_checkpoint` writes the same format from a port model (`params_to_jax`
is the map above, forwards), so the JAX package's `restore_partial` loads
it; the port's optimizer state goes into a section of its own,
``port_optimizer::<name>::<parameter>``, which the JAX package skips.

`save_trainer_checkpoint` / `restore_trainer_checkpoint` write and read
the vocoder and ParallelTTS trainers' checkpoints in the JAX trainers' own
layout, so that each package's trainer restores the other's strictly: the
parameters of each model (under a subtree key, as a GAN keeps ``['g']``
and ``['d']``), its model state, and its `optim.ClipAdam` state as optax's
chain(clip, adam) state, ``opt_state::<subtree>[1][0].count`` /
``.mu<keypath>`` / ``.nu<keypath>`` with the moments in the parameters'
JAX layouts (under apply_if_finite ``.inner_state[1][0]...`` and the
wrapper's counters).
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import re

import numpy as np
import torch

_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def parse_keypath(key: str) -> list[str | int]:
    """``"['blocks'][0]['bn']['mean']"`` -> ``['blocks', 0, 'bn', 'mean']``."""
    parts: list[str | int] = []
    pos = 0
    for m in _KEY_RE.finditer(key):
        if m.start() != pos:
            raise ValueError(f"malformed checkpoint key path {key!r}")
        parts.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"malformed checkpoint key path {key!r}")
    return parts


def _insert(tree, path, value):
    node = tree
    for i, part in enumerate(path):
        last = i == len(path) - 1
        child = [] if (not last and isinstance(path[i + 1], int)) else {}
        if isinstance(part, int):
            if not isinstance(node, list):
                raise ValueError(f"index {part} into a non-list at {path}")
            while len(node) <= part:
                node.append(None)
            if last:
                node[part] = value
            elif node[part] is None:
                node[part] = child
            node = node[part]
        else:
            if last:
                node[part] = value
            else:
                node = node.setdefault(part, child)
    return tree


def read_checkpoint(path: str) -> tuple[dict, dict, dict]:
    """Read a JAX-package checkpoint -> (params, model_state, meta) as nested
    dicts/lists of numpy arrays. Optimizer state, if any, is ignored."""
    with np.load(path, allow_pickle=False) as z:
        blobs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(blobs.pop("__meta__")).decode())
    trees: dict[str, dict] = {"params": {}, "model_state": {}}
    for key, value in blobs.items():
        section, _, keypath = key.partition("::")
        if section in trees:
            _insert(trees[section], parse_keypath(keypath), value)
    return trees["params"], trees["model_state"], meta


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, tree


_ENCODER_LSTM = {"lstm_fwd": "", "lstm_bwd": "_reverse"}
_CBHG_GRU = {"gru_fwd": "", "gru_bwd": "_reverse"}
_GRU_LEAF = {"wx": "weight_ih", "wh": "weight_hh", "bx": "bias_ih", "bh": "bias_hh"}
_LSTMP_LEAF = {"wx": "lstm.weight_ih_l0", "wh": "lstm.weight_hh_l0"}


def jax_layouts(model: torch.nn.Module) -> dict[str, str]:
    """{module name: its class's ``jax_layout``} for the modules of `model`
    whose JAX leaves the generic rules of `params_from_jax` would misread."""
    return {name: m.jax_layout for name, m in model.named_modules()
            if getattr(m, "jax_layout", None)}


def _special_leaf(put, kind: str, base: str, leaf: str, arr, path) -> None:
    if kind == "conv_transpose" and leaf in ("w", "b"):
        put(f"{base}.{'weight' if leaf == 'w' else 'bias'}",
            arr[::-1].transpose(1, 2, 0) if leaf == "w" else arr)
    elif kind == "gru" and leaf in _GRU_LEAF:
        put(f"{base}.{_GRU_LEAF[leaf]}_l0", arr.T if leaf in ("wx", "wh") else arr)
    elif kind == "conv2d_bn" and leaf in ("w", "b"):
        put(f"{base}.conv.{'weight' if leaf == 'w' else 'bias'}",
            arr.transpose(3, 2, 0, 1) if leaf == "w" else arr)
    elif kind in ("lstmp", "lstm_proj") and leaf in ("wx", "wh", "b", "proj"):
        if leaf == "b":
            put(f"{base}.lstm.bias_ih_l0", arr)
            put(f"{base}.lstm.bias_hh_l0", np.zeros_like(arr))
        elif leaf == "proj":
            put(f"{base}.{'lstm.weight_hr_l0' if kind == 'lstmp' else 'proj.weight'}", arr.T)
        else:
            put(f"{base}.{_LSTMP_LEAF[leaf]}", arr.T)
    else:
        raise KeyError(f"unexpected {kind} leaf {path}")


def params_from_jax(params: dict, state: dict,
                    layouts: dict[str, str] | None = None) -> dict[str, torch.Tensor]:
    """JAX-layout params/state (numpy trees) of a Tacotron2, a Tacotron(1),
    a WaveRNN, a GAN generator or a speaker encoder -> the port model's
    ``state_dict`` (float32 CPU tensors). `layouts` (`jax_layouts` of the
    model) names the modules the generic rules would misread."""
    sd: dict[str, torch.Tensor] = {}
    layouts = layouts or {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.array(arr, np.float32))

    for path, arr in _walk(params):
        *mods, leaf = path
        arr = np.asarray(arr)
        name = ".".join(map(str, mods))
        if name in layouts:
            _special_leaf(put, layouts[name], name, leaf, arr, path)
            continue
        if len(mods) >= 2 and mods[-2] == "encoder" and mods[-1] in _ENCODER_LSTM:
            sfx = _ENCODER_LSTM[mods[-1]]
            base = ".".join(map(str, mods[:-1] + ["lstm"]))
            if leaf == "wx":
                put(f"{base}.weight_ih_l0{sfx}", arr.T)
            elif leaf == "wh":
                put(f"{base}.weight_hh_l0{sfx}", arr.T)
            elif leaf == "b":
                put(f"{base}.bias_ih_l0{sfx}", arr)
                put(f"{base}.bias_hh_l0{sfx}", np.zeros_like(arr))
            else:
                raise KeyError(f"unexpected encoder LSTM leaf {path}")
            continue
        if mods and mods[-1] in _CBHG_GRU:
            if leaf not in _GRU_LEAF:
                raise KeyError(f"unexpected CBHG GRU leaf {path}")
            base = ".".join(map(str, mods[:-1] + ["gru"]))
            put(f"{base}.{_GRU_LEAF[leaf]}_l0{_CBHG_GRU[mods[-1]]}",
                arr.T if leaf in ("wx", "wh") else arr)
            continue
        base = ".".join(map(str, mods))
        if leaf == "w" and arr.ndim == 2:
            put(f"{base}.weight", arr.T)
        elif leaf == "w" and arr.ndim == 3:
            put(f"{base}.weight", arr.transpose(2, 1, 0))
        elif leaf in ("b", "bias"):
            put(f"{base}.bias", arr)
        elif leaf in ("table", "scale"):
            put(f"{base}.weight", arr)
        elif leaf == "tokens":
            put(f"{base}.tokens", arr)
        elif leaf == "wx":
            put(f"{base}.weight_ih", arr.T)
        elif leaf == "wh":
            put(f"{base}.weight_hh", arr.T)
        elif leaf in ("bx", "bh"):
            put(f"{base}.bias_{'ih' if leaf == 'bx' else 'hh'}", arr)
        else:
            raise KeyError(f"unexpected parameter leaf {path}")
    for path, arr in _walk(state):
        *mods, leaf = path
        base = ".".join(map(str, mods))
        if layouts.get(base) == "conv2d_bn":
            base += ".bn"
        if leaf == "mean":
            put(f"{base}.running_mean", arr)
        elif leaf == "var":
            put(f"{base}.running_var", arr)
        else:
            raise KeyError(f"unexpected model-state leaf {path}")
    return sd


def load_checkpoint(model: torch.nn.Module, path: str) -> dict:
    """Load a JAX-package checkpoint into `model` (strict); returns meta."""
    params, state, meta = read_checkpoint(path)
    model.load_state_dict(params_from_jax(params, state, jax_layouts(model)), strict=True)
    return meta


def load_generator(model: torch.nn.Module, path: str) -> dict:
    """Load the generator of a GAN vocoder checkpoint (its ``['g']``
    subtree; the discriminator's ``['d']`` and the optimizer state are left
    out) into `model` (strict), as the JAX package's
    `_restore_generator_subtree`; returns meta."""
    params, _, meta = read_checkpoint(path)
    if "g" not in params:
        raise KeyError(f"{path} holds no generator subtree ['g']")
    model.load_state_dict(params_from_jax(params["g"], {}, jax_layouts(model)), strict=True)
    return meta


OPT_SECTION = "port_optimizer"


def _keystr(parts) -> str:
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']" for p in parts)


def _path(name: str) -> list[str | int]:
    return [int(p) if p.isdigit() else p for p in name.split(".")] if name else []


def params_to_jax(model: torch.nn.Module) -> tuple[dict, dict]:
    """The port's Tacotron2, Tacotron(1), WaveRNN, MelGAN or PWGAN generator
    or speaker encoder -> (params, model_state) as flat {keystr: numpy
    float32} in the JAX package's layouts (the inverse of
    `params_from_jax`)."""
    from ..models.gst import StyleTokenLayer
    from ..nn.core import BatchNorm1d, Conv1d, LayerNorm
    from ..nn.rnn import GRU, LSTMCell
    from ..speaker_encoder.model import SpeakerEncoder
    from ..speaker_encoder.model import params_to_jax as encoder_params

    if isinstance(model, SpeakerEncoder):
        return encoder_params(dict(model.named_parameters())), {}
    layouts = jax_layouts(model)
    params: dict[str, np.ndarray] = {}
    state: dict[str, np.ndarray] = {}
    npy = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    for name, mod in model.named_modules():
        path = _path(name)
        put = lambda leaf, arr, tree=params, p=path: tree.__setitem__(  # noqa: E731
            _keystr(p + [leaf]), np.ascontiguousarray(arr))
        if isinstance(mod, torch.nn.Embedding):
            put("table", npy(mod.weight))
        elif isinstance(mod, torch.nn.Linear):
            put("w", npy(mod.weight).T)
            if mod.bias is not None:
                put("b", npy(mod.bias))
        elif isinstance(mod, Conv1d):
            put("w", npy(mod.weight).transpose(2, 1, 0))
            if mod.bias is not None:
                put("b", npy(mod.bias))
        elif isinstance(mod, BatchNorm1d):
            put("scale", npy(mod.weight))
            put("bias", npy(mod.bias))
            owner = path[:-1] if layouts.get(".".join(map(str, path[:-1]))) == "conv2d_bn" \
                else path
            put("mean", npy(mod.running_mean), state, owner)
            put("var", npy(mod.running_var), state, owner)
        elif isinstance(mod, LayerNorm):
            put("scale", npy(mod.weight))
            put("bias", npy(mod.bias))
        elif layouts.get(name) == "conv_transpose":
            put("w", npy(mod.weight).transpose(2, 0, 1)[::-1])
            if mod.bias is not None:
                put("b", npy(mod.bias))
        elif layouts.get(name) == "conv2d_bn":
            put("w", npy(mod.conv.weight).transpose(2, 3, 1, 0))
            put("b", npy(mod.conv.bias))
        elif isinstance(mod, StyleTokenLayer):
            put("tokens", npy(mod.tokens))
        elif isinstance(mod, GRU):
            for leaf, name in _GRU_LEAF.items():
                t = npy(getattr(mod, f"{name}_l0"))
                put(leaf, t.T if leaf in ("wx", "wh") else t)
        elif isinstance(mod, LSTMCell):
            put("wx", npy(mod.weight_ih).T)
            put("wh", npy(mod.weight_hh).T)
            put("b", npy(mod.bias))
        elif isinstance(mod, torch.nn.GRUCell):
            for leaf, name in _GRU_LEAF.items():
                t = npy(getattr(mod, name))
                put(leaf, t.T if leaf in ("wx", "wh") else t)
        elif isinstance(mod, torch.nn.GRU):
            for jax_name, sfx in _CBHG_GRU.items():
                for leaf, name in _GRU_LEAF.items():
                    t = npy(getattr(mod, f"{name}_l0{sfx}"))
                    params[_keystr(path[:-1] + [jax_name, leaf])] = np.ascontiguousarray(
                        t.T if leaf in ("wx", "wh") else t)
        elif isinstance(mod, torch.nn.LSTM):
            for jax_name, sfx in _ENCODER_LSTM.items():
                p = path[:-1] + [jax_name]
                g = lambda k, s=sfx: npy(getattr(mod, f"{k}_l0{s}"))  # noqa: E731
                params[_keystr(p + ["wx"])] = g("weight_ih").T.copy()
                params[_keystr(p + ["wh"])] = g("weight_hh").T.copy()
                params[_keystr(p + ["b"])] = g("bias_ih") + g("bias_hh")
    return params, state


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None, *, step: int,
                    epoch: int, r: int, extra: dict | None = None,
                    subtree: str | None = None) -> str:
    """Write `model` (and the optimizer's state) as a JAX-package
    checkpoint .npz. subtree puts the parameters under one key, as a GAN
    checkpoint keeps its generator under 'g' (`load_generator`)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    params, state = params_to_jax(model)
    pre = "" if subtree is None else _keystr([subtree])
    blobs = {f"params::{pre}{k}": v for k, v in params.items()}
    blobs.update({f"model_state::{pre}{k}": v for k, v in state.items()})
    if optimizer is not None:
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        opt = optimizer.state_dict()
        for kind in ("mu", "nu"):
            for n, t in zip(names, opt[kind]):
                blobs[f"{OPT_SECTION}::{kind}::{n}"] = t.detach().float().cpu().numpy()
        for k in ("count", "notfinite_count", "total_notfinite"):
            blobs[f"{OPT_SECTION}::{k}"] = np.asarray(opt[k], np.int64)
    meta = {"step": int(step), "epoch": int(epoch), "r": int(r),
            "date": datetime.datetime.now().isoformat(), **(extra or {})}
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **blobs)
    return path


def read_optimizer_state(path: str, model: torch.nn.Module) -> dict | None:
    """The port optimizer's state from a checkpoint, ordered as the model's
    trained parameters; None when the file holds none."""
    with np.load(path, allow_pickle=False) as z:
        if f"{OPT_SECTION}::count" not in z.files:
            return None
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        out = {kind: [torch.from_numpy(z[f"{OPT_SECTION}::{kind}::{n}"]) for n in names]
               for kind in ("mu", "nu")}
        for k in ("count", "notfinite_count", "total_notfinite"):
            out[k] = int(z[f"{OPT_SECTION}::{k}"])
    return out


def save_best_model(current_loss: float, best_loss: float, out_path: str,
                    **ckpt_kwargs) -> float:
    """Overwrite best_model.npz when the eval loss improves; returns the
    best loss so far."""
    if current_loss < best_loss:
        save_checkpoint(os.path.join(out_path, "best_model.npz"), **ckpt_kwargs)
        return current_loss
    return best_loss


@contextlib.contextmanager
def _swapped(model: torch.nn.Module, tensors: list):
    """`model`'s trainable parameters read `tensors` (in named_parameters
    order) inside the block: `params_to_jax` then lays out tensors shaped
    like the parameters, Adam's moments."""
    params = [p for p in model.parameters() if p.requires_grad]
    saved = [p.data for p in params]
    try:
        for p, t in zip(params, tensors):
            p.data = t
        yield
    finally:
        for p, d in zip(params, saved):
            p.data = d


_FINITE = {"notfinite_count": np.int32, "last_finite": np.bool_, "total_notfinite": np.int32}


def save_trainer_checkpoint(path: str, parts: dict, *, step: int, extra: dict,
                            epoch: int = 0) -> str:
    """A trainer's checkpoint in the JAX trainers' layout: parts {subtree
    key, or None for the whole tree: (model, its ClipAdam)}; r 1 in the
    meta, as the JAX vocoder and ParallelTTS trainers write it. The Adam
    state goes to the ClipAdam's `jax_path` (``[1][0]``, or
    ``.inner_state[1][0]`` under apply_if_finite, whose counters
    ``.notfinite_count`` / ``.last_finite`` / ``.total_notfinite`` go
    beside it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blobs = {}
    for key, (model, adam) in parts.items():
        pre = "" if key is None else _keystr([key])
        params, state = params_to_jax(model)
        blobs.update({f"params::{pre}{k}": v for k, v in params.items()})
        blobs.update({f"model_state::{pre}{k}": v for k, v in state.items()})
        at = f"opt_state::{pre}{adam.jax_path}"
        blobs[f"{at}.count"] = np.asarray(int(adam.count), np.int32)
        if adam.if_finite:
            for name, dt in _FINITE.items():
                blobs[f"opt_state::{pre}.{name}"] = np.asarray(
                    getattr(adam, name).item(), dt)
        for kind in ("mu", "nu"):
            with _swapped(model, getattr(adam, kind)):
                moments, _ = params_to_jax(model)
            blobs.update({f"{at}.{kind}{k}": v for k, v in moments.items()})
    meta = {"step": int(step), "epoch": int(epoch), "r": 1,
            "date": datetime.datetime.now().isoformat(), **extra}
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **blobs)
    return path


@torch.no_grad()
def restore_trainer_checkpoint(path: str, parts: dict) -> dict:
    """Load a checkpoint `save_trainer_checkpoint` or a JAX vocoder or
    ParallelTTS trainer wrote into parts {subtree key or None: (model,
    ClipAdam)}, strictly: every parameter, the model state, both moments of
    each trained parameter, Adam's count and, under apply_if_finite, its
    counters. Returns the meta."""
    with np.load(path, allow_pickle=False) as z:
        blobs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(blobs.pop("__meta__")).decode())
    params, state, _ = read_checkpoint(path)
    for key, (model, adam) in parts.items():
        pre = "" if key is None else _keystr([key])
        layouts = jax_layouts(model)
        if key is not None and key not in params:
            raise KeyError(f"{path} holds no parameter subtree {pre}")
        model.load_state_dict(params_from_jax(params if key is None else params[key],
                                              state if key is None else state.get(key, {}),
                                              layouts), strict=True)
        at = f"opt_state::{pre}{adam.jax_path}"
        if f"{at}.count" not in blobs:
            raise KeyError(f"{path} holds no Adam state at {at}.count")
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
        for kind in ("mu", "nu"):
            prefix = f"{at}.{kind}"
            tree: dict = {}
            for k, v in blobs.items():
                if k.startswith(prefix):
                    _insert(tree, parse_keypath(k[len(prefix):]), v)
            sd = {k: v for k, v in params_from_jax(tree, {}, layouts).items() if k not in frozen}
            if set(sd) != set(names):
                raise KeyError(f"{path}: the Adam {kind} under {pre or 'the root'} does not "
                               f"match the parameters ({sorted(set(names) ^ set(sd))[:4]})")
            for m, n in zip(getattr(adam, kind), names):
                m.copy_(sd[n])
        if not adam.if_finite:
            adam.count = int(blobs[f"{at}.count"])
            continue
        for name in ("count",) + tuple(_FINITE):
            k = f"{at}.count" if name == "count" else f"opt_state::{pre}.{name}"
            if k not in blobs:
                raise KeyError(f"{path} holds no apply_if_finite state at {k}")
            old = getattr(adam, name)
            setattr(adam, name, torch.as_tensor(blobs[k], dtype=old.dtype, device=old.device))
    return meta
