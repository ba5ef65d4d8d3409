"""Import upstream torch checkpoints into the JAX-layout parameter trees
the port's checkpoints hold (a copy of the JAX package's
utils/torch_import.py; numpy only, torch for `torch.load`).

The reference (prototypefund/your-voice-TTS, a mozilla/TTS fork) saves torch
pickles of ``{"model": state_dict, "r": int, "step": int, ...}``. The
converters fill a template of the model's JAX-layout numpy leaves (the
port's `train.checkpoint.params_to_jax`, nested with `nest`) from such a
state_dict, which `bin/import_checkpoint.py` then writes as the `.npz`
that every consumer loads.

Matching is pattern-tolerant: every target leaf carries a list of
candidate source-name regexes (fork renames like ``location_conv`` vs
``location_conv1d`` both match), and each conversion returns a report of
unmapped source keys and unfilled targets instead of failing silently.

Layout transforms:

- torch ``nn.Linear.weight`` is [out, in]  -> JAX layout [in, out]
- torch ``nn.Conv1d.weight`` is [out, in, k] -> [k, in, out]
- torch LSTM/LSTMCell ``weight_ih`` is [4H, in] -> wx [in, 4H]; the two
  torch biases sum into one ``b`` (same i, f, g, o gate order)
- BatchNorm weight/bias/running_mean/running_var -> scale/bias + state
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["convert_tacotron2_state_dict", "convert_speaker_encoder_state_dict",
           "convert_wavernn_state_dict", "convert_melgan_state_dict",
           "convert_pwgan_state_dict", "load_torch_state_dict", "strip_module_prefix",
           "nest"]


def strip_module_prefix(sd: dict) -> dict:
    """Drop the ``module.`` prefix torch DataParallel training leaves behind."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> tuple[dict, dict]:
    """torch.load a reference checkpoint -> (numpy state_dict, metadata).

    Accepts both a bare state_dict and the reference's
    ``{"model": state_dict, "r": ..., "step": ...}`` envelope."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob and hasattr(
            next(iter(blob["model"].values()), None), "numpy"):
        sd, meta = blob["model"], {k: v for k, v in blob.items() if k != "model"}
    else:
        sd, meta = blob, {}
    sd = strip_module_prefix(sd)
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in sd.items()
            if hasattr(v, "detach")}, meta


def nest(flat: dict) -> dict:
    """{keystr: array} (``['decoder']['prenet']['linears'][0]['w']``, as
    `train.checkpoint.params_to_jax` returns it) -> the nested dicts and
    lists the converters fill."""
    from ..train.checkpoint import _insert, parse_keypath

    tree: dict = {}
    for key, value in flat.items():
        _insert(tree, parse_keypath(key), value)
    return tree


def _t(a):
    return np.ascontiguousarray(np.asarray(a).T)


def _conv(a):   # torch [out, in, k] -> ours [k, in, out]
    return np.ascontiguousarray(np.transpose(np.asarray(a), (2, 1, 0)))


def _id(a):
    return np.asarray(a)


class _Matcher:
    """Pulls source tensors by candidate regex (first match wins), tracking
    which source keys were consumed."""

    def __init__(self, sd: dict):
        self.sd = dict(sd)
        self.used: set[str] = set()

    def pop(self, *patterns: str, required: bool = True):
        for pat in patterns:
            rx = re.compile(pat + r"$")
            for k in self.sd:
                if rx.search(k):
                    self.used.add(k)
                    return self.sd[k]
        if required:
            raise KeyError(f"no source key matches any of {patterns}")
        return None

    def unused(self) -> list[str]:
        return sorted(k for k in self.sd if k not in self.used
                      and "num_batches_tracked" not in k)


def _lstm_in(m: _Matcher, prefix: str, out_p: dict, suffix: str = ""):
    """Map a torch LSTM(Cell)'s 4 tensors onto our fused {wx, wh, b}."""
    wih = m.pop(rf"{prefix}\.weight_ih{suffix}")
    whh = m.pop(rf"{prefix}\.weight_hh{suffix}")
    bih = m.pop(rf"{prefix}\.bias_ih{suffix}", required=False)
    bhh = m.pop(rf"{prefix}\.bias_hh{suffix}", required=False)
    out_p["wx"] = _t(wih)
    out_p["wh"] = _t(whh)
    b = np.zeros(wih.shape[0], np.float32)
    if bih is not None:
        b = b + np.asarray(bih)
    if bhh is not None:
        b = b + np.asarray(bhh)
    out_p["b"] = b


def _convbn(m: _Matcher, prefix: str, blk_p: dict, blk_s: dict):
    """ConvBNBlock: conv + batchnorm params and running stats."""
    blk_p["conv"]["w"] = _conv(m.pop(
        rf"{prefix}\.(convolution1d|conv1d|conv)\.weight"))
    cb = m.pop(rf"{prefix}\.(convolution1d|conv1d|conv)\.bias", required=False)
    if cb is not None and "b" in blk_p["conv"]:
        blk_p["conv"]["b"] = _id(cb)
    blk_p["bn"]["scale"] = _id(m.pop(
        rf"{prefix}\.(batch_normalization|bn|batch_norm)\.weight"))
    blk_p["bn"]["bias"] = _id(m.pop(
        rf"{prefix}\.(batch_normalization|bn|batch_norm)\.bias"))
    blk_s["bn"]["mean"] = _id(m.pop(
        rf"{prefix}\.(batch_normalization|bn|batch_norm)\.running_mean"))
    blk_s["bn"]["var"] = _id(m.pop(
        rf"{prefix}\.(batch_normalization|bn|batch_norm)\.running_var"))


def _linear(m: _Matcher, prefix: str, out_p: dict, bias: bool = True):
    """Reference Linear wrapper (``X.linear_layer.weight``) or bare Linear."""
    out_p["w"] = _t(m.pop(rf"{prefix}\.linear_layer\.weight",
                          rf"{prefix}\.weight"))
    if bias:
        b = m.pop(rf"{prefix}\.linear_layer\.bias", rf"{prefix}\.bias",
                  required=False)
        if b is not None:
            out_p["b"] = _id(b)


def _gru_in(m: _Matcher, prefix: str, out_p: dict, suffix: str = ""):
    """torch GRU -> our GRUCell: biases stay separate (the n-gate applies
    bias_hh inside the reset product — nn/rnn.py parity)."""
    out_p["wx"] = _t(m.pop(rf"{prefix}\.weight_ih{suffix}"))
    out_p["wh"] = _t(m.pop(rf"{prefix}\.weight_hh{suffix}"))
    out_p["bx"] = _id(m.pop(rf"{prefix}\.bias_ih{suffix}"))
    out_p["bh"] = _id(m.pop(rf"{prefix}\.bias_hh{suffix}"))


def _fold_conv_bn_into(m: _Matcher, conv_w, bn_prefix: str, target: dict,
                       eps: float = 1e-5):
    """conv(bias=False) + eval-mode BatchNorm -> conv(scale-folded) + bias.

    conv_w is the torch [out, in, k] weight; target gains w [k, in, out]
    and b [out]. Exact at inference (BN is affine on running stats)."""
    g = np.asarray(m.pop(rf"{bn_prefix}\.weight"))
    b = np.asarray(m.pop(rf"{bn_prefix}\.bias"))
    mu = np.asarray(m.pop(rf"{bn_prefix}\.running_mean"))
    var = np.asarray(m.pop(rf"{bn_prefix}\.running_var"))
    k = g / np.sqrt(var + eps)
    target["w"] = _conv(np.asarray(conv_w) * k[:, None, None])
    target["b"] = (b - mu * k).astype(np.float32)


def _wn_fold(v, g):
    """torch weight_norm (dim=0): w = g * v / ||v|| with the norm over all
    non-leading dims per leading slice."""
    v = np.asarray(v, np.float64)
    g = np.asarray(g, np.float64)
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return (v * (g / norm)).astype(np.float32)


def convert_melgan_state_dict(sd: dict, params: dict) -> tuple[dict, dict]:
    """Fill a MelganGenerator param pytree (vocoder/models/melgan.py) from
    the reference generator's state_dict.

    The reference builds one nn.Sequential ``layers`` (pad, conv_in, then per
    upsample factor: LeakyReLU + weight-normed ConvTranspose + ResidualStack,
    then LeakyReLU + pad + conv_out + tanh). Indices are discovered from the
    keys, not hard-coded: top-level weight-normed convs sort into conv_in /
    per-factor transposed convs / conv_out; ResidualStack children live under
    ``layers.{n}.blocks.{i}.{2,4}`` + ``layers.{n}.shortcuts.{i}``. Every
    weight_norm (g, v) pair folds into a plain weight (inference exact)."""
    import copy

    p = copy.deepcopy(params)
    m = _Matcher(sd)

    def pop_wn(prefix):
        v = m.pop(rf"{prefix}\.weight_v")
        g = m.pop(rf"{prefix}\.weight_g")
        b = m.pop(rf"{prefix}\.bias", required=False)
        return _wn_fold(v, g), b

    top = sorted(int(re.fullmatch(r"layers\.(\d+)\.weight_v", k).group(1))
                 for k in m.sd if re.fullmatch(r"layers\.(\d+)\.weight_v", k))
    stacks = sorted({int(k.split(".")[1]) for k in m.sd
                     if re.match(r"layers\.\d+\.blocks\.", k)})
    assert len(top) == 2 + len(p["ups"]), (top, len(p["ups"]))
    assert len(stacks) == len(p["ups"]), (stacks, len(p["ups"]))

    w, b = pop_wn(rf"layers\.{top[0]}")
    p["conv_in"]["w"] = _conv(w)
    p["conv_in"]["b"] = _id(b)
    for j, upd in enumerate(p["ups"]):
        w, b = pop_wn(rf"layers\.{top[1 + j]}")       # torch [in, out, k]
        upd["up"]["w"] = np.ascontiguousarray(
            np.transpose(w[:, :, ::-1], (2, 0, 1)))   # flip k -> [k, in, out]
        upd["up"]["b"] = _id(b)
        for i, blk in enumerate(upd["res"]["blocks"]):
            w1, b1 = pop_wn(rf"layers\.{stacks[j]}\.blocks\.{i}\.2")
            w2, b2 = pop_wn(rf"layers\.{stacks[j]}\.blocks\.{i}\.4")
            ws, bs = pop_wn(rf"layers\.{stacks[j]}\.shortcuts\.{i}")
            blk["c1"]["w"], blk["c1"]["b"] = _conv(w1), _id(b1)
            blk["c2"]["w"], blk["c2"]["b"] = _conv(w2), _id(b2)
            blk["sc"]["w"], blk["sc"]["b"] = _conv(ws), _id(bs)
    w, b = pop_wn(rf"layers\.{top[-1]}")
    p["conv_out"]["w"] = _conv(w)
    p["conv_out"]["b"] = _id(b)

    report = {"mapped": len(m.used), "unused_source_keys": m.unused(),
              "shape_mismatches": []}
    return p, report


def convert_pwgan_state_dict(sd: dict, params: dict) -> tuple[dict, dict]:
    """Fill a ParallelWaveganGenerator param pytree (vocoder/models/pwgan.py)
    from the reference generator's state_dict (kan-bayashi layout the
    reference vendors: ``first_conv``, ``conv_layers.{i}.{conv, conv1x1_aux,
    conv1x1_out, conv1x1_skip}``, ``last_conv_layers.{1,3}``,
    ``upsample_net.conv_in`` + ``upsample_net.upsample.up_layers``).

    Every conv may be weight-normed (the reference applies WN to all Conv1d/
    Conv2d) — (g, v) pairs fold to plain weights. The reference's per-factor
    upsample Conv2d (1 channel, kernel (1, 2f+1)) becomes a diagonal channel
    map of our dense [k, M, M] Conv1d, exactly like the WaveRNN smoothing
    convs; its aux ``conv_in`` context conv maps onto ``aux_conv`` (build
    the model with the matching ``aux_context_window``)."""
    import copy

    p = copy.deepcopy(params)
    m = _Matcher(sd)

    def pop_conv(prefix, bias=True):
        v = m.pop(rf"{prefix}\.weight_v", required=False)
        if v is not None:
            w = _wn_fold(v, m.pop(rf"{prefix}\.weight_g"))
        else:
            w = np.asarray(m.pop(rf"{prefix}\.weight"))
        b = m.pop(rf"{prefix}\.bias", required=False) if bias else None
        return w, b

    w, b = pop_conv(r"first_conv")
    p["conv_in"]["w"], p["conv_in"]["b"] = _conv(w), _id(b)
    for i, blk in enumerate(p["blocks"]):
        w, b = pop_conv(rf"conv_layers\.{i}\.conv")
        blk["conv"]["w"], blk["conv"]["b"] = _conv(w), _id(b)
        w, _ = pop_conv(rf"conv_layers\.{i}\.conv1x1_aux", bias=False)
        blk["cond"]["w"] = _conv(w)
        w, b = pop_conv(rf"conv_layers\.{i}\.conv1x1_out")
        blk["res"]["w"], blk["res"]["b"] = _conv(w), _id(b)
        w, b = pop_conv(rf"conv_layers\.{i}\.conv1x1_skip")
        blk["skip"]["w"], blk["skip"]["b"] = _conv(w), _id(b)
    w, b = pop_conv(r"last_conv_layers\.1")
    p["out1"]["w"], p["out1"]["b"] = _conv(w), _id(b)
    w, b = pop_conv(r"last_conv_layers\.3")
    p["out2"]["w"], p["out2"]["b"] = _conv(w), _id(b)

    aux_fold = None  # k=1 conv_in folded into the first upsample conv below
    if any("upsample_net.conv_in" in k for k in m.sd):
        w, _ = pop_conv(r"upsample_net\.conv_in", bias=False)
        if "aux_conv" in p:
            p["aux_conv"]["w"] = _conv(w)
        elif np.shape(w)[-1] == 1:
            # aux_context_window=0: a dense 1x1 channel map commutes with
            # nearest-neighbor stretch, so it composes exactly into the
            # first upsample conv (done after that conv is filled)
            aux_fold = np.asarray(w)[:, :, 0]  # [out, in]
        else:
            raise ValueError(
                "the source checkpoint has a trained aux context conv "
                f"(upsample_net.conv_in, kernel {np.shape(w)[-1]}) but the "
                "target model was built with aux_context_window=0 — set "
                f"pwgan.aux_context_window={(np.shape(w)[-1] - 1) // 2} in "
                "the vocoder config; importing without it would silently "
                "drop the mel-conditioning context and produce wrong audio")

    conv_keys = sorted(
        (k for k in m.sd if re.fullmatch(
            r"upsample_net\.(upsample\.)?up_layers\.\d+\.(weight|weight_v)", k)),
        key=lambda k: int(k.split(".")[-2]))
    assert len(conv_keys) == len(p["up"]), (conv_keys, len(p["up"]))
    for key, upd in zip(conv_keys, p["up"]):
        if key.endswith("weight_v"):
            w2d = _wn_fold(m.pop(re.escape(key)),
                           m.pop(re.escape(key[:-1] + "g")))
        else:
            w2d = np.asarray(m.pop(re.escape(key)))
        assert w2d.shape[:3] == (1, 1, 1), (
            f"freq-axis kernel > 1 unsupported: {key} {w2d.shape}")
        K = w2d.shape[-1]
        M = np.shape(upd["w"])[1]
        eye = np.eye(M, dtype=np.float32)
        upd["w"] = (w2d.reshape(K, 1, 1) * eye[None]).astype(np.float32)
    if aux_fold is not None:
        p["up"][0]["w"] = np.einsum(
            "ji,kjo->kio", aux_fold, p["up"][0]["w"]).astype(np.float32)

    report = {"mapped": len(m.used), "unused_source_keys": m.unused(),
              "shape_mismatches": []}
    return p, report


def convert_wavernn_state_dict(sd: dict, params: dict) -> tuple[dict, dict]:
    """Fill a WaveRNN param pytree (vocoder/models/wavernn.py) from the
    reference torch WaveRNN's state_dict.

    The reference MelResNet runs conv(bias=False)+BatchNorm at conv_in and
    inside each ResBlock; this framework is BN-free there, so each BN's
    eval-mode affine folds into the conv scale + bias (exact at inference).
    The reference's 2D smoothing convs (1-channel, kernel (1, 2f+1)) become
    diagonal channel maps of our dense [k, M, M] smoothing convs."""
    import copy

    p = copy.deepcopy(params)
    m = _Matcher(sd)

    R = p["upsample"]["resnet"]
    _fold_conv_bn_into(m, m.pop(r"upsample\.resnet\.conv_in\.weight"),
                       r"upsample\.resnet\.batch_norm", R["conv_in"])
    for i, blk in enumerate(R["blocks"]):
        _fold_conv_bn_into(
            m, m.pop(rf"upsample\.resnet\.layers\.{i}\.conv1\.weight"),
            rf"upsample\.resnet\.layers\.{i}\.batch_norm1", blk["c1"])
        _fold_conv_bn_into(
            m, m.pop(rf"upsample\.resnet\.layers\.{i}\.conv2\.weight"),
            rf"upsample\.resnet\.layers\.{i}\.batch_norm2", blk["c2"])
    R["out"]["w"] = _conv(m.pop(r"upsample\.resnet\.conv_out\.weight"))
    R["out"]["b"] = _id(m.pop(r"upsample\.resnet\.conv_out\.bias"))

    # up_layers alternates Stretch2d (no params) and Conv2d [1, 1, 1, K];
    # collect the conv weights in index order -> diagonal [K, M, M]
    conv_keys = sorted((k for k in m.sd
                        if re.fullmatch(r"upsample\.up_layers\.\d+\.weight", k)),
                       key=lambda k: int(k.split(".")[2]))
    assert len(conv_keys) == len(p["upsample"]["smooth"]), (
        conv_keys, len(p["upsample"]["smooth"]))
    for key, sm in zip(conv_keys, p["upsample"]["smooth"]):
        m.used.add(key)
        w2d = np.asarray(m.sd[key])              # [1, 1, 1, K]
        K = w2d.shape[-1]
        M = np.shape(sm["w"])[1]
        eye = np.eye(M, dtype=np.float32)
        sm["w"] = (w2d.reshape(K, 1, 1) * eye[None]).astype(np.float32)

    _linear(m, r"I", p["I"])
    _gru_in(m, r"rnn1", p["rnn1"], suffix="_l0")
    _gru_in(m, r"rnn2", p["rnn2"], suffix="_l0")
    _linear(m, r"fc1", p["fc1"])
    _linear(m, r"fc2", p["fc2"])
    _linear(m, r"fc3", p["fc3"])

    report = {"mapped": len(m.used), "unused_source_keys": m.unused(),
              "shape_mismatches": []}
    return p, report


def convert_speaker_encoder_state_dict(sd: dict, params: dict) -> tuple[dict, dict]:
    """Fill a SpeakerEncoder param pytree (speaker_encoder/model.py, built
    with ``recur_on_proj=False`` — the reference recurrence) from the
    reference GE2E encoder's state_dict (``layers.{i}.lstm.weight_ih_l0`` +
    ``layers.{i}.linear.weight``)."""
    import copy

    p = copy.deepcopy(params)
    m = _Matcher(sd)
    for i, layer in enumerate(p["layers"]):
        _lstm_in(m, rf"layers\.{i}\.lstm", layer, suffix="_l0")
        layer["proj"] = _t(m.pop(rf"layers\.{i}\.linear\.weight",
                                 rf"layers\.{i}\.linear\.linear_layer\.weight"))
    report = {"mapped": len(m.used), "unused_source_keys": m.unused(),
              "shape_mismatches": []}
    return p, report


def _convert_gst(m: _Matcher, gp: dict, gs: dict) -> None:
    """Reference gst_layer (layers/gst_layers.py): ReferenceEncoder Conv2d +
    BN stack + GRU summary, StyleTokenLayer tokens + W_query/W_key/W_value.
    The reference has NO output projection (its GST embedding width must
    equal the encoder width), so our out_proj becomes identity — exact when
    gst_embedding_dim == encoder width, which the reference requires anyway.
    Its reference-encoder GRU width is gst_embedding_dim // 2 (= our fixed
    128 at the default 256); other dims surface as shape mismatches."""
    for i, conv in enumerate(gp["ref"]["convs"]):
        w = np.asarray(m.pop(rf"gst(_layer)?\.encoder\.convs\.{i}\.weight"))
        conv["w"] = np.ascontiguousarray(
            np.transpose(w, (2, 3, 1, 0)))  # [out,in,kh,kw] -> [kh,kw,in,out]
        b = m.pop(rf"gst(_layer)?\.encoder\.convs\.{i}\.bias", required=False)
        conv["b"] = (_id(b) if b is not None
                     else np.zeros((w.shape[0],), np.float32))
        conv["bn"]["scale"] = _id(
            m.pop(rf"gst(_layer)?\.encoder\.bns\.{i}\.weight"))
        conv["bn"]["bias"] = _id(
            m.pop(rf"gst(_layer)?\.encoder\.bns\.{i}\.bias"))
        gs["ref"]["convs"][i]["mean"] = _id(
            m.pop(rf"gst(_layer)?\.encoder\.bns\.{i}\.running_mean"))
        gs["ref"]["convs"][i]["var"] = _id(
            m.pop(rf"gst(_layer)?\.encoder\.bns\.{i}\.running_var"))
    # GRU input features: the reference flattens the conv stack [C, F]
    # channel-major, ours [F, C] frequency-major — permute weight_ih rows
    # (identity when the frequency axis has collapsed to F == 1)
    wx = np.asarray(m.pop(r"gst(_layer)?\.encoder\.recurrence\.weight_ih_l0"))
    C = gp["ref"]["convs"][-1]["w"].shape[-1]
    F = wx.shape[1] // C
    perm = np.arange(C * F).reshape(C, F).T.reshape(-1)
    gp["ref"]["gru"]["wx"] = _t(wx)[perm]
    gp["ref"]["gru"]["wh"] = _t(
        m.pop(r"gst(_layer)?\.encoder\.recurrence\.weight_hh_l0"))
    gp["ref"]["gru"]["bx"] = _id(
        m.pop(r"gst(_layer)?\.encoder\.recurrence\.bias_ih_l0"))
    gp["ref"]["gru"]["bh"] = _id(
        m.pop(r"gst(_layer)?\.encoder\.recurrence\.bias_hh_l0"))
    gp["style"]["tokens"] = _id(
        m.pop(r"gst(_layer)?\.style_token_layer\.style_tokens"))
    gp["style"]["q"]["w"] = _t(m.pop(
        r"gst(_layer)?\.style_token_layer\.attention\.W_query\.weight"))
    gp["style"]["k"]["w"] = _t(m.pop(
        r"gst(_layer)?\.style_token_layer\.attention\.W_key\.weight"))
    gp["style"]["v"]["w"] = _t(m.pop(
        r"gst(_layer)?\.style_token_layer\.attention\.W_value\.weight"))
    E = np.shape(gp["proj"]["w"])
    if E[0] == E[1]:
        gp["proj"]["w"] = np.eye(E[0], dtype=np.float32)
        if "b" in gp["proj"]:
            gp["proj"]["b"] = np.zeros((E[1],), np.float32)
    # else: the model was built with gst_embedding_dim != encoder width — a
    # configuration the reference cannot express (it sums the style into the
    # encoder outputs directly); the projection keeps its init values and
    # needs fine-tuning


def convert_tacotron2_state_dict(sd: dict, variables: dict) -> tuple[dict, dict]:
    """Fill a fresh Tacotron2 ``variables`` pytree (from ``model.init``) with
    the reference state_dict's weights.

    Returns (variables, report) where report = {"mapped": n,
    "unused_source_keys": [...], "note": ...}. Unfilled optional branches
    (GST, speaker embedding) stay at their init values when the source model
    doesn't have them."""
    import copy

    v = copy.deepcopy(variables)
    p, s = v["params"], v["state"]
    m = _Matcher(sd)

    p["embedding"]["table"] = _id(m.pop(r"embedding\.weight"))

    # --- encoder: 3 ConvBN blocks + BiLSTM ------------------------------
    for i, blk in enumerate(p["encoder"]["blocks"]):
        _convbn(m, rf"encoder\.convolutions\.{i}", blk,
                s["encoder"]["blocks"][i])
    _lstm_in(m, r"encoder\.lstm", p["encoder"]["lstm_fwd"], suffix="_l0")
    _lstm_in(m, r"encoder\.lstm", p["encoder"]["lstm_bwd"],
             suffix="_l0_reverse")

    # --- decoder ---------------------------------------------------------
    d = p["decoder"]
    for i, lin in enumerate(d["prenet"]["linears"]):
        _linear(m, rf"decoder\.prenet\.linear_layers\.{i}", lin)
    if "bns" in d["prenet"]:
        for i, bn in enumerate(d["prenet"]["bns"]):
            bn["scale"] = _id(m.pop(
                rf"decoder\.prenet\.linear_layers\.{i}\.(batch_normalization|bn)\.weight"))
            bn["bias"] = _id(m.pop(
                rf"decoder\.prenet\.linear_layers\.{i}\.(batch_normalization|bn)\.bias"))
            s["decoder"]["prenet"]["bns"][i]["mean"] = _id(m.pop(
                rf"decoder\.prenet\.linear_layers\.{i}\.(batch_normalization|bn)\.running_mean"))
            s["decoder"]["prenet"]["bns"][i]["var"] = _id(m.pop(
                rf"decoder\.prenet\.linear_layers\.{i}\.(batch_normalization|bn)\.running_var"))
    _lstm_in(m, r"decoder\.attention_rnn", d["attention_rnn"])
    a = d["attention"]
    if "query" in a:  # location-sensitive family
        _linear(m, r"decoder\.attention(_layer)?\.query_layer", a["query"],
                bias=False)
        _linear(m, r"decoder\.attention(_layer)?\.inputs_layer", a["inputs"],
                bias=False)
        _linear(m, r"decoder\.attention(_layer)?\.v", a["v"])
        if "loc_conv" in a:
            a["loc_conv"]["w"] = _conv(m.pop(
                r"decoder\.attention(_layer)?\.location_layer"
                r"\.(location_conv1d|location_conv)\.weight"))
            _linear(m, r"decoder\.attention(_layer)?\.location_layer"
                       r"\.location_dense", a["loc_dense"], bias=False)
        if "ta" in a:
            _linear(m, r"decoder\.attention(_layer)?\.ta", a["ta"])
    else:  # Graves GMM attention: N_a = Sequential(linear, tanh, linear)
        _linear(m, r"decoder\.attention(_layer)?\.N_a\.0", a["l1"])
        _linear(m, r"decoder\.attention(_layer)?\.N_a\.2", a["l2"])
    _lstm_in(m, r"decoder\.decoder_rnn", d["decoder_rnn"])
    _linear(m, r"decoder\.linear_projection", d["projection"])
    # stopnet = Sequential(Dropout, Linear) in the reference -> index 1
    _linear(m, r"decoder\.stopnet\.1", d["stopnet"])

    # --- postnet: 5 ConvBN blocks ---------------------------------------
    for i, blk in enumerate(p["postnet"]["blocks"]):
        _convbn(m, rf"postnet\.convolutions\.{i}", blk,
                s["postnet"]["blocks"][i])

    # --- optional conditioning branches ----------------------------------
    if "speaker_embedding" in p:
        se = m.pop(r"speaker_embedding\.weight", required=False)
        if se is not None:
            p["speaker_embedding"]["table"] = _id(se)
    if "gst" in p and any(k.startswith(("gst", "gst_layer"))
                          for k in m.sd):
        _convert_gst(m, p["gst"], s["gst"])

    # shape validation: any converted leaf whose shape disagrees with the
    # model's template (e.g. a fork with a different symbol set) reverts to
    # its init value and is reported, never silently mis-loaded
    mismatches: list[str] = []

    def _check(tmpl, filled, path):
        if isinstance(tmpl, dict):
            for k in tmpl:
                _check(tmpl[k], filled[k], f"{path}/{k}")
        elif isinstance(tmpl, (list, tuple)):
            for i, t in enumerate(tmpl):
                _check(t, filled[i], f"{path}/{i}")
        else:
            if tuple(np.shape(filled)) != tuple(np.shape(tmpl)):
                mismatches.append(
                    f"{path}: got {tuple(np.shape(filled))}, "
                    f"expected {tuple(np.shape(tmpl))}")

    def _revert(tmpl, filled, path):
        if isinstance(tmpl, dict):
            for k in tmpl:
                r = _revert(tmpl[k], filled[k], f"{path}/{k}")
                if r is not None:
                    filled[k] = r
        elif isinstance(tmpl, (list, tuple)):
            for i, t in enumerate(tmpl):
                r = _revert(t, filled[i], f"{path}/{i}")
                if r is not None:
                    filled[i] = r
        else:
            if tuple(np.shape(filled)) != tuple(np.shape(tmpl)):
                return np.asarray(tmpl)
        return None

    for name in ("params", "state"):
        _check(variables[name], v[name], name)
        _revert(variables[name], v[name], name)

    report = {
        "mapped": len(m.used),
        "unused_source_keys": m.unused(),
        "shape_mismatches": mismatches,
        "note": ("source keys reconstructed from upstream mozilla/TTS "
                 "naming; unused keys listed above were NOT transferred"),
    }
    return v, report
