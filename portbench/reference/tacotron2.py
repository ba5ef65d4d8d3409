"""Tacotron2 inference written out in plain torch, float32, from the
recipe's description (Shen et al. 2018 as the Mozilla TTS recipe builds
it): embedding -> 3 x (conv5, BatchNorm, ReLU) -> BiLSTM encoder; a
decoder of prenet (two ReLU layers with dropout 0.5 kept at inference),
attention LSTM, location-sensitive attention (sigmoid norm), decoder LSTM,
a projection to r frames and a stop token over [h2 | frames]; a 5-conv
postnet added to the frames.

`weight_spec` names every tensor and how the benchmark draws it; the names
are the ones both sides load. Nothing here reads the program under test.

The decode is checked teacher-forced: the reference runs its own
recurrence over the frames the program fed back (each step's input is the
program's last frame of the step before), and predicts each step's frames,
stop token and alignment; a served frame is judged by its distance from
that prediction. So the reference follows the program's path without
inheriting any of its state, and a run-away autoregression on either side
does not hide or fake a gap.

Prenet dropout at inference is a counter-based hash (a murmur3 finalizer
over the seed, the step, a salt and the element's index), the recipe's
deterministic serving mask: `dropout_keep` derives it again here.
"""

from __future__ import annotations

import math

import torch

from .precision import conv1d, linear, rounder

MASK32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
PRENET_SALTS = (11, 12)


def fmix32(x):
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    def mul(v, c):
        return ((v * (c & 0xFFFF)) + (((v * (c >> 16)) & 0xFFFF) << 16)) & MASK32
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_keep(seed: int, step: int, salt: int, rows, width: int, device):
    """Keep mask [len(rows), width] of the prenet's dropout at `step`: the
    element (row, col) of the batch draws u from its index row * width +
    col; u < 0.5 drops it."""
    key = int(fmix32(torch.tensor([(seed + step * GOLD) & MASK32]))[0])
    lin = (torch.as_tensor(rows, device=device)[:, None] * width
           + torch.arange(width, device=device)[None, :]).to(torch.int64)
    gold = ((lin * (GOLD & 0xFFFF)) + (((lin * (GOLD >> 16)) & 0xFFFF) << 16)) & MASK32
    x = fmix32(gold + key + salt * 7919)
    u = ((x & 0xFFFFFF).to(torch.float32) + 0.5) / 16777216.0
    return u >= 0.5


def weight_spec(m: dict, n_symbols: int, n_mels: int, r_init: int) -> list:
    """(name, shape, std, mean) of every tensor: xavier-normal weights at the
    layer's gain, LSTMs N(0, 1 / (3 H)) (the variance of U(+-1/sqrt(H))),
    embeddings N(0, 0.3), zero biases, BatchNorm at the identity with unit
    running variance, and the stop token's bias at -10 so that no row
    stops by chance under random weights and every row decodes all its
    steps."""
    E, H1, H2 = m["encoder_dim"], m["attention_rnn_dim"], m["decoder_rnn_dim"]
    P, A, F, K = m["prenet_dim"], m["attention_dim"], m["attention_location_filters"], \
        m["attention_location_kernel_size"]
    PD, OW = m["postnet_dim"], n_mels * r_init
    spec = []

    def dense(name, i, o, gain=1.0, bias=True):
        spec.append((name + ".weight", (o, i), gain * math.sqrt(2.0 / (i + o)), 0.0))
        if bias:
            spec.append((name + ".bias", (o,), 0.0, 0.0))

    def conv(name, i, o, k, gain, bias=True):
        spec.append((name + ".weight", (o, i, k), gain * math.sqrt(2.0 / (k * (i + o))), 0.0))
        if bias:
            spec.append((name + ".bias", (o,), 0.0, 0.0))

    def bn(name, d):
        spec.extend([(name + ".weight", (d,), 0.0, 1.0), (name + ".bias", (d,), 0.0, 0.0),
                     (name + ".running_mean", (d,), 0.0, 0.0),
                     (name + ".running_var", (d,), 0.0, 1.0)])

    relu, tanh = math.sqrt(2.0), 5.0 / 3.0
    spec.append(("embedding.weight", (n_symbols, m["embedding_dim"]), 0.3, 0.0))
    for i in range(3):
        conv(f"encoder.blocks.{i}.conv", E, E, 5, relu)
        bn(f"encoder.blocks.{i}.bn", E)
    s = 1.0 / math.sqrt(3.0 * (E // 2))
    for sfx in ("", "_reverse"):
        spec.extend([(f"encoder.lstm.weight_ih_l0{sfx}", (2 * E, E), s, 0.0),
                     (f"encoder.lstm.weight_hh_l0{sfx}", (2 * E, E // 2), s, 0.0),
                     (f"encoder.lstm.bias_ih_l0{sfx}", (2 * E,), 0.0, 0.0),
                     (f"encoder.lstm.bias_hh_l0{sfx}", (2 * E,), 0.0, 0.0)])
    dense("decoder.prenet.linears.0", n_mels, P)
    dense("decoder.prenet.linears.1", P, P)
    for name, i, h in (("attention_rnn", P + E, H1), ("decoder_rnn", H1 + E, H2)):
        s = 1.0 / math.sqrt(3.0 * h)
        spec.extend([(f"decoder.{name}.weight_ih", (4 * h, i), s, 0.0),
                     (f"decoder.{name}.weight_hh", (4 * h, h), s, 0.0),
                     (f"decoder.{name}.bias", (4 * h,), 0.0, 0.0)])
    dense("decoder.attention.query", H1, A, bias=False)
    dense("decoder.attention.inputs", E, A, bias=False)
    dense("decoder.attention.v", A, 1)
    conv("decoder.attention.loc_conv", 2, F, K, 1.0, bias=False)
    dense("decoder.attention.loc_dense", F, A, bias=False)
    dense("decoder.projection", H2 + E, OW)
    spec.append(("decoder.stopnet.weight", (1, H2 + OW), math.sqrt(2.0 / (H2 + OW + 1)), 0.0))
    spec.append(("decoder.stopnet.bias", (1,), 0.0, -10.0))
    dims = [n_mels] + [PD] * 4 + [n_mels]
    for i in range(5):
        conv(f"postnet.blocks.{i}.conv", dims[i], dims[i + 1], 5, tanh if i < 4 else 1.0)
        bn(f"postnet.blocks.{i}.bn", dims[i + 1])
    return spec


def _conv_bn(W, name, x, act, rnd, eps=1e-5):
    """[B, C, T] -> conv5 ("same", zeros) -> BatchNorm (running statistics)
    -> act."""
    w = W[name + ".conv.weight"]
    k = w.shape[-1]
    y = conv1d(x, w, W[name + ".conv.bias"], ((k - 1) // 2, k - 1 - (k - 1) // 2), rnd=rnd)
    g, b = W[name + ".bn.weight"], W[name + ".bn.bias"]
    mu, var = W[name + ".bn.running_mean"], W[name + ".bn.running_var"]
    y = (y - mu[:, None]) * torch.rsqrt(var[:, None] + eps) * g[:, None] + b[:, None]
    return act(y) if act else y


def _lstm_cell(x, h, c, w_ih, w_hh, b, rnd):
    i, f, g, o = (linear(x, w_ih, rnd=rnd) + linear(h, w_hh, rnd=rnd) + b).chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def encode(W, ids, lengths, mode: str = "f32"):
    """ids [B, T] (padded with id 0, as served), lengths [B] -> memory
    [B, T, E], zero past each row's length. The BiLSTM's backward direction
    starts at each row's last symbol."""
    rnd = rounder(mode)
    B, T = ids.shape
    x = W["embedding.weight"][ids].transpose(1, 2)
    for i in range(3):
        x = _conv_bn(W, f"encoder.blocks.{i}", x, torch.relu, rnd)
    valid = torch.arange(T, device=ids.device)[None, :] < lengths[:, None]
    x = x.transpose(1, 2) * valid[..., None]
    H = W["encoder.lstm.weight_hh_l0"].shape[1]
    out = torch.zeros(B, T, 2 * H, device=ids.device)
    for d, sfx in ((0, ""), (1, "_reverse")):
        w_ih, w_hh = W[f"encoder.lstm.weight_ih_l0{sfx}"], W[f"encoder.lstm.weight_hh_l0{sfx}"]
        b = W[f"encoder.lstm.bias_ih_l0{sfx}"] + W[f"encoder.lstm.bias_hh_l0{sfx}"]
        h = torch.zeros(B, H, device=ids.device)
        c = torch.zeros(B, H, device=ids.device)
        for s in range(T):
            # forward: position s; backward: position len - 1 - s of each row
            t = torch.full((B,), s, device=ids.device) if d == 0 else lengths - 1 - s
            live = t >= 0
            tc = t.clamp_min(0)
            xt = x[torch.arange(B, device=ids.device), tc]
            h2, c2 = _lstm_cell(xt, h, c, w_ih, w_hh, b, rnd)
            h = torch.where(live[:, None], h2, h)
            c = torch.where(live[:, None], c2, c)
            keep = live & (tc < lengths)
            out[torch.arange(B, device=ids.device)[keep], tc[keep], d * H:(d + 1) * H] = h[keep]
    return out


def decode_teacher_forced(W, memory, lengths, fed, rows, *, r: int, n_mels: int, seed: int,
                          thresh: float, prenet_dropout: bool = True, mode: str = "f32"):
    """memory [B, T, E] and lengths [B] (the reference's own encoding of the
    served ids), fed [B, S, n_mels]: the frame the program fed back into
    each step (its last frame of the step before; zeros into step 0),
    rows [B]: each row's index in the program's batch (its dropout mask's
    row). Returns the predicted frames [B, S, n_mels * r], stop logits
    [B, S], alignments [B, S, T] and each row's length in frames by the
    predicted stops: a step counts while the row was live at its start."""
    rnd = rounder(mode)
    dev = memory.device
    B, T, E = memory.shape
    S = fed.shape[1]
    pre = "decoder."
    H1 = W[pre + "attention_rnn.weight_hh"].shape[1]
    H2 = W[pre + "decoder_rnn.weight_hh"].shape[1]
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    keys = linear(memory, W[pre + "attention.inputs.weight"], rnd=rnd)
    loc_w = W[pre + "attention.loc_conv.weight"]
    K = loc_w.shape[-1]
    h1, c1 = torch.zeros(B, H1, device=dev), torch.zeros(B, H1, device=dev)
    h2, c2 = torch.zeros(B, H2, device=dev), torch.zeros(B, H2, device=dev)
    ctx = torch.zeros(B, E, device=dev)
    att, cum = torch.zeros(B, T, device=dev), torch.zeros(B, T, device=dev)
    frames = torch.empty(B, S, n_mels * r, device=dev)
    stops = torch.empty(B, S, device=dev)
    aligns = torch.empty(B, S, T, device=dev)
    for s in range(S):
        x = fed[:, s]
        for j, salt in enumerate(PRENET_SALTS):
            x = torch.relu(linear(x, W[pre + f"prenet.linears.{j}.weight"],
                                  W[pre + f"prenet.linears.{j}.bias"], rnd=rnd))
            if prenet_dropout:
                x = torch.where(dropout_keep(seed, s, salt, rows, x.shape[1], dev), 2.0 * x, 0.0)
        h1, c1 = _lstm_cell(torch.cat([x, ctx], 1), h1, c1, W[pre + "attention_rnn.weight_ih"],
                            W[pre + "attention_rnn.weight_hh"], W[pre + "attention_rnn.bias"], rnd)
        q = linear(h1, W[pre + "attention.query.weight"], rnd=rnd)
        loc = conv1d(torch.stack([att, cum], 1), loc_w, None, ((K - 1) // 2, K - 1 - (K - 1) // 2),
                     rnd=rnd)
        loc = linear(loc.transpose(1, 2), W[pre + "attention.loc_dense.weight"], rnd=rnd)
        e = linear(torch.tanh(q[:, None, :] + loc + keys), W[pre + "attention.v.weight"],
                   W[pre + "attention.v.bias"], rnd=rnd)[..., 0]
        sg = torch.where(mask, torch.sigmoid(e), 0.0)
        align = sg / sg.sum(-1, keepdim=True).clamp_min(1e-8)
        ctx = torch.einsum("bt,bte->be", rnd(align), rnd(memory))
        h2, c2 = _lstm_cell(torch.cat([h1, ctx], 1), h2, c2, W[pre + "decoder_rnn.weight_ih"],
                            W[pre + "decoder_rnn.weight_hh"], W[pre + "decoder_rnn.bias"], rnd)
        proj = linear(torch.cat([h2, ctx], 1), W[pre + "projection.weight"],
                      W[pre + "projection.bias"], rnd=rnd)
        stops[:, s] = linear(torch.cat([h2, proj], 1), W[pre + "stopnet.weight"],
                             W[pre + "stopnet.bias"], rnd=rnd)[:, 0]
        frames[:, s] = proj[:, :n_mels * r]
        aligns[:, s] = align
        att, cum = align, cum + align
    done = torch.cumsum((torch.sigmoid(stops) > thresh).int(), 1) > 0
    live_at_start = torch.cat([torch.ones_like(done[:, :1]), ~done[:, :-1]], 1)
    return frames, stops, aligns, live_at_start.sum(1) * r


def postnet(W, frames, mode: str = "f32"):
    """frames [B, T, n_mels] -> frames + postnet(frames)."""
    rnd = rounder(mode)
    x = frames.transpose(1, 2)
    for i in range(5):
        x = _conv_bn(W, f"postnet.blocks.{i}", x, torch.tanh if i < 4 else None, rnd)
    return frames + x.transpose(1, 2)
