"""The attention family (the JAX package's models/attention.py):
location-sensitive attention with sigmoid or softmax norm, location
features on or off, and its options (inference-time windowing, forward
attention with the transition agent and the forward mask), and Graves GMM
attention. Module and parameter names are the JAX package's (`query`,
`inputs`, `v`, `loc_conv`, `loc_dense`, `ta`, `l1`, `l2`), so that
train/checkpoint.params_from_jax maps them by its generic Dense rule.

The decode runs every variant on kernel 1 (ops/taco2_decode.py), which
reads the weights the modules hold; the step math lives there, in the
plain version. Training takes location-sensitive attention only:
windowing acts at inference only, and forward attention, the transition
agent and Graves train with a later slice of the port (train/trainer.py
refuses them)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import Conv1d, Dense

# the attention variants the decode serves beside plain location-sensitive
# attention, as the ModelConfig switches each flips
VARIANTS = {
    "windowing": dict(windowing=True),
    "forward": dict(use_forward_attn=True),                       # u = 0.5
    "forward_ta": dict(use_forward_attn=True, transition_agent=True),
    "forward_ta_mask": dict(use_forward_attn=True, transition_agent=True,
                            forward_attn_mask=True),
    "window_forward": dict(windowing=True, use_forward_attn=True),
    "softmax_window": dict(attention_norm="softmax", windowing=True),
    "graves": dict(attention_type="graves"),                      # K = attention_heads
}


def energies(query, processed_inputs, attention, attention_cum, q_w, conv_w,
             dense_w, v_w, v_b):
    """Raw energies [B, T] (the JAX package's `_energies`): query [B, Q];
    processed_inputs [B, T, A]; attention / attention_cum [B, T] f32;
    q_w [A, Q], conv_w [F, 2, K] or None (no location features),
    dense_w [A, F], v_w [1, A], v_b [1]. The alignment state is cast to the
    weights' dtype at the conv, as the reference does."""
    processed = (query @ q_w.T)[:, None, :]
    if conv_w is not None:
        total = conv_w.shape[2] - 1
        cat = torch.stack([attention, attention_cum], dim=1).to(conv_w.dtype)
        f = F.conv1d(F.pad(cat, (total // 2, total - total // 2)), conv_w)
        processed = processed + f.transpose(1, 2) @ dense_w.T
    return (torch.tanh(processed + processed_inputs) @ v_w.T + v_b)[..., 0]


class LocationSensitiveAttention(nn.Module):
    """energies = v . tanh(W_q q + W_loc conv([att, cum]) + W_k m), with the
    options of the JAX package's `LocationSensitiveAttention`: windowing
    (energies outside [centre - win_back, centre + win_front] of the last
    alignment's first maximum dropped, at inference only), forward
    attention (the alpha recursion from [1, 0, ...]), its transition agent
    (`ta`: a Dense over [context_prev | query] to 1) and its forward mask."""

    def __init__(self, query_dim: int, embedding_dim: int, attention_dim: int,
                 location_attention: bool = True, n_filters: int = 32,
                 kernel_size: int = 31, norm: str = "sigmoid", windowing: bool = False,
                 forward_attn: bool = False, trans_agent: bool = False,
                 forward_attn_mask: bool = False, win_back: int = 1, win_front: int = 3):
        super().__init__()
        if norm not in ("sigmoid", "softmax"):
            raise ValueError(f"unknown attention_norm {norm!r}")
        self.query = Dense(query_dim, attention_dim, bias=False)
        self.inputs = Dense(embedding_dim, attention_dim, bias=False)
        self.v = Dense(attention_dim, 1)
        self.location_attention = location_attention
        if location_attention:
            self.loc_conv = Conv1d(2, n_filters, kernel_size, use_bias=False)
            self.loc_dense = Dense(n_filters, attention_dim, bias=False)
        self.norm = norm
        self.windowing, self.win_back, self.win_front = windowing, win_back, win_front
        self.forward_attn = forward_attn
        self.trans_agent = trans_agent
        self.forward_attn_mask = forward_attn_mask
        if trans_agent:
            self.ta = Dense(embedding_dim + query_dim, 1)

    def preprocess_inputs(self, inputs):
        """W_k m, computed once per utterance outside the decode loop."""
        return self.inputs(inputs)

    def location_kernel(self):
        """The location conv folded with the location dense:
        u [2, K, A] with f[b, t, a] = sum_c sum_k u[c, k, a] x_c[b, t + k - pad]."""
        return torch.einsum("fck,af->cka", self.loc_conv.weight,
                            self.loc_dense.weight)

    def energy_weights(self):
        """(q_w, conv_w, dense_w, v_w, v_b) as `energies` takes them."""
        loc = self.location_attention
        return (self.query.weight, self.loc_conv.weight if loc else None,
                self.loc_dense.weight if loc else None, self.v.weight, self.v.bias)

    def forward(self, query, inputs, processed_inputs, attention, attention_cum,
                mask=None):
        """One step without the options (the teacher-forced route's
        attention). query [B, Q]; inputs [B, T, E]; processed_inputs
        [B, T, A]; attention / attention_cum [B, T]; mask [B, T] True where
        valid. Returns (context [B, E], alignment [B, T])."""
        e = energies(query, processed_inputs, attention, attention_cum,
                     *self.energy_weights())
        if mask is not None:
            e = e.masked_fill(~mask, float("-inf"))
        if self.norm == "softmax":
            align = torch.softmax(e, dim=-1)
        else:
            s = torch.sigmoid(e)
            align = s / s.sum(dim=-1, keepdim=True).clamp_min(1e-8)
        context = torch.einsum("bt,bte->be", align, inputs)
        return context, align


class GravesAttention(nn.Module):
    """Graves (2013) GMM attention (the JAX package's `GravesAttention`):
    (g, b, k) = l2(tanh(l1(query))) per component; weights softmax(g) +
    1e-5, widths softplus(b) + 1e-5, means mu [B, K] advanced by
    softplus(k) from 0; alignment sum_j g_j N(t; mu_j, sig_j), masked and
    normalised. It has no key projection and no location features."""

    norm = "sigmoid"    # what the decode is told; Graves has its own norm

    def __init__(self, query_dim: int, K: int = 4):
        super().__init__()
        self.K = K
        self.l1 = Dense(query_dim, query_dim)
        self.l2 = Dense(query_dim, 3 * K)

    @torch.no_grad()
    def init_bias(self) -> None:
        """The reference's bias init, which favours forward motion: the
        widths' (sig) biases 10.0, the steps' 0.5."""
        self.l2.bias[self.K:2 * self.K] = 10.0
        self.l2.bias[2 * self.K:] = 0.5

    def preprocess_inputs(self, inputs):
        return None


def init_attn(cfg, query_dim: int, embedding_dim: int):
    """Attention for a ModelConfig (the JAX package's `init_attn`); an
    unknown attention type raises ValueError."""
    if cfg.attention_type == "graves":
        return GravesAttention(query_dim, cfg.attention_heads)
    if cfg.attention_type != "original":
        raise ValueError(f"unknown attention type {cfg.attention_type!r}")
    return LocationSensitiveAttention(
        query_dim, embedding_dim, cfg.attention_dim, cfg.location_attn,
        cfg.attention_location_filters, cfg.attention_location_kernel_size,
        cfg.attention_norm, cfg.windowing, cfg.use_forward_attn, cfg.transition_agent,
        cfg.forward_attn_mask, cfg.win_back, cfg.win_front)
