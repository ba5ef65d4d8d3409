"""Location-sensitive attention (the JAX package's models/attention.py,
`LocationSensitiveAttention`), in the configuration this slice of the port
serves: attention_type "original", sigmoid or softmax norm, location
features on or off. Windowing, forward attention, the transition agent and
Graves attention come with the attention-variants slice and raise here."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import Conv1d, Dense

_LATER = "arrives with the attention-variants slice of the port (see ROADMAP.md)"


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
    """energies = v . tanh(W_q q + W_loc conv([att, cum]) + W_k m)."""

    def __init__(self, query_dim: int, embedding_dim: int, attention_dim: int,
                 location_attention: bool = True, n_filters: int = 32,
                 kernel_size: int = 31, norm: str = "sigmoid"):
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
        """One step. query [B, Q]; inputs [B, T, E]; processed_inputs
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


def init_attn(cfg, query_dim: int, embedding_dim: int) -> LocationSensitiveAttention:
    """Attention for a ModelConfig; variants this slice does not serve
    raise NotImplementedError instead of falling back."""
    if cfg.attention_type == "graves":
        raise NotImplementedError(f"Graves attention {_LATER}")
    if cfg.attention_type != "original":
        raise ValueError(f"unknown attention type {cfg.attention_type!r}")
    for flag in ("windowing", "use_forward_attn", "transition_agent",
                 "forward_attn_mask"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"attention option {flag} {_LATER}")
    return LocationSensitiveAttention(
        query_dim, embedding_dim, cfg.attention_dim, cfg.location_attn,
        cfg.attention_location_filters, cfg.attention_location_kernel_size,
        cfg.attention_norm)
