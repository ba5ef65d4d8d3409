"""The attention family (the JAX package's models/attention.py):
location-sensitive attention with sigmoid or softmax norm, location
features on or off, and its options (inference-time windowing, forward
attention with the transition agent and the forward mask), and Graves GMM
attention. Module and parameter names are the JAX package's (`query`,
`inputs`, `v`, `loc_conv`, `loc_dense`, `ta`, `l1`, `l2`), so that
train/checkpoint.params_from_jax maps them by its generic Dense rule.

Tacotron2's decode runs every variant on kernel 1 (ops/taco2_decode.py),
which reads the weights the modules hold; the step math lives there, in
the plain version. Each module's `forward` is one step of the JAX
package's `__call__` over an `AttentionState`, windowing only with
inference=True: the route models/tacotron2.py `Decoder._scan` trains
forward attention, the transition agent and Graves through, under
autograd, and the route models/tacotron.py's step loop serves and trains
Tacotron(1) with Graves or the location options through (kernel 8 has
neither). Plain location-sensitive attention trains on the training
kernels instead (models/decoder_grad.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import Conv1d, Dense
from ..ops.taco2_decode import forward_plain, softplus, window_energies

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


class AttentionState(NamedTuple):
    """What a teacher-forced step carries to the next (the JAX package's
    `AttentionState`), float32 but for win_idx."""
    attention: torch.Tensor        # [B, T] the previous alignment
    attention_cum: torch.Tensor    # [B, T] the cumulative alignment (location features)
    alpha: torch.Tensor            # [B, T] forward attention's recursion state
    win_idx: torch.Tensor          # [B] int64 the window centre (windowing acts at inference)
    mu: torch.Tensor               # [B, K] Graves's means ([B, 1] unused otherwise)


def _state(B: int, T: int, K: int, device, alpha0: bool = False) -> AttentionState:
    z = torch.zeros(B, T, device=device)
    alpha = z.clone()
    if alpha0:
        alpha[:, 0] = 1.0
    return AttentionState(z, z, alpha, torch.zeros(B, dtype=torch.long, device=device),
                          torch.zeros(B, K, device=device))


def normalize(e, mask, norm: str):
    """Energies [B, T] -> alignment in float32 whatever their dtype (the
    JAX package's `_normalize`): pads (mask False) excluded, then softmax,
    or sigmoid over its sum."""
    e = e.float()
    if mask is not None:
        e = e.masked_fill(~mask, float("-inf"))
    if norm == "softmax":
        return torch.softmax(e, dim=-1)
    s = torch.sigmoid(e)
    return s / s.sum(dim=-1, keepdim=True).clamp_min(1e-8)


def _context(align, inputs):
    """sum_t align[b, t] inputs[b, t] in float32 (JAX promotes a bf16
    memory to the alignment's float32)."""
    return torch.einsum("bt,bte->be", align, inputs.to(align.dtype))


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

    def init_state(self, B: int, T: int, device) -> AttentionState:
        """Zeros, with forward attention's alpha at [1, 0, 0, ...]."""
        return _state(B, T, 1, device, alpha0=True)

    def forward(self, query, inputs, processed_inputs, state: AttentionState, mask=None,
                context_prev=None, inference: bool = False):
        """One step (the JAX package's `__call__`). query [B, Q] in the
        working dtype; inputs [B, T, E]; processed_inputs [B, T, A];
        mask [B, T] True where valid; context_prev [B, E], the previous
        step's context, which the transition agent reads. With windowing
        and inference=True the energies outside [win_idx - win_back,
        win_idx + win_front] are dropped (`window_energies`, the plain
        decodes' own); teacher forcing passes inference=False, as the
        reference does. The alignment is normalised in float32; forward
        attention then runs its recursion on it (the decode's
        `forward_plain`, with nothing rounded). Returns (new state, context
        [B, E] float32, alignment [B, T] float32)."""
        e = energies(query, processed_inputs, state.attention, state.attention_cum,
                     *self.energy_weights())
        if self.windowing and inference:
            c = state.win_idx[:, None]
            e = window_energies(e, c - self.win_back, c + self.win_front)
        align = normalize(e, mask, self.norm)
        if self.forward_attn:
            u = 0.5
            if self.trans_agent:
                u = torch.sigmoid(self.ta(torch.cat([context_prev, query], -1)))   # [B, 1]
            maskadd = torch.zeros_like(align) if mask is None else \
                torch.where(mask, 0.0, -1e9)
            align = forward_plain(align, state.alpha, u, maskadd, self.forward_attn_mask,
                                  lambda x: x)
        new_state = AttentionState(align, state.attention_cum + align,
                                   align if self.forward_attn else state.alpha,
                                   align.argmax(-1), state.mu)
        return new_state, _context(align, inputs), align


class GravesAttention(nn.Module):
    """Graves (2013) GMM attention (the JAX package's `GravesAttention`):
    (g, b, k) = l2(tanh(l1(query))) per component; weights softmax(g) +
    1e-5, widths softplus(b) + 1e-5, means mu [B, K] advanced by
    softplus(k) from 0; alignment sum_j g_j N(t; mu_j, sig_j), masked and
    normalised. It has no key projection and no location features."""

    norm = "sigmoid"    # what the decode is told; Graves has its own norm
    COEF = 0.3989422917366028   # 1 / sqrt(2 pi)

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

    def init_state(self, B: int, T: int, device) -> AttentionState:
        return _state(B, T, self.K, device)

    def forward(self, query, inputs, processed_inputs, state: AttentionState, mask=None,
                context_prev=None, inference: bool = False):
        """One step (the JAX package's `__call__`, the same at inference): the
        mixture from the means advanced by softplus(k), masked and
        normalised, over float32 positions. Arguments and returns as
        `LocationSensitiveAttention.forward`; processed_inputs,
        context_prev and inference are not read."""
        g, b, k = self.l2(torch.tanh(self.l1(query))).chunk(3, dim=-1)
        sig = softplus(b) + 1e-5
        mu = state.mu + softplus(k)
        g = torch.softmax(g, dim=-1) + 1e-5
        j = torch.arange(inputs.shape[1], device=query.device)
        phi = g[..., None] * torch.exp(-0.5 * ((mu[..., None] - j) / sig[..., None]) ** 2)
        align = self.COEF * phi.sum(1)
        if mask is not None:
            align = torch.where(mask, align, 0.0)
        align = align / align.sum(-1, keepdim=True).clamp_min(1e-8)
        new_state = AttentionState(align, state.attention_cum + align, state.alpha,
                                   state.win_idx, mu)
        return new_state, _context(align, inputs), align


def key_projection(linear, inputs):
    """W_k m for a decode at inference, one row at a time: every row's
    product has the same shape, whatever the batch, so that a row's keys do
    not depend on its batchmates (cuBLAS picks its kernel, and with it the
    order of a float32 product's sums, by the whole product's shape: one
    process's batch of 5 and a mesh's shards of 3 would give a row other
    bits). inputs [B, T, E] -> [B, T, A]."""
    return torch.cat([linear(inputs[i:i + 1]) for i in range(inputs.shape[0])])


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
