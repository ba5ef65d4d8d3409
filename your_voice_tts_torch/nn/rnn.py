"""Recurrent layers (the JAX package's nn/rnn.py).

`LSTMCell` keeps the reference's gate order (i, f, g, o) and ONE summed bias.
`GRUCell` is torch.nn.GRUCell, the reference's GRU, and `GRU` the same
cell scanned over a sequence; `gru_gates` is its update from the two
precomputed products.
`bilstm` runs the encoder's bidirectional LSTM over padded sequences: packing
the sequences makes the backward direction start at each row's own last
valid step, which is what the JAX package gets by right-aligning each row's
valid region before its reverse scan and rolling it back afterwards.
`bilstm_unpacked` is the same pass without packing, for a traced program:
packing moves the lengths to the host and gives batch sizes that depend on
the data. `run_rnn` calls an nn.LSTM or nn.GRU as its functional op, which
is what the module's forward runs, without the list of weights the module
rebuilds on each call (torch.export refuses tensor attributes assigned
while it traces).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class LSTMCell(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, x, state):
        h, c = state
        gates = x @ self.weight_ih.T + h @ self.weight_hh.T + self.bias
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


# The JAX package's GRUCell (gates r, z, n; separate input and hidden
# biases; n = tanh(W_in x + b_in + r * (W_hn h + b_hn))) is torch's own.
GRUCell = nn.GRUCell


class GRU(nn.GRU):
    """A one-layer, one-direction nn.GRU (cuDNN on the card) over a whole
    sequence: the JAX package's `gru` scan of a GRUCell, whose leaves wx,
    wh, bx, bh (`jax_layout`) are its ..._l0 weights and biases."""

    jax_layout = "gru"

    def forward(self, x, hx=None):
        return run_rnn(self, x, hx)


def run_rnn(mod, x, hx=None, reverse: bool | None = None):
    """`mod(x, hx)` for a batch-first nn.LSTM (projection included) or
    nn.GRU over [B, T, C]: the functional op over the module's registered
    parameters, as nn.RNNBase.forward calls it. reverse=False / True runs
    only the forward / backward direction of a bidirectional one-layer
    module, as a one-direction pass over x."""
    names = mod._flat_weights_names
    D = 2 if mod.bidirectional else 1
    if reverse is not None:
        names = [n for n in names if n.endswith("_reverse") == reverse]
        D = 1
    weights = [getattr(mod, n) for n in names]
    L, B = mod.num_layers * D, x.shape[0]
    args = (mod.bias, mod.num_layers, float(mod.dropout), mod.training, D == 2, True)
    if isinstance(mod, nn.LSTM):
        if hx is None:
            hx = (x.new_zeros(L, B, mod.proj_size or mod.hidden_size),
                  x.new_zeros(L, B, mod.hidden_size))
        out, h, c = torch.lstm(x, hx, weights, *args)
        return out, (h, c)
    if hx is None:
        hx = x.new_zeros(L, B, mod.hidden_size)
    return torch.gru(x, hx, weights, *args)


def gru_gates(gx, gh, h):
    """GRU update from the input part gx = W_i x + b_i and the hidden part
    gh = W_h h + b_h ([B, 3H] each, gates r, z, n)."""
    rx, zx, nx = gx.chunk(3, dim=-1)
    rh, zh, nh = gh.chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return (1.0 - z) * n + z * h


def bilstm(lstm: nn.LSTM, x, lengths):
    """Bidirectional batch-first `lstm` over [B, T, C] with valid `lengths`
    [B] -> [B, T, 2H], zero at padded positions."""
    packed = pack_padded_sequence(x, lengths.to("cpu", torch.int64),
                                  batch_first=True, enforce_sorted=False)
    out, _ = lstm(packed)
    out, _ = pad_packed_sequence(out, batch_first=True,
                                 total_length=x.shape[1])
    return out


def bilstm_unpacked(lstm: nn.LSTM, x, lengths):
    """`bilstm` without packing: the forward direction over the padded
    rows, the backward direction over each row reversed within its own
    length (one gather, undone by the same gather), padded positions
    zeroed. Nothing leaves the device."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    valid = t < lengths[:, None]
    rev = torch.where(valid, lengths[:, None] - 1 - t, t)[..., None]
    fwd = run_rnn(lstm, x, reverse=False)[0]
    bwd = run_rnn(lstm, x.gather(1, rev.expand_as(x)), reverse=True)[0]
    bwd = bwd.gather(1, rev.expand_as(bwd))
    return torch.cat([fwd, bwd], -1) * valid[..., None].to(x.dtype)
