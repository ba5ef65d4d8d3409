"""Teacher-forced decoder core with a hand-written backward (the JAX
package's models/decoder_grad.py `make_scan_core`), as a
torch.autograd.Function.

Forward: the training kernel (ops/taco2_train.py `taco2_train_fwd`; its
plain version on the CPU) runs attention LSTM -> location-sensitive
attention -> context -> decoder LSTM over all steps and keeps its
residuals (pre-activation gates and cells of both LSTMs).

Backward, as the JAX package's kernel route does it:
- the reverse-time kernel (`taco2_train_bwd`) carries only activation-sized
  cotangents and emits the per-step gate, context, prenet and energy
  cotangents;
- the LSTM weight gradients are then whole-sequence products
  (dW_x = dG^T X, dW_h = dG^T H_prev, db = sum dG), each one matmul;
- the attention weight gradients (query, location conv and dense, v) and
  the cotangent of the processed inputs come from torch.autograd.grad over
  the port's own `energies`, with the steps folded into the batch in
  segments of 16.

The projection and stopnet do not feed the recurrence under teacher forcing;
the caller (models/tacotron2.py `Decoder.forward`) applies them outside.
"""

from __future__ import annotations

import torch

from ..ops.taco2_train import prepare_train_weights, taco2_train_bwd, taco2_train_fwd
from .attention import energies

F32 = torch.float32


def _shift(s):
    """stack[t] -> stack[t - 1] along time (axis 0), zeros at t = 0."""
    return torch.cat([torch.zeros_like(s[:1]), s[:-1]], 0)


def _mm(a, b, dtype):
    """a^T b over the flattened [T * B] axis with float32 accumulation,
    returned in `dtype`. On the card a bf16 product already accumulates in
    float32; on the CPU the operands are widened first."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    if a.is_cuda:
        return (a.T @ b).to(dtype)
    return (a.float().T @ b.float()).to(dtype)


def _attention_param_grads(q_t, att_prev, cum_prev, pinp, d_e, weights, seg: int = 16):
    """Gradients of the energies' weights and of the processed inputs from
    the raw energies' cotangent d_e [T, B, T_in] (zero at masked positions),
    by autograd over `energies` with `seg` steps folded into the batch."""
    Ts, B, H = q_t.shape
    T = att_prev.shape[-1]
    leaves = [None if w is None else w.detach().requires_grad_() for w in weights]
    pi = pinp.detach().requires_grad_()
    live = [x for x in leaves + [pi] if x is not None]
    acc = [torch.zeros(x.shape, dtype=F32, device=x.device) for x in live]
    with torch.enable_grad():
        for s0 in range(0, Ts, seg):
            S = min(seg, Ts - s0)
            pi_b = pi[None].expand(S, *pi.shape).reshape(S * B, T, -1)
            e = energies(q_t[s0:s0 + S].reshape(S * B, H),
                         pi_b, att_prev[s0:s0 + S].reshape(S * B, T),
                         cum_prev[s0:s0 + S].reshape(S * B, T), *leaves)
            grads = torch.autograd.grad(e.float(), live,
                                        d_e[s0:s0 + S].reshape(S * B, T).float())
            for a, g in zip(acc, grads):
                a += g.float()
    it = iter(acc)
    out = [None if w is None else next(it).to(w.dtype) for w in weights]
    return out, next(it).to(pinp.dtype)


class DecoderCore(torch.autograd.Function):
    """(prenet_t [T_r, B, P], enc [B, T_in, E], pinp [B, T_in, A], maskf
    [B, T_in], m_a [T_r, B, H1] or None, m_d [T_r, B, H2] or None, norm,
    then the weights: attention LSTM (weight_ih, weight_hh, bias), attention
    (query [A, H1], location conv [F, 2, K] or None, location dense [A, F]
    or None, v weight [1, A], v bias [1]), decoder LSTM (weight_ih,
    weight_hh, bias)) -> (dech_t [T_r, B, H2] post-dropout decoder hidden,
    ctx_t [T_r, B, E], align_t [T_r, B, T_in] float32). Every floating
    input is in the working dtype."""

    @staticmethod
    def forward(ctx, prenet_t, enc, pinp, maskf, m_a, m_d, norm, a_ih, a_hh, a_b, q_w,
                conv_w, dense_w, v_w, v_b, d_ih, d_hh, d_b):
        w = prepare_train_weights((a_ih, a_hh, a_b), q_w, conv_w, dense_w, v_w, v_b,
                                  (d_ih, d_hh, d_b))
        out = taco2_train_fwd(w, prenet_t, enc, pinp, maskf, m_a, m_d, norm=norm)
        ctx.w, ctx.norm = w, norm
        ctx.res = {k: out[k] for k in ("g_a", "g_d", "c_a", "c_d")}
        ctx.save_for_backward(prenet_t, enc, pinp, maskf, m_a, m_d, q_w, conv_w, dense_w,
                              v_w, v_b, a_ih, d_ih, out["ctx"], out["align"])
        return out["dech"], out["ctx"], out["align"]

    @staticmethod
    def backward(ctx, d_dech, d_ctx_out, d_align_out):
        (prenet_t, enc, pinp, maskf, m_a, m_d, q_w, conv_w, dense_w, v_w, v_b, a_ih, d_ih,
         ctx_t, align_t) = ctx.saved_tensors
        w, res = ctx.w, dict(ctx.res)
        dt = w["dtype"]
        H1, H2 = w["dims"]["H1"], w["dims"]["H2"]
        # elementwise recomputation, once, outside the reverse scan
        h_a_pre = (torch.sigmoid(res["g_a"][..., 3 * H1:].float())
                   * torch.tanh(res["c_a"].float())).to(dt)
        q_t = h_a_pre if m_a is None else (h_a_pre.float() * m_a.float()).to(dt)
        res["c_a_prev"], res["c_d_prev"] = _shift(res["c_a"]), _shift(res["c_d"])
        res["att_prev"] = _shift(align_t)
        res["cum_prev"] = _shift(torch.cumsum(align_t, 0))
        g = taco2_train_bwd(w, res, d_dech.to(dt), d_ctx_out.to(dt), d_align_out.float(),
                            enc, pinp, maskf, m_a, m_d, norm=ctx.norm)
        d_att_w, d_pinp = _attention_param_grads(
            q_t, res["att_prev"], res["cum_prev"], pinp, g["d_e"],
            (q_w, conv_w, dense_w, v_w, v_b))
        # LSTM weight gradients: one whole-sequence product each
        x_a = torch.cat([prenet_t.to(dt), _shift(ctx_t)], -1)
        x_d = torch.cat([q_t, ctx_t], -1)
        h_d = (torch.sigmoid(res["g_d"][..., 3 * H2:].float())
               * torch.tanh(res["c_d"].float())).to(dt)
        d_g_a, d_g_d = g["d_g_a"], g["d_g_d"]
        db = lambda d: d.reshape(-1, d.shape[-1]).float().sum(0).to(dt)  # noqa: E731
        d_enc = torch.einsum("tbi,tbe->bie", align_t, g["d_ctx"].float()).to(enc.dtype)
        return (g["d_prenet"].to(prenet_t.dtype), d_enc, d_pinp, None, None, None, None,
                _mm(d_g_a, x_a, a_ih.dtype), _mm(d_g_a, _shift(h_a_pre), a_ih.dtype),
                db(d_g_a), *d_att_w,
                _mm(d_g_d, x_d, d_ih.dtype), _mm(d_g_d, _shift(h_d), d_ih.dtype), db(d_g_d))


def dropout_masks(T: int, B: int, H1: int, H2: int, dtype, generator: torch.Generator,
                  device, rate: float = 0.1):
    """Per-step dropout multipliers [T, B, H1] and [T, B, H2] (1/keep where
    kept, else 0) for the attention and decoder LSTM outputs, drawn once
    per train step from `generator` (the JAX package's `_masks`)."""
    keep = 1.0 - rate

    def one(H):
        u = torch.rand(T, B, H, generator=generator, device=device)
        return torch.where(u < keep, 1.0 / keep, 0.0).to(dtype)

    return one(H1), one(H2)
