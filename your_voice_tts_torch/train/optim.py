"""The optimizer stack of the JAX package's train/optim.py, written out with
optax's semantics:

    apply_if_finite(chain(clip_by_global_norm(grad_clip), scale_by_radam(),
                          add_decayed_weights(wd), scale_by_learning_rate(lr)))

with the Noam learning-rate schedule. torch.optim.RAdam is not that update:
it puts eps elsewhere and rectifies from another threshold, so the update
is spelled out here and held to optax in the tests.

- apply_if_finite: a step whose gradients hold a NaN or an inf changes
  nothing (no parameter, moment or count moves) unless it is the
  (max_consecutive_errors + 1)-th such step in a row;
- clip_by_global_norm: g * clip / ||g|| unless ||g|| < clip;
- scale_by_radam (b1 0.9, b2 0.999, eps 1e-8, threshold 5): bias-corrected
  moments; the rectified step r * m_hat / (sqrt(v_hat) + eps) once
  rho_t >= 5, else m_hat;
- add_decayed_weights: + wd * p;
- scale_by_learning_rate: * -lr(count), count = applied updates before this
  one.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def noam_schedule(lr: float, warmup_steps: int = 4000):
    """Noam LR: lr * warmup^0.5 * min(s * warmup^-1.5, s^-0.5), s = step + 1,
    in float32 as the JAX package computes it."""
    def schedule(step: int) -> float:
        s = F32(step) + F32(1.0)
        return float(F32(lr) * F32(warmup_steps ** 0.5)
                     * min(s * F32(warmup_steps ** -1.5), s ** F32(-0.5)))
    return schedule


class RAdamStack:
    """The update above over a fixed list of parameters, in place."""

    B1, B2, EPS, THRESHOLD = 0.9, 0.999, 1e-8, 5.0
    MAX_ERRORS = 10_000        # apply_if_finite's max_consecutive_errors

    def __init__(self, params, cfg):
        self.params = list(params)
        self.grad_clip, self.wd = cfg.grad_clip, cfg.wd
        self.lr_fn = (noam_schedule(cfg.lr, cfg.warmup_steps) if cfg.noam_schedule
                      else (lambda step: cfg.lr))
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0                 # applied updates
        self.notfinite_count = 0       # consecutive non-finite steps
        self.total_notfinite = 0

    @torch.no_grad()
    def step(self, grads) -> bool:
        """Apply one update from `grads` (one per parameter). Returns
        whether it was applied."""
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not finite:
            self.total_notfinite += 1
            if self.notfinite_count <= self.MAX_ERRORS:
                return False
        g = list(grads)
        if self.grad_clip and self.grad_clip > 0:
            norm = torch.sqrt(sum((x.float() ** 2).sum() for x in g))
            g = [torch.where(norm < self.grad_clip, x, x / norm * self.grad_clip) for x in g]
        # the step's scalars in float32, as optax computes them: rho_t in
        # float32 sits up to ~1% off its float64 value at small counts
        b1, b2 = self.B1, self.B2
        n = self.count + 1
        ro_inf = F32(2.0 / (1.0 - b2) - 1.0)
        b2t = F32(b2) ** F32(n)
        ro = ro_inf - F32(2 * n) * b2t / (F32(1.0) - b2t)
        rect = None
        if ro >= self.THRESHOLD:
            rect = float(np.sqrt((ro - F32(4.0)) * (ro - F32(2.0)) * ro_inf
                                 / ((ro_inf - F32(4.0)) * (ro_inf - F32(2.0)) * ro)))
        bc1 = float(F32(1.0) - F32(b1) ** F32(n))
        bc2 = float(F32(1.0) - b2t)
        lr = self.lr_fn(self.count)
        for p, x, m, v in zip(self.params, g, self.mu, self.nu):
            m.copy_((1 - b1) * x + b1 * m)
            v.copy_((1 - b2) * x ** 2 + b2 * v)
            m_hat = m / bc1
            u = m_hat
            if rect is not None:
                u = rect * m_hat / (torch.sqrt(v / bc2) + self.EPS)
            if self.wd and self.wd > 0:
                u = u + self.wd * p
            p.add_(u * -lr)
        self.count = n
        return True

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(torch.as_tensor(src))
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])


class ClipAdam:
    """optax's chain(clip_by_global_norm(clip), adam(lr, b1, b2, eps)) over
    a fixed list of parameters, in place: the gradients scaled by
    clip / ||g|| where their global norm reaches clip, then Adam's moments
    (mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, float32) and the
    update -lr * mu_hat / (sqrt(nu_hat) + eps) with the bias corrections
    in float32, as optax computes them. `mu`, `nu` and `count` are the
    chain's Adam state (its `[1][0]` in a JAX checkpoint). The GE2E
    trainer (b1 0.9, b2 0.999) and the vocoder trainers (WaveRNN's the
    same, the GAN sides' 0.5 / 0.9) take this one update.

    if_finite wraps it in optax's apply_if_finite(..., MAX_ERRORS), as the
    ParallelTTS trainer's optimizer: a step whose gradients hold a NaN or
    an inf leaves the parameters and the Adam state as they were (unless
    it is the (MAX_ERRORS + 1)-th such step in a row) and counts itself in
    `notfinite_count` (in a row) and `total_notfinite`; `last_finite` is
    whether the last step's gradients were finite. The check and the
    counters stay on the parameters' device, so a step reads nothing back
    to the host: `count` and the counters are then 0-d int32 tensors
    (`last_finite` bool), and the Adam state sits at `.inner_state[1][0]`
    in a JAX checkpoint (`jax_path`)."""

    MAX_ERRORS = 10_000        # apply_if_finite's max_consecutive_errors

    def __init__(self, params, lr: float, clip: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, if_finite: bool = False):
        self.params = list(params)
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.if_finite = if_finite
        self.jax_path = ".inner_state[1][0]" if if_finite else "[1][0]"
        self.count = 0
        if if_finite:
            dev = self.params[0].device
            zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
            self.count, self.notfinite_count, self.total_notfinite = zero(), zero(), zero()
            self.last_finite = torch.ones((), dtype=torch.bool, device=dev)

    def _clipped(self, grads) -> list:
        g = [x.float() for x in grads]
        norm = torch.sqrt(sum((x * x).sum() for x in g))
        return [torch.where(norm < self.clip, x, x / norm * self.clip) for x in g]

    @torch.no_grad()
    def step(self, grads) -> None:
        """One update from `grads`, one per parameter."""
        if self.if_finite:
            return self._step_if_finite(grads)
        g = self._clipped(grads)
        n = self.count + 1
        b1, b2 = self.b1, self.b2
        bc1 = float(F32(1.0) - F32(b1) ** F32(n))
        bc2 = float(F32(1.0) - F32(b2) ** F32(n))
        for p, x, m, v in zip(self.params, g, self.mu, self.nu):
            m.copy_((1 - b1) * x + b1 * m)
            v.copy_((1 - b2) * x * x + b2 * v)
            p.add_(-self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))
        self.count = n

    def _step_if_finite(self, grads) -> None:
        finite = torch.stack([torch.isfinite(x).all() for x in grads]).all()
        self.notfinite_count = torch.where(finite, 0, self.notfinite_count + 1).int()
        self.total_notfinite = self.total_notfinite + (~finite).int()
        self.last_finite = finite
        apply = finite | (self.notfinite_count > self.MAX_ERRORS)
        g = self._clipped(grads)
        b1, b2 = self.b1, self.b2
        n = (self.count + 1).float()
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=n.device)  # noqa: E731
        bc1, bc2 = 1.0 - f32(b1) ** n, 1.0 - f32(b2) ** n
        for p, x, m, v in zip(self.params, g, self.mu, self.nu):
            m_new = (1 - b1) * x + b1 * m
            v_new = (1 - b2) * x * x + b2 * v
            u = -self.lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps))
            m.copy_(torch.where(apply, m_new, m))
            v.copy_(torch.where(apply, v_new, v))
            p.add_(torch.where(apply, u, 0.0))
        self.count = self.count + apply.int()


def build_optimizer(params, cfg) -> RAdamStack:
    """The JAX package's `build_optimizer` chain over `params` for a
    TrainingConfig."""
    return RAdamStack(params, cfg)
