"""Fused Adam / AdamW as a ``torch.optim.Optimizer``.

Port of ``apex_tpu/optimizers/fused_adam.py`` (the knobs of ``:28-38``)
on the shared base :class:`~apex_tpu_torch.optimizers._fused.
FusedOptimizer` (fp32 math and state, a 1-based count, a schedule at
``count - 1``, the reference's two roundings, the correctly rounded
square root):

* ``adam_w_mode=True`` (default): decoupled weight decay —
  ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
  ``adam_w_mode=False``: L2 — ``g += wd * p`` before the moments.

The reference's ``layout`` knob (its chunked mega-buffer) is not an
argument: the port steps tensor by tensor.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from apex_tpu_torch.optimizers._fused import (
    LR, FusedOptimizer, apply_updates, fp32_copies, ieee_sqrt, one_minus_pow,
    schedule_value)


class FusedAdam(FusedOptimizer):
    """Adam / AdamW over the given tensors (``requires_grad`` leaves, e.g.
    :func:`apex_tpu_torch.models.gpt.param_leaves` of a params dict)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True):
        defaults = dict(lr=lr, betas=betas, eps=eps,
                        weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                        bias_correction=bias_correction)
        super().__init__(params, defaults)

    def _init_state(self, p, st) -> None:
        st["step"] = 0
        st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
        st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)

    def _update(self, group, params, g32, count, stats) -> None:
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        lr = schedule_value(group["lr"], count)
        p32 = fp32_copies(params)
        if not group["adam_w_mode"] and wd:
            g32 = torch._foreach_add(g32, torch._foreach_mul(p32, wd))
        # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(g32, 1.0 - b1))
        gg = torch._foreach_mul(g32, 1.0 - b2)
        torch._foreach_mul_(gg, g32)
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, gg)
        del g32, gg
        if group["bias_correction"]:
            m_hat = torch._foreach_div(ms, one_minus_pow(b1, count))
            den = torch._foreach_div(vs, one_minus_pow(b2, count))
        else:
            m_hat, den = ms, vs
        den = ieee_sqrt(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(m_hat, den)
        del m_hat, den
        if group["adam_w_mode"] and wd:
            torch._foreach_add_(upd, torch._foreach_mul(p32, wd))
        torch._foreach_mul_(upd, lr)
        # new_p32 = p32 - lr * update
        apply_updates(params, torch._foreach_sub(p32, upd), p32)
