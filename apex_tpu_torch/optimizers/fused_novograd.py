"""Fused NovoGrad as a ``torch.optim.Optimizer``.

Port of ``apex_tpu/optimizers/fused_novograd.py:35-107`` (per-tensor
layout) on the shared base. The second moment is a per-tensor scalar, and
it is the gradient's NORM, not its square (``state[p]["exp_avg_sq"]``, a
0-dim fp32 tensor):

* ``v = b2 * v + (1 - b2) * ||g||``; on the first step ``v = ||g||``
  unless ``init_zero``;
* ``norm_type`` 2 is the L2 norm, 0 the largest absolute value; any other
  value raises ``ValueError``;
* with ``bias_correction``, ``denom = v / sqrt(1 - b2^t) + eps`` and the
  first moment is divided by ``1 - b1^t``; without, ``denom = v + eps``;
* ``reg_inside_moment`` (moment mode 0): ``m = b1 * m + beta3 * (g /
  denom + wd * p)``, update ``m / (1 - b1^t)``; otherwise (mode 1):
  ``m = b1 * m + beta3 * g``, update ``(m / (1 - b1^t)) / denom + wd * p``
  — ``beta3 = 1 - b1`` with ``grad_averaging``, else 1.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from apex_tpu_torch.optimizers._fused import (
    LR, FusedOptimizer, apply_updates, f32, fp32_copies, norms, one_minus_pow,
    schedule_value)


class FusedNovoGrad(FusedOptimizer):
    """NovoGrad over the given tensors (defaults b1 0.95, b2 0.98)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-3,
                 betas: Tuple[float, float] = (0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_averaging: bool = True,
                 reg_inside_moment: bool = False, norm_type: int = 2,
                 init_zero: bool = False, bias_correction: bool = False):
        if norm_type not in (0, 2):
            raise ValueError("norm_type must be 2 (L2) or 0 (inf)")
        defaults = dict(lr=lr, betas=betas, eps=eps,
                        weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        reg_inside_moment=reg_inside_moment,
                        norm_type=norm_type, init_zero=init_zero,
                        bias_correction=bias_correction)
        super().__init__(params, defaults)

    def _init_state(self, p, st) -> None:
        st["step"] = 0
        st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
        st["exp_avg_sq"] = torch.zeros((), dtype=torch.float32,
                                       device=p.device)

    def _update(self, group, params, g32, count, stats) -> None:
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        beta3 = 1.0 - b1 if group["grad_averaging"] else 1.0
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        p32 = fp32_copies(params)
        if group["norm_type"] == 2:
            gnorm = norms(g32)
        else:
            gnorm = [g.abs().max() if g.numel() else g.new_zeros(())
                     for g in g32]
        # the norm itself is blended, not its square
        if count == 1 and not group["init_zero"]:
            torch._foreach_copy_(vs, gnorm)
        else:
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(gnorm, 1.0 - b2))
        denom = vs
        if group["bias_correction"]:
            b2_corr = f32(np.sqrt(np.float32(one_minus_pow(b2, count))))
            denom = torch._foreach_div(denom, b2_corr)
        denom = torch._foreach_add(denom, eps)
        if group["reg_inside_moment"]:  # moment mode 0
            g32 = [g / d for g, d in zip(g32, denom)]
            if wd:
                torch._foreach_add_(g32, torch._foreach_mul(p32, wd))
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(g32, beta3))
        upd = ms
        if group["bias_correction"]:
            upd = torch._foreach_div(upd, one_minus_pow(b1, count))
        if not group["reg_inside_moment"]:  # moment mode 1
            upd = [u / d for u, d in zip(upd, denom)]
            if wd:
                torch._foreach_add_(upd, torch._foreach_mul(p32, wd))
        # new_p32 = p32 - lr * update
        upd = torch._foreach_mul(upd, schedule_value(group["lr"], count))
        apply_updates(params, torch._foreach_sub(p32, upd), p32)
