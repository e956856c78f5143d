"""Fused Adagrad as a ``torch.optim.Optimizer``.

Port of ``apex_tpu/optimizers/fused_adagrad.py:22-50`` on the shared
base: ``h += g * g``, ``p -= lr * g / (sqrt(h) + eps)`` with the sum
``h`` in ``state[p]["sum"]`` (fp32). ``adagrad_w_mode`` adds ``wd * p`` to
the update (decoupled); otherwise L2 weight decay goes into the gradient
first.
"""

from __future__ import annotations

from typing import Iterable

import torch

from apex_tpu_torch.optimizers._fused import (
    LR, FusedOptimizer, apply_updates, fp32_copies, ieee_sqrt, schedule_value)


class FusedAdagrad(FusedOptimizer):
    """Adagrad over the given tensors (defaults lr 1e-2, eps 1e-10)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0,
                 adagrad_w_mode: bool = False):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay,
                        adagrad_w_mode=adagrad_w_mode)
        super().__init__(params, defaults)

    def _init_state(self, p, st) -> None:
        st["step"] = 0
        st["sum"] = torch.zeros_like(p, dtype=torch.float32)

    def _update(self, group, params, g32, count, stats) -> None:
        wd = group["weight_decay"]
        hs = [self.state[p]["sum"] for p in params]
        p32 = fp32_copies(params)
        if not group["adagrad_w_mode"] and wd:
            torch._foreach_add_(g32, torch._foreach_mul(p32, wd))
        torch._foreach_add_(hs, torch._foreach_mul(g32, g32))
        den = ieee_sqrt(hs)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(g32, den)
        del den
        if group["adagrad_w_mode"] and wd:
            torch._foreach_add_(upd, torch._foreach_mul(p32, wd))
        torch._foreach_mul_(upd, schedule_value(group["lr"], count))
        apply_updates(params, torch._foreach_sub(p32, upd), p32)
