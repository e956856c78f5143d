"""Fused SGD with momentum as a ``torch.optim.Optimizer``.

Port of ``apex_tpu/optimizers/fused_sgd.py:26-70`` on the shared base:
L2 weight decay into the gradient, the momentum buffer ``buf = momentum *
buf + (1 - dampening) * g`` with the gradient itself as the buffer on the
first step (``count == 1``, ``:46-47``), Nesterov's ``g + momentum *
buf``. ``grad_scale`` fuses an unscale into the step, ``g * (1 /
grad_scale)`` (``:40-41``). Nesterov requires momentum > 0 and zero
dampening (``:36-37``).
"""

from __future__ import annotations

from typing import Iterable

import torch

from apex_tpu_torch.optimizers._fused import (
    LR, FusedOptimizer, apply_updates, fp32_copies, schedule_value)


class FusedSGD(FusedOptimizer):
    """SGD over the given tensors; the momentum buffer
    (``state[p]["momentum_buffer"]``, fp32) exists where momentum > 0."""

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-3,
                 momentum: float = 0.0, dampening: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 grad_scale: float = 1.0):
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov,
                        grad_scale=grad_scale)
        super().__init__(params, defaults)
        for group in self.param_groups:
            if group["nesterov"] and (group["momentum"] <= 0
                                      or group["dampening"] != 0):
                raise ValueError("nesterov requires momentum > 0 and zero "
                                 "dampening")

    def _update(self, group, params, g32, count, stats) -> None:
        momentum, wd = group["momentum"], group["weight_decay"]
        p32 = fp32_copies(params)
        if group["grad_scale"] != 1.0:
            torch._foreach_mul_(g32, 1.0 / group["grad_scale"])
        if wd:
            torch._foreach_add_(g32, torch._foreach_mul(p32, wd))
        if momentum:
            if count == 1:
                bufs = [g.clone() for g in g32]
                for p, b in zip(params, bufs):
                    self.state[p]["momentum_buffer"] = b
            else:
                bufs = [self.state[p]["momentum_buffer"] for p in params]
                torch._foreach_mul_(bufs, momentum)
                torch._foreach_add_(bufs, torch._foreach_mul(
                    g32, 1.0 - group["dampening"]))
            if group["nesterov"]:
                d_p = torch._foreach_add(g32, torch._foreach_mul(bufs,
                                                                 momentum))
            else:
                d_p = bufs
        else:
            d_p = g32
        # new_p32 = p32 - lr * d_p
        upd = torch._foreach_mul(d_p, schedule_value(group["lr"], count))
        apply_updates(params, torch._foreach_sub(p32, upd), p32)
