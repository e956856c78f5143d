"""Fused LAMB as a ``torch.optim.Optimizer``.

Port of ``apex_tpu/optimizers/fused_lamb.py:32-146`` (per-tensor layout)
on the shared base :mod:`apex_tpu_torch.optimizers._fused`:

1. the gradient norm over EVERY tensor of every param group (the
   reference's ``global_stats`` over all leaves, ``:111-114``); each
   gradient is divided by ``clipped = gnorm / max_grad_norm`` where
   ``gnorm > max_grad_norm``, else 1 (``:70-72``), before the moments;
2. Adam's moments on the clipped gradient; the update
   ``m_hat / (sqrt(v_hat) + eps)`` plus ``wd * p`` (decoupled, always:
   ``:54-55``); a per-tensor trust ratio ``lr * ||p|| / ||u||`` where both
   norms are positive, applied only when ``use_nvlamb`` or the group's
   ``weight_decay != 0`` (``:61-66``), else ``lr``.

The reference's ``adam_w_mode`` (``:104``) is accepted there and never
read: its LAMB always decays decoupled. It is not an argument here.

Per-tensor norms are per tensor of the port's tree: a model that keeps
its layers as separate tensors gets one trust ratio a layer (upstream
apex's ``multi_tensor_lamb`` for PyTorch models), where the reference,
given its models' stacked leaves, takes one norm over all layers of a
leaf together.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

from apex_tpu_torch.optimizers._fused import (
    LR, FusedOptimizer, apply_updates, fp32_copies, global_norm, ieee_sqrt,
    norms, one_minus_pow, schedule_value)


def lamb_math(group: dict, p32: List[torch.Tensor], g32: List[torch.Tensor],
              ms: List[torch.Tensor], vs: List[torch.Tensor], count: int,
              clipped: torch.Tensor) -> List[torch.Tensor]:
    """The reference's ``lamb_update_math`` (``:32-66``) over one group's
    fp32 tensors: updates the moments ``ms``/``vs`` in place and returns
    the new fp32 parameters (``p32`` is read, not written)."""
    b1, b2 = group["betas"]
    eps, wd = group["eps"], group["weight_decay"]
    beta3 = 1.0 - b1 if group["grad_averaging"] else 1.0
    g = torch._foreach_div(g32, clipped)
    # m = b1 * m + beta3 * g;  v = b2 * v + (1 - b2) * g * g
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(g, beta3))
    gg = torch._foreach_mul(g, 1.0 - b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, gg)
    del g, gg
    if group["bias_correction"]:
        m_hat = torch._foreach_div(ms, one_minus_pow(b1, count))
        den = torch._foreach_div(vs, one_minus_pow(b2, count))
    else:
        m_hat, den = ms, vs
    den = ieee_sqrt(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(m_hat, den)
    del m_hat, den
    if wd:
        torch._foreach_add_(upd, torch._foreach_mul(p32, wd))
    lr = schedule_value(group["lr"], count)
    if group["use_nvlamb"] or wd != 0.0:
        # the per-tensor trust ratios (multi_tensor_lamb.cu:244-262)
        p_norm = torch.stack(norms(p32))
        u_norm = torch.stack(norms(upd))
        ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                            lr * p_norm / u_norm,
                            torch.full_like(p_norm, lr))
        for u, r in zip(upd, ratio.unbind()):
            u.mul_(r)
    else:
        torch._foreach_mul_(upd, lr)
    return torch._foreach_sub(p32, upd)


class FusedLAMB(FusedOptimizer):
    """LAMB over the given tensors or param groups; ``max_grad_norm``'s
    clip is computed once over every group, each group's
    ``weight_decay`` decides its own trust ratios."""

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, bias_correction: bool = True,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False):
        defaults = dict(lr=lr, betas=betas, eps=eps,
                        weight_decay=weight_decay,
                        bias_correction=bias_correction,
                        grad_averaging=grad_averaging, use_nvlamb=use_nvlamb)
        self.max_grad_norm = max_grad_norm
        super().__init__(params, defaults)

    def _init_state(self, p, st) -> None:
        st["step"] = 0
        st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
        st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)

    def _global_stats(self, params) -> torch.Tensor:
        """The clip divisor from the gradient norm over every group."""
        gnorm = global_norm([p.grad for ps in params for p in ps])
        return torch.where(gnorm > self.max_grad_norm,
                           gnorm / self.max_grad_norm,
                           torch.ones_like(gnorm))

    def _moments(self, params):
        return ([self.state[p]["exp_avg"] for p in params],
                [self.state[p]["exp_avg_sq"] for p in params])

    def _update(self, group, params, g32, count, clipped) -> None:
        p32 = fp32_copies(params)
        new_p = lamb_math(group, p32, g32, *self._moments(params), count,
                          clipped)
        apply_updates(params, new_p, p32)
