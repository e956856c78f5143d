"""Fused Adam / AdamW as a ``torch.optim.Optimizer``.

Port of ``apex_tpu/optimizers/fused_adam.py`` (the knobs of ``:28-38``)
with the per-tensor semantics of ``apex_tpu/optimizers/_fused.py:82-143``:

* ``adam_w_mode=True`` (default): decoupled weight decay —
  ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
  ``adam_w_mode=False``: L2 — ``g += wd * p`` before the moments;
* all math in fp32, m and v kept in fp32; a step counter incremented
  before use (1-based, for the bias correction); a callable ``lr`` is a
  schedule evaluated at ``count - 1`` (``schedule_value``, ``:53-57``);
* the reference's two roundings: the update is ``u = (new_p32 -
  p32).to(p.dtype)`` (``_fused.py:128``) and the parameter becomes
  ``p + u`` in its own dtype (``optax.apply_updates``). Writing
  ``new_p32.to(bf16)`` directly would differ by an ulp.

The update is plain PyTorch (``torch._foreach_*`` over all tensors of a
group, updated in place), as the reference's is XLA, not Pallas; scalars
(bias corrections, a scheduled lr) are computed in fp32 like the
reference's. A multi-tensor CUDA Adam is a later performance candidate;
the reference's ``layout`` knob (its chunked mega-buffer) comes with it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple, Union

import numpy as np
import torch

LR = Union[float, Callable[[int], float]]


def _f32(x) -> float:
    """``x`` rounded to fp32, as a Python float (exact in fp32 math)."""
    return float(np.float32(x))


class FusedAdam(torch.optim.Optimizer):
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

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params)
        return loss

    def _update(self, group, params) -> None:
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        ms, vs, counts = [], [], set()
        for p in params:
            st = self.state[p]
            if not st:
                st["step"] = 0
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            st["step"] += 1
            counts.add(st["step"])
            ms.append(st["exp_avg"])
            vs.append(st["exp_avg_sq"])
        if len(counts) != 1:
            raise RuntimeError("FusedAdam steps every tensor of a group "
                               "together; their step counts differ")
        count = counts.pop()
        step32 = np.float32(count)
        lr = group["lr"]
        lr = _f32(lr(count - 1) if callable(lr) else lr)

        # copies: an fp32 grad or param must not be updated in place here
        g32 = [p.grad.to(torch.float32, copy=True) for p in params]
        p32 = [p.to(torch.float32, copy=True) for p in params]
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
            bc1 = _f32(np.float32(1.0) - np.float32(b1) ** step32)
            bc2 = _f32(np.float32(1.0) - np.float32(b2) ** step32)
            m_hat = torch._foreach_div(ms, bc1)
            den = torch._foreach_div(vs, bc2)
        else:
            m_hat = ms
            den = [v.clone() for v in vs]
        # torch.sqrt on CPU float32 is not correctly rounded (an ulp off on
        # ~17% of inputs, which the cancellation in p - lr * update turns
        # into tens of ulps of a small parameter); the float64 root rounded
        # once to float32 is, as the reference's IEEE sqrt. CUDA's sqrtf is
        # IEEE (the kernels build without --use_fast_math).
        if all(d.is_cuda for d in den):
            torch._foreach_sqrt_(den)
        else:
            den = [d.double().sqrt_().float() for d in den]
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(m_hat, den)
        del m_hat, den
        if group["adam_w_mode"] and wd:
            torch._foreach_add_(upd, torch._foreach_mul(p32, wd))
        torch._foreach_mul_(upd, lr)
        # new_p32 = p32 - lr * update; u = (new_p32 - p32) in p's dtype;
        # p <- p + u in p's dtype
        new_p = torch._foreach_sub(p32, upd)
        del upd
        torch._foreach_sub_(new_p, p32)
        for p, u in zip(params, new_p):
            p.add_(u.to(p.dtype))
