"""LARC — layer-wise adaptive rate control / clipping.

Port of ``apex_tpu/parallel/larc.py:27-72`` in torch idiom, as upstream
apex's ``apex.parallel.LARC``: a wrapper around an optimizer that rewrites
each ``p.grad`` and then delegates the step. The arithmetic is the
reference's, in fp32:

    adaptive = trust_coefficient * ||p|| / (||g|| + wd * ||p|| + eps)

clip mode scales the gradient by ``min(adaptive / lr, 1)`` (the group's
``lr``; a schedule evaluated at LARC's own 0-based count, ``:49``), scale
mode by ``adaptive``. The gradient becomes ``(g + wd * p) * factor``, cast
back to its dtype, only where both norms are positive; elsewhere it passes
untouched, weight decay included (``:62-67``). ``wd`` is each group's
``weight_decay``, which LARC applies itself: the wrapped optimizer steps
with its groups' ``weight_decay`` at 0, restored after the step.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers._fused import f32, fp32_copies, norms


class LARC:
    """Wrap ``optimizer``; every attribute but :meth:`step`,
    :meth:`state_dict` and :meth:`load_state_dict` is the wrapped
    optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.count = 0

    def __getattr__(self, name):
        if name == "optim":  # not yet set: no recursion
            raise AttributeError(name)
        return getattr(self.optim, name)

    def state_dict(self) -> dict:
        return {"optimizer": self.optim.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.optim.load_state_dict(sd["optimizer"])
        self.count = int(sd["count"])

    @torch.no_grad()
    def _adapt(self, group: dict) -> None:
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        wd = group.get("weight_decay", 0.0)
        lr = group["lr"]
        lr = f32(lr(self.count) if callable(lr) else lr)
        p32 = fp32_copies(params)
        g32 = fp32_copies([p.grad for p in params])
        p_norm = torch.stack(norms(p32))
        g_norm = torch.stack(norms(g32))
        adaptive = (self.trust_coefficient * p_norm
                    / (g_norm + wd * p_norm + self.eps))
        factor = (torch.minimum(adaptive / lr, torch.ones_like(adaptive))
                  if self.clip else adaptive)
        keep = (p_norm > 0) & (g_norm > 0)
        adapted = (torch._foreach_add(g32, torch._foreach_mul(p32, wd))
                   if wd else g32)
        for p, a, g, f, k in zip(params, adapted, g32, factor.unbind(),
                                 keep.unbind()):
            p.grad.copy_(torch.where(k, a * f, g))

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        decays = []
        for group in self.optim.param_groups:
            self._adapt(group)
            decays.append(group.get("weight_decay"))
            if "weight_decay" in group:
                group["weight_decay"] = 0.0
        try:
            self.optim.step()
        finally:
            for group, wd in zip(self.optim.param_groups, decays):
                if wd is not None:
                    group["weight_decay"] = wd
        self.count += 1
        return loss
