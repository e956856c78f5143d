"""``FP16_Optimizer``: the legacy master-weights wrapper.

Port of ``apex_tpu/fp16_utils/fp16_optimizer.py:31-103`` in torch idiom,
as upstream apex's: the wrapped optimizer is built over the (half) model
tensors, and the wrapper rebinds each half tensor of its param groups to
an fp32 master that it owns (an fp32 model tensor is its own master). A
step keeps the reference's order:

1. each master's gradient is the fp32 copy of its model tensor's scaled
   gradient, divided by the loss scale;
2. the all-finite check over those gradients, one host read;
3. ``loss_scaler.update_scale(overflow)``;
4. on an overflow, return: masters, model tensors and the wrapped
   optimizer's state untouched;
5. otherwise, with ``clip_grad_norm``, the clip by the factor
   ``min(1, max_norm / max(gnorm, 1e-12))``;
6. the wrapped optimizer's step on the masters;
7. the masters copied into the model tensors (rounded to their dtype).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from apex_tpu_torch.amp.scaler import all_finite
from apex_tpu_torch.fp16_utils.loss_scaler import (DynamicLossScaler,
                                                   LossScaler)
from apex_tpu_torch.optimizers._fused import global_norm

_HALF = (torch.float16, torch.bfloat16)


class FP16_Optimizer:
    """Wrap ``init_optimizer`` (built over the model tensors) with fp32
    masters and a static (``static_loss_scale``) or dynamic loss scale
    (``dynamic_loss_args``: :class:`DynamicLossScaler`'s arguments)."""

    def __init__(self, init_optimizer: torch.optim.Optimizer,
                 static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None):
        self.optimizer = init_optimizer
        # (model tensor, master) pairs in param-group order
        self.pairs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for group in init_optimizer.param_groups:
            for i, p in enumerate(group["params"]):
                if p.dtype in _HALF:
                    master = p.detach().to(torch.float32, copy=True)
                    master.requires_grad_(True)
                    group["params"][i] = master
                    st = init_optimizer.state.pop(p, None)
                    if st:
                        init_optimizer.state[master] = st
                elif p.dtype == torch.float32:
                    master = p
                else:
                    raise TypeError(f"FP16_Optimizer takes float16, "
                                    f"bfloat16 or float32 tensors; got "
                                    f"{p.dtype}")
                self.pairs.append((p, master))
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.overflow = False

    @property
    def master_params(self) -> List[torch.Tensor]:
        return [m for _, m in self.pairs]

    @property
    def loss_scale(self) -> float:
        return self.loss_scaler.loss_scale

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss in fp32 times the loss scale."""
        return loss.float() * self.loss_scale

    def backward(self, loss: torch.Tensor) -> None:
        """``scale_loss(loss).backward()``: scaled gradients on the model
        tensors."""
        self.scale_loss(loss).backward()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p, m in self.pairs:
            for t in {id(p): p, id(m): m}.values():
                if set_to_none:
                    t.grad = None
                elif t.grad is not None:
                    t.grad.zero_()

    @torch.no_grad()
    def clip_master_grads(self, max_norm: float) -> torch.Tensor:
        """Scale the masters' gradients by ``min(1, max_norm / max(gnorm,
        1e-12))``, in place; returns their global norm (fp32, 0-dim)."""
        grads = [m.grad for m in self.master_params if m.grad is not None]
        gnorm = global_norm(grads)
        factor = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12),
                             max=1.0)
        torch._foreach_mul_(grads, factor)
        return gnorm

    @torch.no_grad()
    def step(self, closure=None, clip_grad_norm: Optional[float] = None):
        """One step from the model tensors' scaled gradients; skipped, with
        ``self.overflow`` set, when they are not all finite."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        scale = self.loss_scale
        masters = []
        for p, m in self.pairs:
            if p.grad is not None:
                m.grad = p.grad.to(torch.float32) / scale
                masters.append(m)
        self.overflow = not bool(all_finite([m.grad for m in masters]))
        self.loss_scaler.update_scale(self.overflow)
        if not self.overflow:
            if clip_grad_norm is not None:
                self.clip_master_grads(clip_grad_norm)
            self.optimizer.step()
            for p, m in self.pairs:
                if p is not m:
                    p.copy_(m)
        for p, m in self.pairs:  # the masters' gradients are the step's
            if p is not m:
                m.grad = None
        return loss

    # --- checkpointing (the reference's fields, :86-103) ------------------

    def state_dict(self) -> dict:
        return {"master_params": self.master_params,
                "opt_state": self.optimizer.state_dict(),
                "loss_scale": self.loss_scale,
                "dynamic": isinstance(self.loss_scaler, DynamicLossScaler),
                "unskipped": getattr(self.loss_scaler, "_unskipped", 0)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        for m, saved in zip(self.master_params, sd["master_params"]):
            m.copy_(saved)
        self.optimizer.load_state_dict(sd["opt_state"])
        self.loss_scaler._scale = float(sd["loss_scale"])
        if sd.get("dynamic") and isinstance(self.loss_scaler,
                                            DynamicLossScaler):
            self.loss_scaler._unskipped = int(sd.get("unskipped", 0))
        for p, m in self.pairs:
            if p is not m:
                p.copy_(m)
