"""Sigmoid focal loss over one-vs-all classification logits.

Port of ``apex_tpu/ops/focal_loss.py`` (``:31-74``; the contrib surface
``apex.contrib.focal_loss``): FL(p_t) = −α_t (1 − p_t)^γ · BCE-with-logits
against label-smoothed one-vs-all targets, summed (Lin et al. 2017). As in
the reference, the forward materialises the whole partial gradient of the
sum and keeps it as the only residual, so the backward is one scale (the
reference's saved partial-grad buffer). No kernel: the reference's is XLA,
and so is this plain PyTorch.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.lists import apply_op_rules


def _fl_sum(lf: torch.Tensor, targets: torch.Tensor, num_classes: int,
            alpha: float, gamma: float, smoothing: float) -> torch.Tensor:
    """``_fl_sum`` (``:48-57``) on fp32 logits."""
    # one-vs-all: class c > 0 at index c - 1; background (0), a negative
    # target or one past the classes is all-zero (jax.nn.one_hot)
    classes = torch.arange(num_classes, device=lf.device)
    onehot = (targets[..., None].long() - 1 == classes).to(torch.float32)
    t = onehot * (1.0 - smoothing) + (1.0 - onehot) * smoothing
    p = torch.sigmoid(lf)
    ce = torch.logaddexp(lf.new_zeros(()), lf) - t * lf
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    return (alpha_t * (1.0 - p_t) ** gamma * ce).sum()


class _FocalLoss(torch.autograd.Function):
    """``_fl_core`` (``:23-28``, ``:60-74``)."""

    @staticmethod
    def forward(ctx, logits, targets, num_classes, alpha, gamma, smoothing):
        with torch.enable_grad():
            lf = logits.detach().to(torch.float32).requires_grad_()
            loss = _fl_sum(lf, targets, num_classes, alpha, gamma,
                           smoothing)
            (partial,) = torch.autograd.grad(loss, lf)
        ctx.save_for_backward(partial.to(logits.dtype))
        return loss.detach()

    @staticmethod
    def backward(ctx, g):
        (partial,) = ctx.saved_tensors
        return ((g * partial.to(torch.float32)).to(partial.dtype), None,
                None, None, None, None)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, num_classes: int,
               alpha: float = 0.25, gamma: float = 2.0,
               smoothing_factor: float = 0.0) -> torch.Tensor:
    """Summed sigmoid focal loss (``:31-45``): ``logits`` (..., num_classes),
    ``targets`` (...) integer class ids (0 = background). Returns an fp32
    scalar; the gradient has the logits' dtype. FLOAT-class under O1 (the
    logits cast to fp32)."""
    if logits.shape[-1] != num_classes \
            or tuple(targets.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"logits (..., {num_classes}) and targets (...) of "
                         f"the same leading dims; got {tuple(logits.shape)} "
                         f"and {tuple(targets.shape)}")
    logits, = apply_op_rules("focal_loss", logits)
    return _FocalLoss.apply(logits, targets, int(num_classes), float(alpha),
                            float(gamma), float(smoothing_factor))
