"""Static and dynamic loss scaling as functions of an explicit state.

Port of ``apex_tpu/amp/scaler.py``. :class:`LossScalerState` holds the
scale (fp32), the growth tracker and the lifetime count of skipped steps
(int32) as 0-dim tensors on the params' device; the constants are plain
fields, as the reference's static metadata. The dynamic rule is apex's
(``apex/amp/scaler.py:197-217``): start at 2**16, halve on an overflow
(at least 1), double after 2000 overflow-free steps (at most 2**24).

:func:`update_loss_scaler` is ``torch.where`` on the device: no host read.
:func:`scaled_value_and_grad` is the whole ``with amp.scale_loss(...)``
protocol as one call: the loss scaled before ``torch.autograd.grad``, the
gradients unscaled to fp32, the finite flag and the next scaler state
returned beside them, in the reference's structure.

:func:`skip_step_if_nonfinite` wraps a ``torch.optim.Optimizer`` (the
port's ``FusedAdam``) so a step whose gradients are not all finite leaves
the parameters, ``exp_avg``, ``exp_avg_sq`` and the step count exactly as
they were, the reference's contract (``scaler.py:179-216``). The wrapper
reads the finite flag on the host once a step and skips the inner step
when it is False; the reference selects the old state on the device
instead, which the port's optimizer, whose step count lives on the host,
cannot do without a read either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from apex_tpu_torch.utils.pytree import tree_all_finite, tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass
class LossScalerState:
    """The scale, the overflow-free step count since the last growth and
    the lifetime overflow count; ``dynamic`` picks the rule (a fixed scale
    still counts its overflows)."""

    loss_scale: torch.Tensor       # fp32, 0-dim
    growth_tracker: torch.Tensor   # int32, 0-dim
    skipped_steps: torch.Tensor    # int32, 0-dim
    dynamic: bool = True
    growth_interval: int = 2000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    max_loss_scale: float = 2.0 ** 24
    min_loss_scale: float = 1.0


def init_loss_scaler(loss_scale: Union[str, float] = "dynamic", *,
                     init_scale: float = 2.0 ** 16,
                     growth_interval: int = 2000, growth_factor: float = 2.0,
                     backoff_factor: float = 0.5,
                     max_loss_scale: float = 2.0 ** 24,
                     min_loss_scale: float = 1.0,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> LossScalerState:
    """A scaler: ``loss_scale="dynamic"`` or a fixed float (the surface of
    ``amp.initialize(loss_scale=...)``), its tensors on ``device``
    (default: the card)."""
    from apex_tpu_torch.ops import _backend  # the ops import amp.lists

    dev = _backend.resolve_device(device)
    dynamic = loss_scale == "dynamic"
    scale = init_scale if dynamic else float(loss_scale)
    return LossScalerState(
        loss_scale=torch.tensor(scale, dtype=torch.float32, device=dev),
        growth_tracker=torch.zeros((), dtype=torch.int32, device=dev),
        skipped_steps=torch.zeros((), dtype=torch.int32, device=dev),
        dynamic=dynamic, growth_interval=growth_interval,
        growth_factor=growth_factor, backoff_factor=backoff_factor,
        max_loss_scale=max_loss_scale, min_loss_scale=min_loss_scale)


def scale_loss(state: LossScalerState, loss: torch.Tensor) -> torch.Tensor:
    """``loss.float() * loss_scale``."""
    return loss.float() * state.loss_scale


def unscale_grads(state: LossScalerState, grads: Tree) -> Tree:
    """Every gradient in fp32, times 1 / loss_scale."""
    inv = 1.0 / state.loss_scale
    return tree_map(lambda g: g.float() * inv, grads)


def all_finite(grads: Tree) -> torch.Tensor:
    """The overflow check: a 0-dim bool on the device, no host read."""
    return tree_all_finite(grads)


def update_loss_scaler(state: LossScalerState,
                       grads_finite: torch.Tensor) -> LossScalerState:
    """The post-step rule, with no host read: an overflow multiplies the
    scale by ``backoff_factor`` (at least ``min_loss_scale``) and resets
    the tracker; otherwise the tracker counts up, and at
    ``growth_interval`` the scale grows by ``growth_factor`` (at most
    ``max_loss_scale``) and the tracker resets. A fixed scale only counts
    its overflows."""
    finite = torch.as_tensor(grads_finite, device=state.loss_scale.device)
    skipped = state.skipped_steps + (~finite).to(torch.int32)
    if not state.dynamic:
        return dataclasses.replace(state, skipped_steps=skipped)
    zero = torch.zeros_like(state.growth_tracker)
    tracker = torch.where(finite, state.growth_tracker + 1, zero)
    grow = tracker >= state.growth_interval
    scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(state.loss_scale * state.growth_factor,
                                      max=state.max_loss_scale),
                    state.loss_scale),
        torch.clamp(state.loss_scale * state.backoff_factor,
                    min=state.min_loss_scale))
    return dataclasses.replace(state, loss_scale=scale,
                               growth_tracker=torch.where(grow, zero,
                                                          tracker),
                               skipped_steps=skipped)


def scaled_value_and_grad(fn: Callable[..., Any], *,
                          has_aux: bool = False) -> Callable[..., Tuple]:
    """``g = scaled_value_and_grad(loss_fn)``, then ``loss, (grads,
    finite, new_scaler) = g(scaler, params, *args)``: ``fn(params, *args)``
    is scaled, differentiated by ``torch.autograd.grad`` with respect to
    the floating-point leaves of ``params`` (leaves that do not require
    grad are set to), and the gradients come back unscaled in fp32 in
    ``params``' structure, with the finite flag and the updated scaler
    state, all on the device. With ``has_aux``, ``fn`` returns ``(loss,
    aux)`` and the first result is ``(loss, aux)``."""

    def wrapped(scaler: LossScalerState, params, *args, **kwargs):
        leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_(True)
        out = fn(params, *args, **kwargs)
        loss, aux = out if has_aux else (out, None)
        scaled = scale_loss(scaler, loss)
        got = torch.autograd.grad(scaled, leaves, allow_unused=True)
        by_id = {id(t): torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, got)}
        grads = unscale_grads(scaler, tree_map(
            lambda t: by_id.get(id(t)), params))
        finite = all_finite(grads)
        new_scaler = update_loss_scaler(scaler, finite)
        loss = scaled.detach() / scaler.loss_scale
        if has_aux:
            return (loss, aux), (grads, finite, new_scaler)
        return loss, (grads, finite, new_scaler)

    return wrapped


def apply_if_finite(params: Tree, new_params: Tree,
                    grads_finite: torch.Tensor) -> Tree:
    """``new_params`` where the gradients were finite, else ``params``,
    selected on the device."""
    return tree_map(lambda old, new: torch.where(grads_finite, new, old),
                    params, new_params)


class SkipStepIfNonfinite:
    """An optimizer whose step is skipped whole when the gradients are not
    all finite: parameters, moments and step count untouched. Every
    other attribute is the wrapped optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer):
        self.optimizer = optimizer

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def step(self, closure=None, *,
             grads_finite: Optional[torch.Tensor] = None) -> bool:
        """Step the wrapped optimizer unless ``grads_finite`` (default: the
        finite flag of every ``.grad`` of its param groups) is False. One
        host read of the flag a step. Returns whether it stepped."""
        if grads_finite is None:
            grads_finite = all_finite([
                p.grad for g in self.optimizer.param_groups
                for p in g["params"] if p.grad is not None])
        if not bool(grads_finite):
            return False
        self.optimizer.step(closure)
        return True


def skip_step_if_nonfinite(optimizer: torch.optim.Optimizer
                           ) -> SkipStepIfNonfinite:
    """Wrap ``optimizer`` so an overflowed step is skipped entirely: zero
    updates AND untouched inner state (moments, step count). Use it
    whenever gradients can overflow (fp16 with loss scaling)::

        opt = amp.skip_step_if_nonfinite(FusedAdam(params, lr=1e-3))
        opt.step(grads_finite=finite)
    """
    return SkipStepIfNonfinite(optimizer)


def scaler_metrics(state: LossScalerState) -> dict:
    """The scale, the growth tracker and the overflow count as Python
    numbers: one device-to-host read, only when called."""
    return {"loss_scale": float(state.loss_scale),
            "growth_tracker": int(state.growth_tracker),
            "skipped_steps": int(state.skipped_steps)}


def state_dict(state: LossScalerState) -> dict:
    """The serializable state, ``amp.state_dict()``'s per-scaler payload."""
    return {"loss_scale": float(state.loss_scale),
            "unskipped": int(state.growth_tracker),
            "skipped": int(state.skipped_steps),
            "dynamic": state.dynamic}


def load_state_dict(state: LossScalerState, payload: dict) -> LossScalerState:
    dev = state.loss_scale.device
    return dataclasses.replace(
        state,
        loss_scale=torch.tensor(payload["loss_scale"], dtype=torch.float32,
                                device=dev),
        growth_tracker=torch.tensor(payload.get("unskipped", 0),
                                    dtype=torch.int32, device=dev),
        skipped_steps=torch.tensor(payload.get("skipped", 0),
                                   dtype=torch.int32, device=dev),
        dynamic=payload.get("dynamic", state.dynamic))
