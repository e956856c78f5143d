"""fp32 master weights (opt level O2).

Port of ``apex_tpu/amp/master.py``: :class:`MasterWeights` holds the fp32
``master`` tensors, which the optimizer updates, and the ``model`` tensors
in ``param_dtype``, which the forward reads (apex's
``_process_optimizer.py:28-90`` clones half params into fp32 masters).
:meth:`MasterWeights.resync` is the master-to-model copy, in place
(round to nearest, so a master past the half type's range becomes inf).
:func:`apply_updates_with_master` is the O2 step's epilogue in the form
the frontend's optimizer takes: the fp32 gradients handed to the masters,
one optimizer step over them unless the gradients overflowed, and the
resync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from apex_tpu_torch.amp.policy import Policy
from apex_tpu_torch.amp.scaler import SkipStepIfNonfinite
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass
class MasterWeights:
    """fp32 masters and the ``param_dtype`` model params derived from
    them; the model leaves require grad (the forward's leaves)."""

    master: Tree
    model: Tree
    param_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def create(cls, params: Tree, policy: Policy) -> "MasterWeights":
        """Masters as fp32 copies of ``params`` (possibly half), the model
        params as ``policy.param_dtype`` copies of the masters."""
        def copy(t, dtype, grad):
            if not t.is_floating_point():
                return t
            return t.detach().to(dtype, copy=True).requires_grad_(grad)

        master = tree_map(lambda t: copy(t, torch.float32, False), params)
        model = tree_map(lambda t: copy(t, policy.param_dtype, True), master)
        return cls(master=master, model=model,
                   param_dtype=policy.param_dtype)

    @torch.no_grad()
    def resync(self) -> "MasterWeights":
        """Copy every master into its model tensor, in place."""
        for m, w in zip(tree_leaves(self.model), tree_leaves(self.master)):
            if m.is_floating_point():
                m.copy_(w)
        return self


def apply_updates_with_master(weights: MasterWeights, optimizer,
                              grads: Tree, *,
                              grads_finite: Optional[torch.Tensor] = None
                              ) -> MasterWeights:
    """The O2 step's epilogue: ``grads`` (fp32, the masters' structure)
    become the masters' ``.grad``, ``optimizer`` (over the masters) steps
    unless ``grads_finite`` is False — a :class:`SkipStepIfNonfinite`
    decides itself, reading the flag (or, without one, the gradients) on
    the host once — and the model params are resynced from the masters.
    A skipped step changes nothing. Returns ``weights``."""
    masters = [t for t in tree_leaves(weights.master) if t.is_floating_point()]
    gl = [g for g in tree_leaves(grads) if g.is_floating_point()]
    if len(gl) != len(masters):
        raise ValueError(f"{len(gl)} gradients for {len(masters)} masters")
    for m, g in zip(masters, gl):
        m.grad = g
    try:
        if isinstance(optimizer, SkipStepIfNonfinite):
            stepped = optimizer.step(grads_finite=grads_finite)
        elif grads_finite is None or bool(grads_finite):
            optimizer.step()
            stepped = True
        else:
            stepped = False
    finally:
        for m in masters:
            m.grad = None
    if stepped:
        weights.resync()
    return weights


def o2_state_dict_params(weights: MasterWeights) -> Tree:
    """The fp32 params to checkpoint whatever the cast (apex's
    ``O2StateDictHook``)."""
    return weights.master
