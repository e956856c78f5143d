"""``amp.initialize`` and the decorator and context surface.

Port of ``apex_tpu/amp/frontend.py``. :func:`initialize` takes a params
tree and a ``torch.optim.Optimizer`` built over its leaves and returns an
:class:`AmpState`: the params cast to the level's param dtype, or under
O2 a :class:`~apex_tpu_torch.amp.master.MasterWeights` whose fp32 masters
take the params' places in the optimizer's ``param_groups`` (as apex's
``_process_optimizer`` swaps them in); the optimizer, wrapped by
:func:`~apex_tpu_torch.amp.scaler.skip_step_if_nonfinite` whenever a
scaler is active; the scaler state (one, a list of ``num_losses``, or
None at a fixed scale of 1); and the policy. ``half_function``,
``float_function`` and ``promote_function`` mark a function's O1 cast
class (with the reference's warning on a name already registered),
:func:`disable_casts` suspends O1 casting, :func:`master_params` lists
the fp32 leaves.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Optional, Union

import torch

from apex_tpu_torch.amp import lists as _lists
from apex_tpu_torch.amp.master import MasterWeights
from apex_tpu_torch.amp.policy import O0, Policy, get_policy, with_policy
from apex_tpu_torch.amp.scaler import (LossScalerState, init_loss_scaler,
                                       skip_step_if_nonfinite)
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

# per-level loss-scale defaults (apex frontend.py:102-191): O1/O2
# "dynamic", O0/O3 1.0
_DEFAULT_LOSS_SCALE = {"O0": 1.0, "O1": "dynamic", "O2": "dynamic", "O3": 1.0}


@dataclasses.dataclass
class AmpState:
    """What :func:`initialize` configures. ``scaler``: None when scaling
    is off (a fixed scale of 1), one state, or a list of ``num_losses``
    independent states."""

    params: Any
    optimizer: Any
    scaler: Union[None, LossScalerState, list]
    policy: Policy


def _swap_params(optimizer, old_leaves, new_leaves) -> None:
    """Put each new tensor where its old one sits in the optimizer's
    param groups (and its state, if any, under the new key)."""
    by_id = {id(o): n for o, n in zip(old_leaves, new_leaves) if o is not n}
    if not by_id:
        return
    for group in optimizer.param_groups:
        group["params"] = [by_id.get(id(p), p) for p in group["params"]]
    for p in list(optimizer.state):
        if id(p) in by_id:
            optimizer.state[by_id[id(p)]] = optimizer.state.pop(p)


def initialize(params, optimizer=None, opt_level: str = "O1", *,
               half_dtype: torch.dtype = torch.bfloat16, loss_scale=None,
               keep_batchnorm_fp32: Optional[bool] = None,
               master_weights: Optional[bool] = None, num_losses: int = 1,
               verbosity: int = 0) -> AmpState:
    """apex's ``amp.initialize``: the level's policy (with the overrides
    validated by :func:`get_policy`); params cast to its param dtype, or
    wrapped in MasterWeights under O2 with the masters swapped into the
    optimizer; ``loss_scale=None`` takes the level's default ("dynamic"
    for O1 and O2, 1.0 for O0 and O3); the scaler's tensors on the params'
    device; the optimizer wrapped to skip overflowed steps whenever a
    scaler is active. Run the forward under ``with_policy(state.policy)``
    so the O1 per-op rules apply."""
    del verbosity
    policy = get_policy(opt_level, half_dtype=half_dtype,
                        keep_norm_f32=keep_batchnorm_fp32,
                        master_weights=master_weights)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    if loss_scale is None:
        loss_scale = _DEFAULT_LOSS_SCALE[opt_level]
    scaler = init_loss_scaler(loss_scale, device=device)
    scaled = scaler.dynamic or float(scaler.loss_scale) != 1.0
    if scaled and num_losses > 1:
        scaler = [init_loss_scaler(loss_scale, device=device)
                  for _ in range(num_losses)]

    if policy.master_weights:
        out_params = MasterWeights.create(params, policy)
        new_leaves = tree_leaves(out_params.master)
    else:
        def cast(t):
            if not t.is_floating_point() or t.dtype == policy.param_dtype:
                return t
            return t.detach().to(policy.param_dtype).requires_grad_(
                t.requires_grad)

        out_params = tree_map(cast, params)
        new_leaves = tree_leaves(out_params)
    if optimizer is not None:
        _swap_params(optimizer, leaves, new_leaves)
        if scaled:
            optimizer = skip_step_if_nonfinite(optimizer)
    return AmpState(params=out_params, optimizer=optimizer,
                    scaler=scaler if scaled else None, policy=policy)


def _op_decorator(register):
    def decorator(fn):
        name = fn.__name__
        if (name in _lists.HALF_OPS or name in _lists.FLOAT_OPS
                or name in _lists.PROMOTE_OPS):
            warnings.warn(
                f"amp: {name!r} is already a registered op family — "
                f"decorating a function with this name rewrites the O1 cast "
                f"rule for every op that consults it; rename the function "
                f"if that is not intended")
        register(name)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return fn(*_lists.apply_op_rules(name, *args), **kwargs)

        return wrapped

    return decorator


#: mark a function's O1 cast class; positional tensors are cast, keyword
#: arguments left alone (apex's wrappers cast ``args``)
half_function = _op_decorator(_lists.register_half_op)
float_function = _op_decorator(_lists.register_float_op)
promote_function = _op_decorator(_lists.register_promote_op)


def disable_casts():
    """Suspend O1 per-op casting in the block (the O0 policy pushed, so
    ``apply_op_rules`` is the identity)."""
    return with_policy(O0)


def master_params(state) -> list:
    """The fp32 master leaves of an :class:`AmpState`, a
    :class:`MasterWeights` or a bare params tree."""
    if isinstance(state, AmpState):
        state = state.params
    if isinstance(state, MasterWeights):
        state = state.master
    return tree_leaves(state)
