"""Precision policies: the O0-O3 opt levels as data.

Port of ``apex_tpu/amp/policy.py``: :class:`Policy` (``:26-84``) over torch
dtypes, the presets ``O0``-``O3`` (``:94-97``), :func:`get_policy` with the
reference's validation (``:102-140``), and the ambient policy:
:class:`with_policy`, a thread-local stack usable as a context and as a
decorator, and :func:`current_policy` (O0 when none is installed). Layers
read the ambient policy (the ops' O1 casts go through
:func:`apex_tpu_torch.amp.lists.apply_op_rules`); nothing is patched.

``half_dtype`` has two working values on the card: ``torch.bfloat16``, the
default, and ``torch.float16``, which the flash, LayerNorm and
cross-entropy kernels of GPT's train step take too (pair it with the
dynamic loss scaler).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import torch

from apex_tpu_torch.utils.pytree import tree_cast

Tree = Any
HALF_DTYPES = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class Policy:
    """A mixed-precision policy: param, compute and output dtypes, whether
    fp32 master weights back the params, whether norms keep fp32
    statistics, and whether the O1 per-op cast rules apply."""

    name: str = "O0"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    master_weights: bool = False
    keep_norm_f32: bool = True
    per_op_rules: bool = False  # O1: consult apex_tpu_torch.amp.lists

    def cast_to_param(self, tree: Tree) -> Tree:
        return tree_cast(tree, self.param_dtype)

    def cast_to_compute(self, tree: Tree) -> Tree:
        """Params and inputs for the forward (apex's patched forward's
        input cast)."""
        return tree_cast(tree, self.compute_dtype)

    def cast_to_output(self, tree: Tree) -> Tree:
        """Network outputs, so the loss is taken in the output dtype."""
        return tree_cast(tree, self.output_dtype)

    @property
    def norm_dtype(self) -> torch.dtype:
        """The dtype of normalization statistics."""
        return torch.float32 if self.keep_norm_f32 else self.compute_dtype

    def run(self, fn, params: Tree, *args, **kwargs):
        """``fn(params, *args, **kwargs)`` with params and inputs cast to
        the compute dtype and the outputs to the output dtype."""
        out = fn(self.cast_to_compute(params), *self.cast_to_compute(args),
                 **self.cast_to_compute(kwargs))
        return self.cast_to_output(out)


def _make(name, param, compute, output, master, keep_norm, per_op=False):
    return Policy(name=name, param_dtype=param, compute_dtype=compute,
                  output_dtype=output, master_weights=master,
                  keep_norm_f32=keep_norm, per_op_rules=per_op)


f32, bf16 = torch.float32, torch.bfloat16
O0 = _make("O0", f32, f32, f32, master=False, keep_norm=True)
O1 = _make("O1", f32, bf16, f32, master=False, keep_norm=True, per_op=True)
O2 = _make("O2", bf16, bf16, f32, master=True, keep_norm=True)
O3 = _make("O3", bf16, bf16, bf16, master=False, keep_norm=False)
del f32, bf16

_LEVELS = {"O0": O0, "O1": O1, "O2": O2, "O3": O3}


def get_policy(opt_level: str = "O0", *,
               half_dtype: torch.dtype = torch.bfloat16,
               keep_norm_f32: Optional[bool] = None,
               master_weights: Optional[bool] = None) -> Policy:
    """An opt-level preset with its half dtype substituted and the
    overrides validated as apex's ``Properties`` does: O1 keeps fp32 norms
    and takes no master weights."""
    if opt_level not in _LEVELS:
        raise ValueError(f"unknown opt_level {opt_level!r}; expected one of "
                         f"{sorted(_LEVELS)}")
    if half_dtype not in HALF_DTYPES:
        raise ValueError(f"half_dtype must be one of {HALF_DTYPES}, got "
                         f"{half_dtype}")
    p = _LEVELS[opt_level]
    sub = lambda d: half_dtype if d == torch.bfloat16 else d  # noqa: E731
    p = dataclasses.replace(p, param_dtype=sub(p.param_dtype),
                            compute_dtype=sub(p.compute_dtype),
                            output_dtype=sub(p.output_dtype))
    if keep_norm_f32 is not None:
        if opt_level == "O1" and not keep_norm_f32:
            raise ValueError("O1 keeps norms in fp32 (cf. frontend.py:125-131)")
        p = dataclasses.replace(p, keep_norm_f32=keep_norm_f32)
    if master_weights is not None:
        if opt_level == "O1" and master_weights:
            raise ValueError("O1 does not use master weights (cf. "
                             "frontend.py:118)")
        p = dataclasses.replace(p, master_weights=master_weights)
    return p


_tls = threading.local()


class with_policy:
    """Install ``policy`` as the ambient one for the block (or, as a
    decorator, for each call of the function). Nests; per thread."""

    def __init__(self, policy: Policy):
        self.policy = policy

    def __enter__(self) -> Policy:
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.policy)
        return self.policy

    def __exit__(self, *exc):
        _tls.stack.pop()
        return False

    def __call__(self, fn):
        def wrapped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return wrapped


def current_policy() -> Policy:
    """The innermost installed policy of this thread, else O0."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else O0
