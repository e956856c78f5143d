"""Casting helpers of the legacy fp16 API, over the port's parameter trees.

Port of ``apex_tpu/fp16_utils/fp16util.py:1-93``. :func:`network_to_half`
casts every floating leaf of a tree (dicts, lists, tuples);
:func:`convert_network` does the same but keeps fp32 every leaf whose key
path, lowercased, contains one of :data:`BN_CONVERT_EXEMPT` (``:20-26``).
The port's key path joins its tree's keys and list indices with ``/``;
the reference's joins JAX's key entries, whose brackets and quotes hold no
letter, so on the same model (the port's per-layer tree against the
reference's stacked one) each leaf gets the same decision.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Tuple

import torch

from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

Tree = Any

# key-path substrings treated as normalization parameters (kept fp32)
BN_CONVERT_EXEMPT = ("bn", "batchnorm", "batch_norm", "ln", "layernorm",
                     "norm", "scale")


def _is_exempt(path: Tuple[str, ...], exempt: Iterable[str]) -> bool:
    name = "/".join(path).lower()
    return any(e in name for e in exempt)


def _map_with_path(fn: Callable, tree: Tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A detached copy in ``dtype`` that requires grad where ``x`` did."""
    return x.detach().to(dtype).requires_grad_(x.requires_grad)


def network_to_half(params: Tree, dtype: torch.dtype = torch.bfloat16
                    ) -> Tree:
    """Every floating leaf cast to ``dtype``."""
    return tree_map(lambda x: _cast(x, dtype) if x.is_floating_point()
                    else x, params)


def convert_network(params: Tree, dtype: torch.dtype = torch.bfloat16,
                    exempt: Iterable[str] = BN_CONVERT_EXEMPT) -> Tree:
    """Every floating leaf cast to ``dtype`` except the normalization
    parameters (their key path names one of ``exempt``), which stay as
    they are."""
    def cast(path, x):
        if not x.is_floating_point() or _is_exempt(path, exempt):
            return x
        return _cast(x, dtype)
    return _map_with_path(cast, params)


def prep_param_lists(params: Tree) -> Tuple[Tree, Tree]:
    """(model params, fp32 master copies)."""
    return params, tree_map(lambda x: x.detach().to(torch.float32,
                                                    copy=True), params)


@torch.no_grad()
def master_params_to_model_params(model: Tree, master: Tree) -> Tree:
    """Copy each master into its model tensor, in place (rounded to the
    model's dtype). Returns ``model``."""
    for mo, ma in zip(tree_leaves(model), tree_leaves(master)):
        mo.copy_(ma)
    return model


def model_grads_to_master_grads(model_grads: Tree) -> Tree:
    """fp32 copies of (half) model gradients."""
    return tree_map(lambda g: g.to(torch.float32, copy=True), model_grads)


def to_python_float(x) -> float:
    return float(x.item()) if isinstance(x, torch.Tensor) else float(x)


class FP16Model:
    """A half-precision model: ``apply_fn(params, *inputs, **kwargs)``
    over :func:`convert_network`'s params (normalization parameters kept
    fp32), each floating tensor among the inputs and keyword arguments
    cast to ``dtype`` first (``:73-83``)."""

    def __init__(self, apply_fn: Callable, params: Tree,
                 dtype: torch.dtype = torch.bfloat16,
                 exempt: Iterable[str] = BN_CONVERT_EXEMPT):
        self.apply_fn = apply_fn
        self.params = convert_network(params, dtype, exempt)
        self.dtype = dtype

    def __call__(self, *inputs, **kwargs):
        def cast(x):
            return x.to(self.dtype) if x.is_floating_point() else x

        return self.apply_fn(self.params, *tree_map(cast, list(inputs)),
                             **tree_map(cast, kwargs))
