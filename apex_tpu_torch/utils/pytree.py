"""Tree helpers over the port's parameter containers.

The port keeps parameters, gradients and optimizer moments as nested
dicts, lists and tuples of tensors (``GPTModel.init``'s tree), where the
reference keeps JAX pytrees. This module holds the port's own copies of
what :mod:`apex_tpu.amp` needs from ``apex_tpu/utils/pytree.py``:
:func:`tree_cast` (``:22-36``) and :func:`tree_all_finite` (``:51-63``),
over those containers, plus the map and leaf walks they are built on, and
:func:`tree_paths` (the serving hot-swap's leaf-naming check). Leaves that
are not tensors (ints, bools, None) pass through every map.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``, which share its structure), rebuilding the containers;
    any other leaf is returned as it is."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensor leaves in a fixed depth-first order: a dict's by sorted
    key (``models.gpt.param_leaves``' order), a list's by index."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in tree_leaves(item)]
    return []


def tree_paths(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf (tensor or not) in
    :func:`tree_leaves`' order, the path written as the reference's
    ``jax.tree_util.keystr`` writes it: ``['layers'][0]['qkv']['weight']``.
    An empty container is a leaf of its own, so two trees with the same
    paths have the same structure up to the containers' types."""
    if isinstance(tree, dict) and tree:
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)) and tree:
        return [pl for i, item in enumerate(tree)
                for pl in tree_paths(item, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_cast(tree: Tree, dtype) -> Tree:
    """Every floating-point tensor leaf cast to ``dtype`` (``.to``: the
    same tensor where it already has it); integer and bool leaves, and
    everything that is not a tensor, left alone. ``dtype=None`` returns
    ``tree``."""
    if dtype is None:
        return tree
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_all_finite(tree: Tree) -> torch.Tensor:
    """True iff every element of every floating-point leaf is finite: a
    0-dim bool tensor on the leaves' device, with no host read (the
    reference's fused reduction; ``amp_C.multi_tensor_scale``'s inf/nan
    flag in apex). An integer leaf is always finite; a tree without
    tensor leaves gives a CPU True."""
    leaves = [t for t in tree_leaves(tree) if t.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()
