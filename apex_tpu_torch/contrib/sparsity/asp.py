"""ASP: the masks and the optimizer that keeps them.

Port of ``apex_tpu/contrib/sparsity/asp.py`` (``apex.contrib.sparsity.ASP``,
``asp.py:28-312``): compute a mask tree from the weights, apply it, and
wrap the optimizer so the pruned entries are exactly 0 after every step.
The reference wraps an optax transformation so the update of a pruned
entry is -w (``:103-127``); here the wrapper steps the torch optimizer and
then zeroes the pruned entries in place, which leaves the same weights.

The port's models keep one tensor per layer where the reference's stack
the layers, so a search over a model's own tree permutes each layer's
weight on its own (ROADMAP's deliberate divergences).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from apex_tpu_torch.contrib.sparsity.masklib import create_mask
from apex_tpu_torch.contrib.sparsity.permutation import (
    apply_permutation,
    search_for_good_permutation,
)
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

Tree = Any


def _default_eligible(path: str, w: torch.Tensor) -> bool:
    """The reference's eligibility (``asp.py:100-130``): weights of 2 or
    more dims whose last dim is a multiple of 4; biases and norms stay
    dense."""
    return w.ndim >= 2 and w.shape[-1] % 4 == 0


def _map_with_path(fn: Callable, tree: Tree, *rest: Tree,
                   path: tuple = ()) -> Tree:
    """``fn(name, leaf, *rest_leaves)`` over the tensor leaves, the name
    written as the reference's ``"/".join(str(k) for k in key_path)``:
    ``['layers']/[0]/['qkv']/['weight']``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (f"[{k!r}]",))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, *(r[i] for r in rest),
                              path=path + (f"[{i}]",))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    if isinstance(tree, torch.Tensor):
        return fn("/".join(path), tree, *rest)
    return tree


class _MaskedOptimizer:
    """A torch optimizer whose ``step`` is followed by zeroing every
    pruned entry of its parameters; everything else is the optimizer's."""

    def __init__(self, opt: torch.optim.Optimizer, pairs):
        self.opt = opt
        self.pairs = pairs  # (parameter, its boolean mask)

    def step(self, closure=None):
        loss = self.opt.step(closure)
        with torch.no_grad():
            for p, m in self.pairs:
                p.masked_fill_(~m, 0)
        return loss

    def __getattr__(self, name):
        return getattr(self.opt, name)


class ASP:
    """Functional ASP::

        asp = ASP()
        masks = asp.compute_sparse_masks(params)     # the prune decision
        params = asp.apply_masks(params, masks)      # pruned weights
        opt = asp.wrap_optimizer(FusedAdam(param_leaves(params)), masks)
    """

    def __init__(self, pattern: str = "m4n2_1d",
                 eligible: Callable[[str, Any], bool] = _default_eligible):
        self.pattern = pattern
        self.eligible = eligible

    def compute_sparse_masks(self, params: Tree) -> Tree:
        """A mask tree of params' structure: boolean masks for eligible
        weights, a 0-dim True for the others (``asp.py:177-229``)."""
        def mk(name, w):
            if self.eligible(name, w):
                return create_mask(w, self.pattern)
            return torch.ones((), dtype=torch.bool, device=w.device)
        return _map_with_path(mk, params)

    def apply_masks(self, params: Tree, masks: Tree) -> Tree:
        """New tensors: each weight with its pruned entries 0."""
        return tree_map(lambda w, m: torch.where(
            m, w, torch.zeros((), dtype=w.dtype, device=w.device)),
            params, masks)

    def search_permutations(self, params: Tree) -> Tree:
        """Per eligible weight, an input-channel permutation that raises
        its 2:4 retention (identity where the search finds no gain, and
        for the other leaves); numpy arrays in params' structure. Wiring a
        permutation to its neighbours is the caller's: permute this
        weight's inputs with ``perm`` and the producer's outputs with
        ``invert_permutation(perm)`` (:meth:`permute_params`)."""
        def search(name, w):
            if not self.eligible(name, w):
                return np.arange(w.shape[-1]) if w.ndim else np.arange(1)
            perm, improvement = search_for_good_permutation(
                w.reshape(-1, w.shape[-1]))
            return perm if improvement > 0 else np.arange(w.shape[-1])
        return _map_with_path(search, params)

    def permute_params(self, params: Tree, perms: Tree) -> Tree:
        """The input-channel permutations of :meth:`search_permutations`
        applied."""
        return _permute(params, perms)

    def wrap_optimizer(self, opt: torch.optim.Optimizer, masks: Tree):
        """``opt`` with every step followed by zeroing the pruned entries
        (``asp.py:231-259``): ``masks`` is the mask tree of the params
        ``opt`` steps, its leaves in ``tree_leaves`` order the optimizer's
        parameters in order (``FusedAdam(param_leaves(params))``)."""
        params = [p for group in opt.param_groups for p in group["params"]]
        leaves = tree_leaves(masks)
        if len(leaves) != len(params):
            raise ValueError(f"{len(leaves)} masks for the optimizer's "
                             f"{len(params)} parameters")
        pairs = []
        for p, m in zip(params, leaves):
            if m.ndim == 0:
                continue
            if m.shape != p.shape or m.device != p.device:
                raise ValueError(f"a mask of shape {tuple(m.shape)} on "
                                 f"{m.device} for a parameter of "
                                 f"{tuple(p.shape)} on {p.device}")
            pairs.append((p, m))
        return _MaskedOptimizer(opt, pairs)


def _permute(params: Tree, perms: Tree) -> Tree:
    if isinstance(params, dict):
        return {k: _permute(v, perms[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        out = [_permute(v, p) for v, p in zip(params, perms)]
        return out if isinstance(params, list) else type(params)(out)
    if isinstance(params, torch.Tensor) and params.ndim:
        return apply_permutation(params, perms, axis=-1)
    return params
