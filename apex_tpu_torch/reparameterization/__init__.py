"""Weight reparameterization (weight norm).

Port of ``apex_tpu/reparameterization/__init__.py`` (``:21-63``; upstream
``apex/reparameterization``, whose forward-pre hooks rebuild ``weight``
from (g, v)): :func:`weight_norm_decompose` splits a weight into (g, v),
:func:`weight_norm_compose` rebuilds ``w = g · v / ||v||``, and
:func:`apply_weight_norm` / :func:`remove_weight_norm` do so over the
port's nested dicts (and lists) of tensors, selecting leaves by the
reference's path names: keys and list indices joined by "/".
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

Tree = Any


def _axes(t: torch.Tensor, dim: int):
    return tuple(i for i in range(t.ndim) if i != dim % t.ndim)


def weight_norm_decompose(w: torch.Tensor, dim: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w → (g, v): g the norm of each slice along every axis but ``dim``
    (kept as size-1 axes), v = w."""
    g = torch.sqrt(torch.sum(w * w, dim=_axes(w, dim), keepdim=True))
    return g, w


def weight_norm_compose(g: torch.Tensor, v: torch.Tensor, dim: int = 0,
                        eps: float = 1e-12) -> torch.Tensor:
    """(g, v) → w = g · v / max(||v||, eps)."""
    norm = torch.sqrt(torch.sum(v * v, dim=_axes(v, dim), keepdim=True))
    return g * v / torch.clamp(norm, min=eps)


def _is_gv(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"g", "v"}


def apply_weight_norm(params: Tree,
                      select: Optional[Callable[[str], bool]] = None,
                      dim: int = 0) -> Tree:
    """Split each selected weight of rank >= 2 into a ``{"g", "v"}`` dict
    (default: every leaf whose path ends in "weight")."""
    select = select or (lambda name: name.endswith("weight"))

    def walk(x, path):
        if isinstance(x, dict):
            return {k: walk(v, path + [str(k)]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            out = [walk(v, path + [str(i)]) for i, v in enumerate(x)]
            return out if isinstance(x, list) else type(x)(out)
        if isinstance(x, torch.Tensor) and x.ndim >= 2 \
                and select("/".join(path)):
            g, v = weight_norm_decompose(x, dim)
            return {"g": g, "v": v}
        return x

    return walk(params, [])


def remove_weight_norm(params: Tree, dim: int = 0) -> Tree:
    """Recompose every ``{"g", "v"}`` dict into its plain weight."""
    if _is_gv(params):
        return weight_norm_compose(params["g"], params["v"], dim)
    if isinstance(params, dict):
        return {k: remove_weight_norm(v, dim) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        out = [remove_weight_norm(v, dim) for v in params]
        return out if isinstance(params, list) else type(params)(out)
    return params
