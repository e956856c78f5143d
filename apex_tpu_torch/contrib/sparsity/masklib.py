"""2:4 structured-sparsity masks.

Port of ``apex_tpu/contrib/sparsity/masklib.py``: of every 4 consecutive
weights along the last (input) dimension keep the 2 of largest magnitude.
Ties rank by position, as the reference's stable argsort does (``:28-29``):
of equal magnitudes the later entries are kept.
"""

from __future__ import annotations

import torch


def mask_2to4_best(w: torch.Tensor) -> torch.Tensor:
    """Boolean mask keeping the 2 largest-|w| of every 4 along the last
    dim, which must be a multiple of 4."""
    *lead, n = w.shape
    if n % 4:
        raise ValueError(f"last dim ({n}) must be a multiple of 4 for 2:4 "
                         f"sparsity")
    g = w.abs().reshape(*lead, n // 4, 4)
    order = torch.argsort(g, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks >= 2).reshape(*lead, n)


def create_mask(w: torch.Tensor, pattern: str = "m4n2_1d") -> torch.Tensor:
    """``sparse_masklib.create_mask``'s surface: the 2:4 patterns (all
    computed as the best 2 of each 4 along the rows, as in the
    reference)."""
    if pattern in ("m4n2_1d", "m4n2_2d_best", "m4n2_2d_greedy"):
        return mask_2to4_best(w)
    if pattern == "unstructured":
        raise NotImplementedError("unstructured pruning is out of ASP scope")
    raise ValueError(f"unknown sparsity pattern {pattern!r}")
