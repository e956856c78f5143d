"""Channel-permutation search for 2:4 structured sparsity.

Port of ``apex_tpu/contrib/sparsity/permutation.py``: permuting a weight's
input channels before its 2:4 mask can raise the magnitude the mask keeps.
Two searches, as in the reference: a greedy descent that scores every
column swap at once each sweep and applies the best (any C), and an
exhaustive search over the canonical stripe assignments (C <= 8).

Swapping column i (stripe a) with j (stripe b) changes only stripes a and
b. Per row, stripe a's kept sum with i replaced by j is t2 + relu(|w_j| -
s2), t2 the top-2 sum of the stripe's three other columns and s2 their
second largest; summed over rows this is a (C, C) matrix M[i, j] = sum_r
relu(|w[r, j]| - s2[r, i]). The reference builds the (R, C, C) broadcast
and reduces it, which XLA fuses (``_swap_improvements``, ``:72-108``);
eager PyTorch would hold it whole (68 GB at GPT-medium's ``mlp_down``), so
here M is accumulated over row chunks of at most :data:`CHUNK_ELEMS`
elements. The reference rebuilds M every sweep; a swap of columns i and j
changes only the 8 columns of their two stripes, so the greedy search
builds M once and then, each sweep, swaps M's columns i and j and
recomputes the rows of those 8 columns (R x 8 x C instead of R x C x C:
the same sums, each entry summed over the rows as a full rebuild sums
it).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

GROUP = 4  # 2:4 sparsity operates on stripes of 4 input channels
#: the (rows, C, C) broadcast's elements at most per chunk (256 MB fp32)
CHUNK_ELEMS = 1 << 26


def sum_after_2_to_4(matrix: torch.Tensor) -> torch.Tensor:
    """Total magnitude a 2:4 mask of ``matrix`` (rows x cols) keeps: the
    search's objective (``permutation_utilities.py:49-81``)."""
    r, c = matrix.shape
    g = matrix.abs().reshape(r, c // GROUP, GROUP)
    return torch.topk(g, 2, dim=-1).values.sum()


def _relu_cross_sum(w: torch.Tensor, s2: torch.Tensor,
                    chunk_rows: Optional[int] = None) -> torch.Tensor:
    """M[i, j] = sum_r relu(w[r, j] - s2[r, i]) for (R, C) ``w`` and (R,
    K) ``s2``, a (K, C) matrix accumulated over chunks of ``chunk_rows``
    rows (default: as many as hold CHUNK_ELEMS elements of the
    broadcast)."""
    r, c = w.shape
    k = s2.shape[1]
    if chunk_rows is None:
        chunk_rows = max(1, CHUNK_ELEMS // (k * c))
    m = torch.zeros((k, c), dtype=w.dtype, device=w.device)
    buf = torch.empty((min(chunk_rows, r), k, c), dtype=w.dtype,
                      device=w.device)
    for r0 in range(0, r, chunk_rows):
        r1 = min(r, r0 + chunk_rows)
        b = buf[:r1 - r0]
        torch.sub(w[r0:r1, None, :], s2[r0:r1, :, None], out=b)
        m += b.clamp_(min=0).sum(0)
    return m


def _stripe_stats(w: torch.Tensor):
    """For (R, 4k) magnitudes: per (row, column) the top-2 sum (t2) and
    the 2nd largest (s2) of the three other columns of its stripe, and
    its stripe's kept (top-2) sum."""
    r, c = w.shape
    g = w.reshape(r, c // GROUP, GROUP)
    idx = torch.tensor([[k for k in range(GROUP) if k != d]
                        for d in range(GROUP)], device=w.device)
    others = torch.sort(g[:, :, idx], dim=-1, descending=True).values
    t2 = (others[..., 0] + others[..., 1]).reshape(r, c)
    s2 = others[..., 1].reshape(r, c)
    ret = torch.topk(g, 2, dim=-1).values.sum(-1)
    return t2, s2, ret.repeat_interleave(GROUP, dim=1)


def _delta(m: torch.Tensor, t2s: torch.Tensor,
           r_i: torch.Tensor) -> torch.Tensor:
    """The swap scores from M and the column sums of t2 and of each
    column's stripe retention; -inf for two columns of one stripe."""
    c = m.shape[0]
    delta = (t2s[:, None] + m) + (t2s[None, :] + m.T) \
        - r_i[:, None] - r_i[None, :]
    stripe = torch.arange(c, device=m.device) // GROUP
    return torch.where(stripe[:, None] == stripe[None, :],
                       torch.full((), -torch.inf, device=m.device), delta)


def _swap_improvements(matrix: torch.Tensor,
                       chunk_rows: Optional[int] = None) -> torch.Tensor:
    """(C, C) matrix of retention deltas for swapping columns i and j;
    -inf for two columns of one stripe."""
    w = matrix.abs().float()
    t2, s2, ret = _stripe_stats(w)
    return _delta(_relu_cross_sum(w, s2, chunk_rows), t2.sum(0),
                  ret.sum(0))


def greedy_swap_search(matrix: torch.Tensor, *, max_sweeps: int = 256,
                       tol: float = 1e-6) -> Tuple[np.ndarray, float]:
    """Greedy best-swap descent: each sweep scores all C^2 swaps and
    applies the best, until none gains more than ``tol`` or
    ``max_sweeps``. M is built once and kept current (module docstring).
    Returns (permutation, improvement)."""
    c = matrix.shape[1]
    perm = np.arange(c)
    w = matrix.abs().float()
    t2, s2, ret = _stripe_stats(w)
    m = _relu_cross_sum(w, s2)
    t2s, r_i = t2.sum(0), ret.sum(0)
    improvement = 0.0
    for _ in range(max_sweeps):
        delta = _delta(m, t2s, r_i)
        flat = int(torch.argmax(delta))
        gain = float(delta.reshape(-1)[flat])
        if not np.isfinite(gain) or gain <= tol:
            break
        i, j = divmod(flat, c)
        perm[[i, j]] = perm[[j, i]]
        w[:, [i, j]] = w[:, [j, i]]
        m[:, [i, j]] = m[:, [j, i]]
        cols = torch.cat([torch.arange(GROUP * (x // GROUP),
                                       GROUP * (x // GROUP + 1))
                          for x in (i, j)]).to(w.device)
        t2c, s2c, retc = _stripe_stats(w[:, cols])
        s2[:, cols] = s2c
        t2s[cols] = t2c.sum(0)
        r_i[cols] = retc.sum(0)
        m[cols] = _relu_cross_sum(w, s2c)
        improvement += gain
    return perm, improvement


def _canonical_group_assignments(c: int) -> List[np.ndarray]:
    """Every column-to-stripe assignment up to the order inside a stripe
    and of the stripes (column 0 pinned to the first stripe)."""
    perms: List[np.ndarray] = []

    def rec(remaining, groups):
        if not remaining:
            perms.append(np.array([col for grp in groups for col in grp]))
            return
        first, rest = remaining[0], remaining[1:]
        for combo in itertools.combinations(rest, GROUP - 1):
            rec([x for x in rest if x not in combo],
                groups + [(first,) + combo])

    rec(list(range(c)), [])
    return perms


def exhaustive_search(matrix: torch.Tensor) -> Tuple[np.ndarray, float]:
    """Every canonical permutation scored at once (C <= 8 in practice);
    returns the best and its improvement."""
    r, c = matrix.shape
    cands = np.stack(_canonical_group_assignments(c))
    w = matrix.float()
    g = w[:, torch.as_tensor(cands, device=w.device)].abs()  # (R, P, C)
    g = g.reshape(r, len(cands), c // GROUP, GROUP)
    scores = torch.topk(g, 2, dim=-1).values.sum(dim=(0, 2, 3))
    best = int(torch.argmax(scores))
    return cands[best], float(scores[best]) - float(sum_after_2_to_4(w))


def search_for_good_permutation(matrix: torch.Tensor, *,
                                max_sweeps: int = 256
                                ) -> Tuple[np.ndarray, float]:
    """An input-channel permutation of ``matrix`` (rows, C) that raises
    its 2:4 retention: exhaustive at C <= 8, greedy above. Returns
    (permutation, retention improvement)."""
    c = matrix.shape[1]
    if c % GROUP:
        raise ValueError(f"column count {c} not a multiple of {GROUP}")
    if c <= 8:
        return exhaustive_search(matrix)
    return greedy_swap_search(matrix, max_sweeps=max_sweeps)


def apply_permutation(w: torch.Tensor, perm: np.ndarray, *,
                      axis: int = -1) -> torch.Tensor:
    """``w`` permuted along ``axis`` (the input-channel dim)."""
    return torch.index_select(w, axis, torch.as_tensor(
        np.asarray(perm), dtype=torch.long, device=w.device))


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv
