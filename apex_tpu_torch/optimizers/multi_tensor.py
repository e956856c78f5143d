"""The chunked multi-tensor layout, as plain functions on tensors.

Port of ``apex_tpu/optimizers/multi_tensor.py``: every tensor of a tree is
packed into one ``(n_chunks, chunk_size)`` buffer in which it owns a whole
number of chunks (the tail zero-padded; a zero-size tensor still owns
one, ``:92``, ``:109``). Per-tensor reductions are a chunk reduction
followed by ``index_add_`` / ``scatter_reduce`` over ``chunk_to_tensor``;
per-tensor scalars broadcast back by one gather. The trees are the port's
containers (:mod:`apex_tpu_torch.utils.pytree`: dicts by sorted key,
lists and tuples by index), where the reference's are JAX pytrees.

The port's optimizers keep their state per tensor; this layout is what
the reference's chunked state (``fused_mixed_precision_lamb``) unpacks
from (:func:`apex_tpu_torch.models.convert.optimizer_state_from_jax`),
and the substrate a multi-tensor CUDA apply and ZeRO's flat shards would
share.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.optimizers._fused import global_norm as norm_of_all
from apex_tpu_torch.optimizers._fused import ieee_sqrt
from apex_tpu_torch.utils.pytree import tree_all_finite, tree_leaves, tree_map

Tree = Any

DEFAULT_CHUNK = 1024


def plan_layout(sizes, chunk_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(chunk_to_tensor i32[n_chunks], tensor_offsets i64[n_tensors]): the
    port's copy of ``apex_tpu/native.py:83-91``."""
    sizes = np.asarray(sizes, np.int64)
    chunk_counts = np.maximum(1, -(-sizes // chunk_size))
    c2t = np.repeat(np.arange(len(sizes), dtype=np.int32), chunk_counts)
    offsets = np.concatenate([[0], np.cumsum(chunk_counts)[:-1]]) * chunk_size
    return c2t, offsets.astype(np.int64)


class _Leaf:
    """A tensor's place in a tree's skeleton: its index in leaf order."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _skeleton(tree: Tree, counter: list) -> Tree:
    """``tree`` with each tensor replaced by its :class:`_Leaf`, numbered
    in :func:`tree_leaves`' order (a dict's keys sorted)."""
    if isinstance(tree, torch.Tensor):
        counter[0] += 1
        return _Leaf(counter[0] - 1)
    if isinstance(tree, dict):
        out = {k: _skeleton(tree[k], counter) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_skeleton(v, counter) for v in tree]
        return out if isinstance(tree, list) else type(tree)(out)
    return tree


def _fill(skeleton: Tree, leaves: list) -> Tree:
    if isinstance(skeleton, _Leaf):
        return leaves[skeleton.index]
    if isinstance(skeleton, dict):
        return {k: _fill(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        out = [_fill(v, leaves) for v in skeleton]
        return out if isinstance(skeleton, list) else type(skeleton)(out)
    return skeleton


@dataclasses.dataclass
class ChunkLayout:
    """How a tree packs into the chunked buffer: which tensor owns each
    chunk (int64, on the tree's device), the tree's skeleton, each
    tensor's shape, the chunk size."""

    chunk_to_tensor: torch.Tensor
    skeleton: Tree = None
    shapes: Tuple[Tuple[int, ...], ...] = ()
    chunk_size: int = DEFAULT_CHUNK

    @property
    def n_tensors(self) -> int:
        return len(self.shapes)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s)) for s in self.shapes)


def make_layout(tree: Tree, chunk_size: int = DEFAULT_CHUNK) -> ChunkLayout:
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(x.shape) for x in leaves)
    c2t, _ = plan_layout([int(np.prod(s)) for s in shapes], chunk_size)
    device = leaves[0].device if leaves else torch.device("cpu")
    return ChunkLayout(
        chunk_to_tensor=torch.from_numpy(c2t.astype(np.int64)).to(device),
        skeleton=_skeleton(tree, [0]), shapes=shapes, chunk_size=chunk_size)


def flatten_to_chunks(tree: Tree, layout: Optional[ChunkLayout] = None, *,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, ChunkLayout]:
    """Pack a tree into the ``(n_chunks, chunk_size)`` buffer, in ``dtype``
    (fp32 by default, the kernels' math type)."""
    if layout is None:
        layout = make_layout(tree)
    c = layout.chunk_size
    parts = []
    for x in tree_leaves(tree):
        flat = x.detach().reshape(-1).to(dtype)
        pad = (-flat.numel()) % c if flat.numel() else c
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        parts.append(flat)
    return torch.cat(parts).reshape(-1, c), layout


def unflatten_from_chunks(buf: torch.Tensor, layout: ChunkLayout,
                          like: Tree = None) -> Tree:
    """Unpack to the layout's tree; with ``like``, each leaf cast to the
    matching leaf's dtype."""
    flat = buf.reshape(-1)
    c = layout.chunk_size
    out, offset = [], 0
    for shape, size in zip(layout.shapes, layout.sizes):
        out.append(flat[offset:offset + size].reshape(shape))
        offset += max(1, -(-size // c)) * c
    if like is not None:
        out = [o.to(lk.dtype) for o, lk in zip(out, tree_leaves(like))]
    return _fill(layout.skeleton, out)


# --- per-tensor reductions over the chunked buffer ---------------------------

def per_tensor_sqnorm(buf: torch.Tensor, layout: ChunkLayout) -> torch.Tensor:
    """Every tensor's squared L2 norm: chunk partials, then ``index_add_``
    over the chunk-to-tensor map."""
    chunk_sq = (buf * buf).sum(dim=1)
    return chunk_sq.new_zeros(layout.n_tensors).index_add_(
        0, layout.chunk_to_tensor, chunk_sq)


def per_tensor_maxnorm(buf: torch.Tensor, layout: ChunkLayout) -> torch.Tensor:
    """Every tensor's infinity norm (NovoGrad's ``norm_type=0``)."""
    chunk_max = buf.abs().amax(dim=1)
    return chunk_max.new_zeros(layout.n_tensors).scatter_reduce_(
        0, layout.chunk_to_tensor, chunk_max, "amax", include_self=False)


def broadcast_per_tensor(vals: torch.Tensor,
                         layout: ChunkLayout) -> torch.Tensor:
    """Per-tensor scalars expanded to ``(n_chunks, 1)``."""
    return vals[layout.chunk_to_tensor][:, None]


def global_norm(buf: torch.Tensor) -> torch.Tensor:
    """The L2 norm of the whole buffer."""
    return norm_of_all([buf])


# --- tree-level multi-tensor ops (amp_C's surface) ---------------------------

def multi_tensor_scale(tree: Tree, scale: Union[float, torch.Tensor]
                       ) -> Tuple[Tree, torch.Tensor]:
    """An fp32 scaled copy and its all-finite flag (``amp_C.
    multi_tensor_scale``). Returns (scaled, all_finite)."""
    scaled = tree_map(lambda x: x.to(torch.float32) * scale, tree)
    return scaled, tree_all_finite(scaled)


def multi_tensor_axpby(x_tree: Tree, y_tree: Tree,
                       a: Union[float, torch.Tensor] = 1.0,
                       b: Union[float, torch.Tensor] = 1.0
                       ) -> Tuple[Tree, torch.Tensor]:
    """``a * x + b * y`` in fp32 and its all-finite flag (``amp_C.
    multi_tensor_axpby``)."""
    out = tree_map(lambda x, y: a * x.to(torch.float32)
                   + b * y.to(torch.float32), x_tree, y_tree)
    return out, tree_all_finite(out)


def multi_tensor_l2norm(tree: Tree, *, per_tensor: bool = False):
    """The global L2 norm, and with ``per_tensor`` every tensor's
    (``amp_C.multi_tensor_l2norm``)."""
    buf, layout = flatten_to_chunks(tree)
    sq = per_tensor_sqnorm(buf, layout)
    total = ieee_sqrt([sq.sum()])[0]
    if per_tensor:
        return total, ieee_sqrt([sq])[0]
    return total
