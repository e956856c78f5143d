"""FMHA: the fused multi-head attention core over packed rows.

Port of ``apex_tpu/contrib/fmha/__init__.py`` (``apex.contrib.fmha``,
``apex/contrib/fmha/fmha.py:33-76``):

* :func:`fmha_varlen` (``FMHAFun.apply(qkv, cu_seqlens, p_dropout, max_s,
  is_training)`` of the reference): token-packed ``(total, 3, h, d)`` qkv
  over variable-length rows with ``cu_seqlens`` boundaries, scattered into
  the padded seq-major ``(b, max_s, 3, h, d)`` layout, run on the bshd
  flash kernels with per-batch ``kv_lens`` (rows never attend across a
  boundary) and the kernels' counter-hash probs dropout, gathered back.
* :func:`fmha` / :class:`FMHAFun` — the equal-length padded ``(b, s, 3, h,
  d)`` layout on the bh-flat kernels; :class:`FMHA` the module over the
  packed layout.

``max_s`` is checked against ``cu_seqlens`` on every call (one host read
of the boundaries): the port's tensors are always concrete, where the
reference checks only outside ``jit`` (``:63-71``) — a deliberate
divergence (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from apex_tpu_torch.ops.attention import flash_attention, key_seed

Key = Optional[Union[torch.Generator, int, torch.Tensor]]


def _unpack_indices(cu_seqlens: torch.Tensor, total: int):
    """(segment id, position within the segment) of each packed token
    (``_unpack_indices``, ``:29-34``)."""
    tok = torch.arange(total, dtype=torch.int64, device=cu_seqlens.device)
    cu = cu_seqlens.long()
    seg = torch.searchsorted(cu[1:], tok, right=True)
    return seg, tok - cu[seg]


def _dropout_seed(rate: float, key: Key, what: str) -> Optional[int]:
    if rate == 0.0:
        return None
    if key is None:
        raise ValueError(f"{what} > 0 with is_training needs a key (a "
                         f"torch.Generator or an int32 seed)")
    return key_seed(key)


def fmha_varlen(qkv: torch.Tensor, cu_seqlens: torch.Tensor, max_s: int,
                p_dropout: float = 0.0, is_training: bool = True,
                causal: bool = False, key: Key = None, *,
                impl: str = "auto") -> torch.Tensor:
    """qkv ``(total, 3, h, d)`` packed over the rows of ``cu_seqlens``
    ``(b + 1,)`` (row r holds tokens ``[cu_seqlens[r], cu_seqlens[r +
    1])``), ``max_s`` the padded length → ``(total, h, d)``
    (``fmha_varlen``, ``:37-98``). Dropout (``p_dropout`` > 0 with
    ``is_training``) needs ``key``. Raises when ``max_s`` is shorter than
    a row (the scatter would drop its tail). ``impl`` as
    :func:`~apex_tpu_torch.ops.attention.flash_attention`'s."""
    if qkv.ndim != 4 or qkv.shape[1] != 3:
        raise ValueError(f"qkv must be (total, 3, h, d); got "
                         f"{tuple(qkv.shape)}")
    if cu_seqlens.ndim != 1 or cu_seqlens.shape[0] < 2:
        raise ValueError(f"cu_seqlens must be (batch + 1,); got "
                         f"{tuple(cu_seqlens.shape)}")
    total, _, h, d = qkv.shape
    b = cu_seqlens.shape[0] - 1
    cu = cu_seqlens.to(torch.int32)
    lens = torch.diff(cu)
    longest = int(lens.max())
    if longest > max_s:
        raise ValueError(
            f"max_s ({max_s}) is smaller than the longest row ({longest}): "
            f"the padded-layout scatter would drop that row's tokens past "
            f"max_s")
    seg, pos = _unpack_indices(cu, total)
    padded = qkv.new_zeros((b, max_s, 3, h, d)).index_put((seg, pos), qkv)
    rate = float(p_dropout) if is_training else 0.0
    seed = _dropout_seed(rate, key, "p_dropout")
    o = flash_attention(padded[:, :, 0], padded[:, :, 1], padded[:, :, 2],
                        causal=causal, layout="bshd", kv_lens=lens,
                        dropout_rate=rate, dropout_seed=seed, impl=impl)
    return o[seg, pos]


class FMHAFun:
    """The reference's autograd-function call shape over the equal-length
    padded layout (``:101-114``)."""

    @staticmethod
    def apply(qkv: torch.Tensor, causal: bool = False) -> torch.Tensor:
        """qkv ``(b, s, 3, h, d)`` → ``(b, s, h, d)``; varlen batches take
        :func:`fmha_varlen`."""
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return flash_attention(q, k, v, causal=causal).transpose(1, 2)


def fmha(qkv: torch.Tensor, causal: bool = False) -> torch.Tensor:
    return FMHAFun.apply(qkv, causal)


class FMHA(nn.Module):
    """The reference's ``FMHA`` module (``:121-139``) over the packed
    varlen layout: ``(total, 3·h·d)`` flat or ``(total, 3, h, d)``. No
    parameters."""

    def __init__(self, num_heads: int, head_dim: int, p_dropout: float = 0.0,
                 causal: bool = False):
        super().__init__()
        self.h, self.d = num_heads, head_dim
        self.p_dropout = p_dropout
        self.causal = causal

    def forward(self, qkv: torch.Tensor, cu_seqlens: torch.Tensor,
                max_s: int, is_training: bool = True,
                key: Key = None) -> torch.Tensor:
        total = qkv.shape[0]
        o = fmha_varlen(qkv.reshape(total, 3, self.h, self.d), cu_seqlens,
                        max_s, self.p_dropout, is_training,
                        causal=self.causal, key=key)
        return o.reshape(total, self.h * self.d)
