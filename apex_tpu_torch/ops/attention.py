"""The packed q|k|v projection and the attention output projection.

Port of ``apex_tpu/ops/attention.py::bshd_qkv_projection`` /
``bshd_output_projection`` (``:406-429``): the ONE place the packed weight
layout lives — features ordered q-heads | k-heads | v-heads, weights stored
``(out, in)``. The flash-attention kernels of that module are later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def bshd_qkv_projection(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], h: int, h_kv: int,
                        d: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(b, s, H) through the packed ((h + 2·h_kv)·d, H) weight → q
    (b, s, h, d), k/v (b, s, h_kv, d)."""
    b, s = x.shape[0], x.shape[1]
    y = F.linear(x, weight, bias)
    q = y[..., :h * d].reshape(b, s, h, d)
    k = y[..., h * d:(h + h_kv) * d].reshape(b, s, h_kv, d)
    v = y[..., (h + h_kv) * d:].reshape(b, s, h_kv, d)
    return q, k, v


def bshd_output_projection(ctx: torch.Tensor, weight: torch.Tensor, h: int,
                           d: int) -> torch.Tensor:
    """(b, s, h, d) context through the (O, h·d) output weight → (b, s, O)."""
    b, s = ctx.shape[0], ctx.shape[1]
    return F.linear(ctx.reshape(b, s, h * d), weight)
