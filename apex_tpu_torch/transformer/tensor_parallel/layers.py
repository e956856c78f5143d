"""Column/Row-parallel linears and the vocab-parallel embedding, at tp=1.

Port of ``apex_tpu/transformer/tensor_parallel/layers.py`` for the
single-device case: plain parameter-dict modules (``init`` → a dict of
tensors, ``__call__(params, x)``), weights stored ``(out, in)`` as in the
reference and ``nn.Linear``, so ``y = x @ W.T + b``; ``headwise`` gives
the head-batched projections the materialised-scores attention routes use
(plain ``torch.einsum``, as the reference leaves them to XLA). The sharded forms
(tp > 1, sequence parallelism, overlapped rings) are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F


def _default_init(generator: torch.Generator, shape, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in the last dim — the
    reference's ``_default_init`` distribution, drawn in fp32."""
    fan_in = shape[-1] if len(shape) > 1 else shape[0]
    bound = 1.0 / fan_in ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.uniform_(-bound, bound, generator=generator)
    return w.to(dtype)


@dataclasses.dataclass
class _Linear:
    """``y = x @ W.T + b``, W ``(output_size, input_size)``: the product
    both parallel linears compute at tp=1."""

    input_size: int
    output_size: int
    bias: bool = True

    def init(self, generator: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> Dict[str, torch.Tensor]:
        params = {"weight": _default_init(
            generator, (self.output_size, self.input_size), dtype, device)}
        if self.bias:
            params["bias"] = torch.zeros((self.output_size,), dtype=dtype,
                                         device=device)
        return params

    def __call__(self, params: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, params["weight"], params.get("bias"))


class ColumnParallelLinear(_Linear):
    """The output-sharded linear; at tp=1 the plain product."""

    def headwise(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                 groups: int) -> torch.Tensor:
        """Head-batched projection (``layers.py:170-186``): (b, s, H) →
        (b, groups, s, d) with the output features viewed as (groups,
        d)."""
        if self.output_size % groups:
            raise ValueError(f"output_size ({self.output_size}) must be "
                             f"divisible by groups ({groups})")
        d = self.output_size // groups
        w = params["weight"].reshape(groups, d, x.shape[-1])
        y = torch.einsum("bsH,gdH->bgsd", x, w)
        if "bias" in params:
            y = y + params["bias"].reshape(groups, 1, d)
        return y


class RowParallelLinear(_Linear):
    """The input-sharded linear; at tp=1 the plain product (the
    reference's all-reduce before the bias only exists across
    devices)."""

    def headwise(self, params: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
        """Head-batched output projection (``layers.py:250-265``): (b, h,
        s, d) with h·d the input features → (b, s, output), contracted
        over (heads, d), then the bias."""
        h, d = x.shape[1], x.shape[3]
        if h * d != self.input_size:
            raise ValueError(f"headwise input ({h}x{d}) != input features "
                             f"({self.input_size})")
        w = params["weight"].reshape(self.output_size, h, d)
        y = torch.einsum("bhsd,Hhd->bsH", x, w)
        if "bias" in params:
            y = y + params["bias"]
        return y


@dataclasses.dataclass
class VocabParallelEmbedding:
    """Token embedding; ids outside ``[0, num_embeddings)`` give ZERO
    vectors, never a clamped row (``layers.py:294-300``)."""

    num_embeddings: int
    embedding_dim: int

    def init(self, generator: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> Dict[str, torch.Tensor]:
        return {"weight": _default_init(
            generator, (self.num_embeddings, self.embedding_dim), dtype,
            device)}

    def __call__(self, params: Dict[str, torch.Tensor],
                 token_ids: torch.Tensor) -> torch.Tensor:
        valid = (token_ids >= 0) & (token_ids < self.num_embeddings)
        emb = params["weight"][torch.where(valid, token_ids, 0).long()]
        return emb.masked_fill(~valid[..., None], 0.0)
