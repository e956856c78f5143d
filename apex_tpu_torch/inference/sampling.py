"""Token sampling for the decode engine's loop.

Port of ``apex_tpu/inference/sampling.py::sample_logits`` (``:31-71``), the
standalone sampler of the reference's ``DecodeEngine`` (its serving engines
run the fused kernel of :mod:`apex_tpu_torch.ops.sampling` instead). The
reference has no kernel here, and neither has the port: a few PyTorch ops
per step.

Greedy is the argmax. A sampled draw scales by ``1/temperature``, keeps
each row's ``top_k`` largest logits (ties at the k-th value kept), then
the nucleus — the minimal highest-probability set whose mass reaches
``top_p``, found by a descending sort and a cumulative sum — and draws by
Gumbel-argmax, ``argmax(s − log(−log u))``, which is what
``jax.random.categorical`` computes from its uniforms. ``u`` (b, V) in
(tiny, 1] is given, or drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.sampling import uniform_noise

#: masked-out logit value; finite, so an all-filtered row stays defined
_FILTERED = -1e30


def sample_logits(logits: torch.Tensor, *, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, V) logits → (b,) int32 token ids. ``temperature == 0`` is the
    greedy argmax (no noise). Otherwise the categorical draw over the
    temperature → top-k → top-p filtered logits, on ``u`` or on uniforms
    drawn from ``generator``."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if u is None:
        if generator is None:
            raise ValueError("temperature > 0 sampling requires a generator "
                             "(or the noise u)")
        u = uniform_noise(logits.shape, generator, logits.device)
    elif u.shape != logits.shape or u.dtype != torch.float32:
        raise ValueError(f"u must be float32 {tuple(logits.shape)}; got "
                         f"{u.dtype} {tuple(u.shape)}")
    scaled = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(scaled, min(top_k, scaled.shape[-1]),
                         dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, _FILTERED, scaled)
    if top_p < 1.0:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
        cut = torch.argmax((csum >= top_p).to(torch.int8), dim=-1)
        cutoff = desc.gather(-1, cut[..., None])
        scaled = torch.where(scaled < cutoff, _FILTERED, scaled)
    return torch.argmax(scaled - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)
