"""Fused mixed-precision LAMB as a ``torch.optim.Optimizer``.

Port of ``apex_tpu/optimizers/fused_mixed_precision_lamb.py:41-87``: the
model trains in bf16 or fp16 while the optimizer's state holds an fp32
``master`` of each tensor beside LAMB's fp32 moments, and LAMB's math
(:func:`~apex_tpu_torch.optimizers.fused_lamb.lamb_math`) runs on the
masters. Each model tensor lands where the reference's update puts it:
``old + (new_master.to(dtype) - old)`` in the model's dtype (``:78-79``),
two roundings.

The reference keeps its state in the chunked layout at chunk 1024
(``:53-60``) and sums its per-tensor norms chunk by chunk; the port keeps
its state per tensor (:func:`apex_tpu_torch.models.convert.
optimizer_state_from_jax` unpacks the reference's).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, lamb_math


class FusedMixedPrecisionLamb(FusedLAMB):
    """:class:`~apex_tpu_torch.optimizers.fused_lamb.FusedLAMB` over fp32
    masters kept in ``state[p]["master"]``, copied from the model tensors
    at their first step."""

    def _init_state(self, p, st) -> None:
        super()._init_state(p, st)
        st["master"] = p.detach().to(torch.float32, copy=True)

    def _update(self, group, params, g32, count, clipped) -> None:
        masters = [self.state[p]["master"] for p in params]
        new_m = lamb_math(group, masters, g32, *self._moments(params), count,
                          clipped)
        for p, m, n in zip(params, masters, new_m):
            m.copy_(n)
            p.add_(n.to(p.dtype) - p)
