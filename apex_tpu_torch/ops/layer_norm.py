"""LayerNorm as the serving path runs it: the plain composition.

Port of ``apex_tpu/ops/layer_norm.py::fused_layer_norm`` as its ``auto``
dispatch resolves (``_ln_auto`` picks the XLA composition ``_xla_fwd``,
``:44-59``): statistics in fp32, the affine in fp32, one cast back to the
input dtype. The Pallas ``ln_fwd``/``ln_bwd`` kernels sit behind
``impl="pallas"`` only, so no kernel replaces them on this path.
"""

from __future__ import annotations

from typing import Optional

import torch


def fused_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim; computes in fp32, returns ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
