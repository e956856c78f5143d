"""``FusedScaleMaskSoftmax`` — the user-facing scale + mask + softmax module.

Port of ``apex_tpu/transformer/functional/fused_softmax.py:25-123`` as an
``nn.Module`` (the original apex class is one). It routes between the
fused ops of :mod:`apex_tpu_torch.ops.softmax` and a plain composition by
the reference's :meth:`FusedScaleMaskSoftmax.is_kernel_available`, kept
verbatim — ``sk % 128 == 0`` included, though the CUDA kernels take any
sk — because the route decides the fill of masked scores: -10000 on the
fused route, -1e30 or ``mask_func`` on the other, which differ on fully
masked rows.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.ops.softmax import (scaled_masked_softmax,
                                        scaled_upper_triang_masked_softmax)
from apex_tpu_torch.transformer.enums import AttnMaskType


class FusedScaleMaskSoftmax(nn.Module):
    """scale + mask + softmax over (b, np, sq, sk) attention scores, with
    the reference module's arguments: ``input_in_fp16`` /
    ``input_in_bf16`` (mutually exclusive; either enables the fused
    route), ``attn_mask_type`` (``causal`` builds the triangle in the
    kernel, ``padding`` applies the given mask), the
    ``scaled_masked_softmax_fusion`` opt-in, ``mask_func`` (the other
    route's masking, ``(scores, mask) -> masked``), ``softmax_in_fp32``
    (the other route's fp32 softmax for half inputs) and ``scale``
    (requires ``softmax_in_fp32``)."""

    def __init__(self, input_in_fp16: bool, input_in_bf16: bool,
                 attn_mask_type: AttnMaskType,
                 scaled_masked_softmax_fusion: bool,
                 mask_func: Optional[Callable], softmax_in_fp32: bool,
                 scale: Optional[float]):
        super().__init__()
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError(
                "both fp16 and bf16 flags cannot be active at the same time.")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if not (scale is None or softmax_in_fp32):
            raise RuntimeError("softmax should be in fp32 when scaled")
        if attn_mask_type not in (AttnMaskType.causal, AttnMaskType.padding):
            raise ValueError("Invalid attn_mask_type.")

    def forward(self, scores: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        assert scores.ndim == 4  # (b, np, sq, sk)
        if self.is_kernel_available(mask, *scores.shape):
            return self.forward_fused_softmax(scores, mask)
        return self.forward_torch_softmax(scores, mask)

    def is_kernel_available(self, mask, b, nh, sq, sk) -> bool:
        """The reference's rule, verbatim: the user opted in, half-precision
        input, ``sk % 128 == 0``, and a mask or the causal type; causal
        also needs square scores."""
        if self.attn_mask_type == AttnMaskType.causal and sq != sk:
            return False
        return bool(
            self.scaled_masked_softmax_fusion
            and self.input_in_float16
            and sk % 128 == 0
            and (mask is not None or self.attn_mask_type == AttnMaskType.causal)
        )

    def forward_fused_softmax(self, scores, mask):
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type == AttnMaskType.causal:
            return scaled_upper_triang_masked_softmax(scores, scale)
        return scaled_masked_softmax(scores, mask, scale)

    def forward_torch_softmax(self, scores, mask):
        """The other route, with the reference's dtype handling: fp32
        softmax for half inputs when asked, cast back after."""
        orig = scores.dtype
        if self.input_in_float16 and self.softmax_in_fp32:
            scores = scores.float()
        if self.scale is not None:
            scores = scores * self.scale
        if mask is not None:
            # mask_func when given, as the reference calls it whenever a
            # mask is present; a mask is never dropped
            if self.mask_func is not None:
                scores = self.mask_func(scores, mask)
            else:
                scores = torch.where(mask.bool(), -1e30, scores)
        if self.attn_mask_type == AttnMaskType.causal:
            # top-left alignment: row r sees columns <= r
            sq, sk = scores.shape[-2], scores.shape[-1]
            keep = (torch.arange(sk, device=scores.device)[None, :]
                    <= torch.arange(sq, device=scores.device)[:, None])
            scores = torch.where(keep, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(orig)
        return probs
