"""Fused Conv + Bias (+ Mask) + ReLU.

Port of ``apex_tpu/contrib/conv_bias_relu/__init__.py`` (``:19-45``;
upstream ``apex/contrib/conv_bias_relu/conv_bias_relu.py:7-76``, whose
cudnn-frontend graphs fuse the epilogue into the convolution). The
reference leaves the composition to XLA, which fuses it; here the
convolution is ``F.conv2d`` on NHWC activations (a ``channels_last``
NCHW view, cuDNN's NHWC path) and the epilogue is eager PyTorch. No
Pallas kernel is involved.

x is NHWC, as in the reference; the weight is PyTorch's (out, in, kh, kw)
(``models.convert`` transposes the reference's HWIO). ``padding`` takes
the reference's values: ``"SAME"`` is XLA's SAME — the output is
ceil(in / stride) and the total padding is split with the extra row or
column at the bottom or right, so a stride-2 3x3 on an even input pads
(0, 1), not torchvision's (1, 1) — ``"VALID"``, or explicit
``((top, bottom), (left, right))`` pairs.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.resnet import nchw

Padding = Union[str, Sequence[Tuple[int, int]]]


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_pads(x_hw: Tuple[int, int], k_hw: Tuple[int, int], stride: int,
              padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) of ``padding`` for an input of
    spatial size ``x_hw`` and a kernel of ``k_hw``."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "SAME":
            return (_same_pads(x_hw[0], k_hw[0], stride),
                    _same_pads(x_hw[1], k_hw[1], stride))
        if mode == "VALID":
            return (0, 0), (0, 0)
        raise ValueError(f"padding must be 'SAME', 'VALID' or "
                         f"((top, bottom), (left, right)); got {padding!r}")
    (t, b), (lft, r) = padding
    return (int(t), int(b)), (int(lft), int(r))


def _conv(x: torch.Tensor, weight: torch.Tensor, stride: int,
          padding: Padding) -> torch.Tensor:
    (t, b), (lft, r) = conv_pads((x.shape[1], x.shape[2]),
                                 (weight.shape[2], weight.shape[3]), stride,
                                 padding)
    xn = nchw(x)
    if t or b or lft or r:
        xn = F.pad(xn, (lft, r, t, b))
    return F.conv2d(xn, weight, stride=stride).permute(0, 2, 3, 1)


def conv_bias(x, weight, bias, stride: int = 1, padding: Padding = "SAME"):
    """``ConvBias`` (``conv_bias_relu.py:30-44``)."""
    return _conv(x, weight, stride, padding) + bias


def conv_bias_relu(x, weight, bias, stride: int = 1,
                   padding: Padding = "SAME"):
    """``ConvBiasReLU`` (``conv_bias_relu.py:7-28``)."""
    return torch.relu(conv_bias(x, weight, bias, stride, padding))


def conv_bias_mask_relu(x, weight, bias, mask, stride: int = 1,
                        padding: Padding = "SAME"):
    """``ConvBiasMaskReLU`` (``conv_bias_relu.py:46-62``): an elementwise
    mask before the ReLU."""
    return torch.relu(conv_bias(x, weight, bias, stride, padding) * mask)


def conv_frozen_scale_bias_relu(x, weight, scale, bias, stride: int = 1,
                                padding: Padding = "SAME"):
    """``ConvFrozenScaleBiasReLU`` (``conv_bias_relu.py:64-76``): a frozen
    batch norm's affine folded into the epilogue."""
    return torch.relu(_conv(x, weight, stride, padding) * scale + bias)
