"""The fused ResNet bottleneck.

Port of ``apex_tpu/contrib/bottleneck/__init__.py``'s :class:`Bottleneck`
(``:84-142``; upstream ``apex/contrib/bottleneck/bottleneck.py:112``): 1x1
→ 3x3 (stride) → 1x1 convolutions, each followed by batch norm with a
ReLU, the projection's without, and the last one's residual add and ReLU
fused into its epilogue — the block of :mod:`apex_tpu_torch.models.resnet`
(:func:`~apex_tpu_torch.models.resnet.bottleneck`), whose batch norms run
``csrc/batch_norm.cu`` on the card. NHWC activations; conv weights in
PyTorch's (out, in, kh, kw).

``SpatialBottleneck``, ``halo_exchange`` and ``spatial_conv3x3``
(``:24-82``, ``:145-155``) split H over a process group and come with the
multi-GPU surface (ROADMAP queue 1, item 6); so does ``spatial_axis``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from apex_tpu_torch.models.resnet import block_shapes, bottleneck, init_block
from apex_tpu_torch.ops import _backend


class Bottleneck:
    """One bottleneck block: :meth:`init` → (params, state), a call →
    (h, new_state). A projection (1x1 conv and batch norm) exists when the
    stride is not 1 or the channel counts differ."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1):
        self.in_channels = in_channels
        self.bottleneck_channels = bottleneck_channels
        self.out_channels = out_channels
        self.stride = stride

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             device: Optional[Union[str, torch.device]] = None
             ) -> Tuple[Dict, Dict]:
        """Random (params, state): kaiming-normal (fan out) convs, batch
        norm scale 1 and bias 0, fresh running statistics; drawn in fp32
        from ``generator`` (on ``device``), then cast to ``dtype``."""
        proj = (self.stride != 1 or self.in_channels != self.out_channels)
        shapes = block_shapes(self.in_channels, self.bottleneck_channels,
                              self.out_channels, proj)
        return init_block(shapes, generator, dtype,
                          _backend.resolve_device(device))

    def __call__(self, params: Dict, state: Dict, x: torch.Tensor, *,
                 training: bool = True, spatial_axis: Optional[str] = None,
                 impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
        if spatial_axis is not None:
            raise TypeError(
                "Bottleneck(spatial_axis=) splits H over a process group, "
                "which comes with the multi-GPU surface (ROADMAP queue 1, "
                "item 6)")
        return bottleneck(params, state, x, self.stride, training,
                          impl=impl)
