"""ResNet-50 v1.5, NHWC, with batch norm — the reference's north-star model.

Port of ``apex_tpu/models/resnet.py`` (``:27-153``): the torchvision
layout (the stride 2 in the 3x3 conv), apex's ``examples/imagenet``
model. Activations are NHWC, as in the reference: a contiguous (N, H, W,
C) tensor's ``permute(0, 3, 1, 2)`` is a ``channels_last`` NCHW tensor
without a copy, so ``F.conv2d`` takes cuDNN's NHWC path and every batch
norm sees its input as an (N·H·W, C) row-major matrix, the layout of
``csrc/batch_norm.cu``.

The convolutions stay ``F.conv2d``, as the reference leaves them to XLA,
with the symmetric ``k // 2`` padding (``:43-53``: XLA's "SAME" would pad a
stride-2 3x3 by (0, 1)), and no amp cast: the reference casts none, so
under O1 the convolutions run in the input's dtype. Batch norm is
:func:`apex_tpu_torch.parallel.sync_batchnorm.sync_batch_norm` at one
process, with the bottleneck's residual add and ReLU as its epilogue
(``bn_c``) and ``bn_proj`` without a ReLU (``:113-131``). The max pool pads
with -inf (``F.max_pool2d(3, 2, 1)``), the head is the spatial mean and
``h @ fc_w.T + fc_b``.

Parameters are the port's layout: conv weights (out, in, kh, kw) where the
reference keeps HWIO, ``fc_w`` (classes, in) where it keeps (in, classes);
:mod:`apex_tpu_torch.models.convert` moves trees between the two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _backend
from apex_tpu_torch.parallel.sync_batchnorm import (BatchNormState,
                                                    sync_batch_norm)

Layers50 = (3, 4, 6, 3)
#: the bottleneck widths of the four stages (out = 4 × these)
STAGE_WIDTHS = (64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    width: int = 64
    layers: Tuple[int, ...] = Layers50
    bn_axis: Optional[str] = None
    bn_momentum: float = 0.1
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.bn_axis is not None:
            raise TypeError(
                "ResNetConfig(bn_axis=) is batch norm over a process group, "
                "which comes with the multi-GPU surface (ROADMAP queue 1, "
                "item 6)")


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` as the NCHW tensor ``F.conv2d`` takes: on the card its
    ``channels_last`` view (no copy; cuDNN's NHWC path), on the CPU a
    contiguous copy — PyTorch's CPU (oneDNN) backward of a strided 1x1
    convolution on a ``channels_last`` input returns wrong weight
    gradients from its third call on, and can crash the process."""
    xn = x.permute(0, 3, 1, 2)
    return xn if x.device.type == "cuda" else xn.contiguous()


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """NHWC ``x`` (N, H, W, C) through ``w`` (out, in, kh, kw): NHWC out,
    symmetric ``k // 2`` padding by default (torchvision's)."""
    if padding is None:
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    y = F.conv2d(nchw(x), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_shape(cin: int, cout: int, k: int) -> Tuple[int, int, int, int]:
    return (cout, cin, k, k)


def block_shapes(cin: int, ch: int, cout: int, proj: bool) -> Dict:
    """One bottleneck's parameter shapes, the port's layout."""
    out: Dict[str, Any] = {
        "conv_a": conv_shape(cin, ch, 1), "conv_b": conv_shape(ch, ch, 3),
        "conv_c": conv_shape(ch, cout, 1),
        "bn_a": {"scale": (ch,), "bias": (ch,)},
        "bn_b": {"scale": (ch,), "bias": (ch,)},
        "bn_c": {"scale": (cout,), "bias": (cout,)}}
    if proj:
        out["conv_proj"] = conv_shape(cin, cout, 1)
        out["bn_proj"] = {"scale": (cout,), "bias": (cout,)}
    return out


def init_block(shapes: Dict, generator: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> Tuple[Dict, Dict]:
    """A bottleneck's (params, state) for :func:`block_shapes`' shapes:
    kaiming-normal (fan out) convs, BN scale 1 and bias 0, fresh running
    statistics; drawn in fp32 from ``generator``, then cast."""
    params, state = {}, {}
    for name, shape in shapes.items():
        if name.startswith("conv"):
            params[name] = conv_init(shape, generator, dtype, device)
        else:
            ch = shape["scale"][0]
            params[name] = {
                "scale": torch.ones((ch,), dtype=dtype, device=device),
                "bias": torch.zeros((ch,), dtype=dtype, device=device)}
            state[name] = BatchNormState.create(ch, device=device)
    return params, state


def conv_init(shape, generator, dtype, device) -> torch.Tensor:
    """kaiming-normal, fan out (torchvision's ResNet init): std
    sqrt(2 / (out · kh · kw))."""
    std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device) * std
    return w.to(dtype)


def bottleneck(p: Dict, st: Dict, x: torch.Tensor, stride: int,
               training: bool, momentum: float = 0.1,
               impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """1x1 → 3x3 (``stride``) → 1x1 with BN + ReLU epilogues, the
    projection's BN without a ReLU, and ``bn_c``'s fused residual add and
    ReLU (``:113-131``). Returns (h, new_state)."""
    def bn(name, h, residual=None, relu=True):
        return sync_batch_norm(h, p[name]["scale"], p[name]["bias"],
                               st[name], training=training,
                               momentum=momentum, fuse_relu=relu,
                               residual=residual, impl=impl)

    new_st = {}
    identity = x
    h = conv_nhwc(x, p["conv_a"])
    h, new_st["bn_a"] = bn("bn_a", h)
    h = conv_nhwc(h, p["conv_b"], stride)
    h, new_st["bn_b"] = bn("bn_b", h)
    h = conv_nhwc(h, p["conv_c"])
    if "conv_proj" in p:
        identity = conv_nhwc(x, p["conv_proj"], stride)
        identity, new_st["bn_proj"] = bn("bn_proj", identity, relu=False)
    h, new_st["bn_c"] = bn("bn_c", h, residual=identity)
    return h, new_st


class ResNet50:
    """Functional ResNet-v1.5: :meth:`init` → (params, state),
    :meth:`apply` → (logits, new_state)."""

    def __init__(self, config: ResNetConfig = ResNetConfig()):
        self.config = config

    def blocks(self):
        """(name, stride, in, width, out) of every bottleneck, in order."""
        c = self.config
        in_ch = c.width
        for si, (n, ch) in enumerate(zip(c.layers, STAGE_WIDTHS)):
            for bi in range(n):
                yield (f"s{si}b{bi}", 2 if (bi == 0 and si > 0) else 1,
                       in_ch, ch, ch * 4)
                in_ch = ch * 4

    def bn_calls(self, batch: int, image: int):
        """(rows, channels, residual, relu, spatial) of every batch norm of
        :meth:`apply` on (batch, image, image, 3) images, in order."""
        hw = image // 2
        calls = [(batch * hw * hw, self.config.width, False, True, hw)]
        hw //= 2
        for name, stride, _, ch, cout in self.blocks():
            calls.append((batch * hw * hw, ch, False, True, hw))
            hw //= stride
            m = batch * hw * hw
            calls.append((m, ch, False, True, hw))
            if name.endswith("b0"):
                calls.append((m, cout, False, False, hw))
            calls.append((m, cout, True, True, hw))
        return calls

    def param_shapes(self) -> Dict:
        """Every parameter's shape, the port's layout (no tensor made)."""
        c = self.config
        shapes: Dict[str, Any] = {
            "conv1": conv_shape(3, c.width, 7),
            "bn1": {"scale": (c.width,), "bias": (c.width,)}}
        in_ch = c.width
        for name, _, cin, ch, cout in self.blocks():
            shapes[name] = block_shapes(cin, ch, cout, name.endswith("b0"))
            in_ch = cout
        shapes["fc_w"] = (c.num_classes, in_ch)
        shapes["fc_b"] = (c.num_classes,)
        return shapes

    def init(self, generator: torch.Generator,
             device: Optional[Union[str, torch.device]] = None
             ) -> Tuple[Dict, Dict]:
        """Random (params, state) with the reference's distributions: convs
        kaiming-normal (fan out), BN scale 1 and bias 0, ``fc_w`` N(0,
        0.01²), ``fc_b`` 0; drawn in fp32 from ``generator`` (which must
        live on ``device``), then cast to the config's dtype."""
        c = self.config
        dev = _backend.resolve_device(device)
        shapes = self.param_shapes()
        params: Dict[str, Any] = {}
        state: Dict[str, Any] = {}
        params["conv1"] = conv_init(shapes["conv1"], generator, c.dtype, dev)
        params["bn1"] = {
            "scale": torch.ones((c.width,), dtype=c.dtype, device=dev),
            "bias": torch.zeros((c.width,), dtype=c.dtype, device=dev)}
        state["bn1"] = BatchNormState.create(c.width, device=dev)
        for name, *_ in self.blocks():
            params[name], state[name] = init_block(shapes[name], generator,
                                                   c.dtype, dev)
        fc = torch.randn(shapes["fc_w"], generator=generator,
                         dtype=torch.float32, device=dev) * 0.01
        params["fc_w"] = fc.to(c.dtype)
        params["fc_b"] = torch.zeros(shapes["fc_b"], dtype=c.dtype,
                                     device=dev)
        return params, state

    def apply(self, params: Dict, state: Dict, x: torch.Tensor, *,
              training: bool = True, impl: str = "auto"
              ) -> Tuple[torch.Tensor, Dict]:
        """x: (N, H, W, 3) NHWC. Returns (logits, new_state)."""
        c = self.config
        new_state: Dict[str, Any] = {}
        h = conv_nhwc(x, params["conv1"], stride=2)
        h, new_state["bn1"] = sync_batch_norm(
            h, params["bn1"]["scale"], params["bn1"]["bias"], state["bn1"],
            training=training, momentum=c.bn_momentum, fuse_relu=True,
            impl=impl)
        h = F.max_pool2d(nchw(h), 3, 2, 1).permute(0, 2, 3, 1)
        for name, stride, *_ in self.blocks():
            h, new_state[name] = bottleneck(
                params[name], state[name], h, stride, training,
                c.bn_momentum, impl)
        h = h.mean(dim=(1, 2))
        logits = h @ params["fc_w"].t() + params["fc_b"]
        return logits, new_state
