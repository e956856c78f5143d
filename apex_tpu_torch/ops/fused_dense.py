"""Fused dense layers: GEMM + bias and GEMM + bias + GELU + GEMM.

Port of ``apex_tpu/ops/fused_dense.py``: :func:`fused_dense` (``x @
weightᵀ + bias``, torch Linear's (out, in) weight) and
:func:`fused_dense_gelu_dense` (two Linears with a tanh-GELU between),
each one ``torch.autograd.Function`` with the reference's custom-VJP
contract — ``_dense_fwd``/``_dense_bwd`` (``:69-78``): ``dX = dY W``,
``dW = dYᵀ X``, ``db = Σ dY``; ``_dgd_fwd``/``_dgd_bwd`` (``:106-124``):
the forward saves ``x, w1, w2, h_pre, h`` and the backward applies the
GELU derivative to the saved pre-activation in fp32, cast to dh's dtype
before the product — and the ``nn.Module`` classes :class:`FusedDense`
and :class:`FusedDenseGeluDense` (``:160-210``).

Every product goes through :func:`_mm`: on a CUDA tensor the
hand-written kernel (:func:`apex_tpu_torch.ops.matmul.
matmul_bias_act_cuda`), on views of the operands (``weight.t()``,
``weight``, ``dy.t()``) and never a copy of an activation; on a CPU
tensor, or with ``impl="torch"``, the plain version. ``db`` is a plain
torch sum, outside any kernel as in the reference. The reference's
``auto`` picks XLA from a TPU measurement (``:146-155``); here ``auto`` on
a CUDA tensor is the kernel, and the reference's 128-multiple width rule
does not carry over: the kernel takes any width. Both functions apply
the O1 cast (``apply_op_rules("dense", ...)``) where the reference does;
outside O1 it is the identity.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from apex_tpu_torch.amp.lists import apply_op_rules
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.matmul import (_torch_matmul_bias_act,
                                       matmul_bias_act_cuda)


def _mm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
        activation: str = "none", use_kernel: bool = False,
        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(x @ w + b)`` for x (M, K), w (K, N): the kernel or the plain
    version."""
    if use_kernel:
        return matmul_bias_act_cuda(x, w, b, activation, out_dtype)
    return _torch_matmul_bias_act(x, w, b, activation, out_dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def _dgelu(x: torch.Tensor) -> torch.Tensor:
    """The derivative of the tanh-approximate GELU, matching the forward's
    approximation (the reference's ``:54-60``)."""
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x + 0.044715 * x ** 3))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c * (
        1.0 + 3 * 0.044715 * x * x)


# --- fused_dense: y = x @ weightᵀ + b -----------------------------------------

class _DenseCore(torch.autograd.Function):
    """``_dense_core``: saves x and the weight."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, use_kernel):
        ctx.save_for_backward(x2d, weight)
        ctx.use_kernel = use_kernel
        ctx.has_bias = bias is not None
        return _mm(x2d, weight.t(), bias, "none", use_kernel)

    @staticmethod
    def backward(ctx, dy):
        x2d, weight = ctx.saved_tensors
        k = ctx.use_kernel
        dx = _mm(dy, weight, use_kernel=k, out_dtype=x2d.dtype)
        dw = _mm(dy.t(), x2d, use_kernel=k, out_dtype=weight.dtype)
        db = dy.sum(0).to(weight.dtype) if ctx.has_bias else None
        return dx, dw, db, None


def fused_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                impl: str = "auto") -> torch.Tensor:
    """``fused_dense_function``: ``x @ weightᵀ + bias`` over x's last axis
    (weight (out, in)). HALF-class under an O1 policy."""
    x, weight, bias = apply_op_rules("dense", x, weight, bias)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    y = _DenseCore.apply(x2d, weight, bias, _backend.use_kernel(x, impl))
    return y.reshape(*lead, weight.shape[0])


# --- fused_dense_gelu_dense ---------------------------------------------------

class _DenseGeluDenseCore(torch.autograd.Function):
    """``_dgd_core``: saves (x, w1, w2, h_pre, h); two kernel launches
    forward, four backward."""

    @staticmethod
    def forward(ctx, x2d, w1, b1, w2, b2, use_kernel):
        h_pre = _mm(x2d, w1.t(), b1, "none", use_kernel)
        h = _gelu(h_pre)
        y = _mm(h, w2.t(), b2, "none", use_kernel)
        ctx.save_for_backward(x2d, w1, w2, h_pre, h)
        ctx.use_kernel = use_kernel
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, w1, w2, h_pre, h = ctx.saved_tensors
        k = ctx.use_kernel
        dh = _mm(dy, w2, use_kernel=k, out_dtype=h.dtype)
        dw2 = _mm(dy.t(), h, use_kernel=k, out_dtype=w2.dtype)
        db2 = dy.sum(0).to(w2.dtype)
        dh_pre = dh * _dgelu(h_pre.float()).to(dh.dtype)
        dx = _mm(dh_pre, w1, use_kernel=k, out_dtype=x2d.dtype)
        dw1 = _mm(dh_pre.t(), x2d, use_kernel=k, out_dtype=w1.dtype)
        db1 = dh_pre.sum(0).to(w1.dtype)
        return dx, dw1, db1, dw2, db2, None


def fused_dense_gelu_dense(x: torch.Tensor, weight1: torch.Tensor,
                           bias1: torch.Tensor, weight2: torch.Tensor,
                           bias2: torch.Tensor, *,
                           impl: str = "auto") -> torch.Tensor:
    """``FusedDenseGeluDenseFunc``: two Linears with a tanh-GELU between,
    saving the pre-GELU for backward. HALF-class under an O1 policy."""
    x, weight1, bias1, weight2, bias2 = apply_op_rules(
        "dense", x, weight1, bias1, weight2, bias2)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    y = _DenseGeluDenseCore.apply(x2d, weight1, bias1, weight2, bias2,
                                  _backend.use_kernel(x, impl))
    return y.reshape(*lead, weight2.shape[0])


# --- module wrappers ----------------------------------------------------------

def uniform_weight(shape, bound: float,
                   generator: Optional[torch.Generator],
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """U(-bound, bound) drawn in fp32 on the generator's device (the
    default generator's when None), then moved to ``device`` and
    ``dtype``: the same numbers on every device for one seed."""
    gdev = generator.device if generator is not None else "cpu"
    u = torch.rand(shape, generator=generator, device=gdev)
    return ((u * 2 - 1) * bound).to(device=device, dtype=dtype)


class FusedDense(nn.Module):
    """``apex.fused_dense.FusedDense``: ``weight`` (out, in) drawn from
    U(-1/√in, 1/√in) and ``bias`` zeros (the reference's ``init``), on
    ``device`` (default: the card)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, impl: str = "auto", *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.impl = impl
        dev = _backend.resolve_device(device)
        self.weight = nn.Parameter(uniform_weight(
            (out_features, in_features), 1.0 / math.sqrt(in_features),
            generator, dev, dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=dtype, device=dev)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense(x, self.weight, self.bias, impl=self.impl)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


class FusedDenseGeluDense(nn.Module):
    """``apex.fused_dense.FusedDenseGeluDense``: ``weight1`` (inter, in)
    from U(-1/√in, 1/√in), ``weight2`` (out, inter) from U(-1/√inter,
    1/√inter), biases zeros, on ``device`` (default: the card)."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, impl: str = "auto", *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = in_features
        self.intermediate_features = intermediate_features
        self.out_features = out_features
        self.impl = impl
        dev = _backend.resolve_device(device)
        self.weight1 = nn.Parameter(uniform_weight(
            (intermediate_features, in_features),
            1.0 / math.sqrt(in_features), generator, dev, dtype))
        self.bias1 = nn.Parameter(torch.zeros(
            intermediate_features, dtype=dtype, device=dev))
        self.weight2 = nn.Parameter(uniform_weight(
            (out_features, intermediate_features),
            1.0 / math.sqrt(intermediate_features), generator, dev, dtype))
        self.bias2 = nn.Parameter(torch.zeros(
            out_features, dtype=dtype, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense_gelu_dense(x, self.weight1, self.bias1,
                                      self.weight2, self.bias2,
                                      impl=self.impl)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, intermediate_features="
                f"{self.intermediate_features}, out_features="
                f"{self.out_features}")
