"""Fused MLP: a stack of Linear + bias + activation layers in one call.

Port of ``apex_tpu/ops/mlp.py``: :func:`mlp` over torch-Linear (out, in)
weights with the activation (``none``, ``relu`` or ``sigmoid``) after
every layer, the last one included, and the ``nn.Module`` :class:`MLP`
(``:114-148``). Two routes, as the reference's custom VJP has them:

* with autograd recording (a grad-requiring input or parameter), one
  ``torch.autograd.Function`` with ``_mlp_fwd``/``_mlp_bwd``'s contract
  (``:51-75``): each layer's product without activation, the activation
  eager, the pre- and post-activations saved; the backward multiplies by
  the activation's derivative and runs two products a layer (dW and dX,
  the first layer's dX included), with ``db`` a plain torch sum;
* otherwise ``_mlp_core``'s primal (``:42-48``): each layer ONE product
  with the bias and the activation in the kernel's epilogue.

Products go through :func:`apex_tpu_torch.ops.fused_dense._mm`: the
hand-written kernel on a CUDA tensor, the plain version on a CPU tensor
or with ``impl="torch"``. The reference's pallas route requires every
width to be a multiple of 128 (``:99-104``); the kernel takes any width.
The O1 cast (``apply_op_rules("mlp", ...)``) applies where the
reference's does; outside O1 it is the identity.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch.amp.lists import apply_op_rules
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.fused_dense import _mm, uniform_weight

MLP_ACTIVATIONS = ("none", "relu", "sigmoid")


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(h)
    if activation == "sigmoid":
        return torch.sigmoid(h)
    if activation == "none":
        return h
    raise ValueError(f"mlp activation must be none|relu|sigmoid, got "
                     f"{activation!r}")


def _dact(h_pre: torch.Tensor, h_post: torch.Tensor,
          activation: str) -> torch.Tensor:
    if activation == "relu":
        return (h_pre > 0).to(h_pre.dtype)
    if activation == "sigmoid":
        return h_post * (1.0 - h_post)
    return torch.ones_like(h_pre)


class _MLPCore(torch.autograd.Function):
    """``_mlp_fwd``/``_mlp_bwd``: saves the layers' inputs and
    pre-activations; params flat as (w0, b0, w1, b1, ...)."""

    @staticmethod
    def forward(ctx, x2d, activation, use_kernel, *params):
        h = x2d
        pres: List[torch.Tensor] = []
        posts: List[torch.Tensor] = [x2d]
        for i in range(len(params) // 2):
            pre = _mm(h, params[2 * i].t(), params[2 * i + 1], "none",
                      use_kernel)
            h = _act(pre, activation)
            pres.append(pre)
            posts.append(h)
        ctx.save_for_backward(*params, *pres, *posts)
        ctx.activation, ctx.use_kernel = activation, use_kernel
        ctx.n = len(pres)
        return h

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        n = ctx.n
        params, pres, posts = saved[:2 * n], saved[2 * n:3 * n], saved[3 * n:]
        dparams: List[Optional[torch.Tensor]] = [None] * (2 * n)
        g = dy
        for i in reversed(range(n)):
            g = g * _dact(pres[i], posts[i + 1], ctx.activation)
            w = params[2 * i]
            dparams[2 * i] = _mm(g.t(), posts[i], use_kernel=ctx.use_kernel,
                                 out_dtype=w.dtype)
            dparams[2 * i + 1] = g.sum(0).to(w.dtype)
            g = _mm(g, w, use_kernel=ctx.use_kernel,
                    out_dtype=posts[i].dtype)
        return (g, None, None, *dparams)


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor], activation: str = "relu", *,
        impl: str = "auto") -> torch.Tensor:
    """Functional MLP over x's last axis; weights (out, in), the
    activation after every layer including the last (``mlp_cuda``'s
    semantics). HALF-class under an O1 policy (apex registers MLP as a
    half function): the whole chain runs in the compute dtype."""
    cast = apply_op_rules("mlp", x, *weights, *biases)
    x, weights, biases = (cast[0], cast[1:1 + len(weights)],
                          cast[1 + len(weights):])
    if activation not in MLP_ACTIVATIONS:
        raise ValueError(f"mlp activation must be none|relu|sigmoid, got "
                         f"{activation!r}")
    if len(weights) != len(biases) or not weights:
        raise ValueError("mlp takes one bias per weight, at least one layer")
    use_kernel = _backend.use_kernel(x, impl)
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1])
    params = [t for wb in zip(weights, biases) for t in wb]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (h, *params)):
        h = _MLPCore.apply(h, activation, use_kernel, *params)
    else:
        for w, b in zip(weights, biases):
            h = _mm(h, w.t(), b, activation, use_kernel)
    return h.reshape(*lead, h.shape[-1])


class MLP(nn.Module):
    """``apex.mlp.MLP``: ``mlp_sizes`` is [in, h1, ..., out]; ``weight_i``
    (out, in) from U(-1/√in, 1/√in) and ``bias_i`` zeros (the reference's
    ``init``), on ``device`` (default: the card). ``bias=False`` raises
    ``NotImplementedError`` as the reference does."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", impl: str = "auto", *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(mlp_sizes) < 2:
            raise ValueError("mlp_sizes must have at least 2 entries")
        if not bias:
            raise NotImplementedError(
                "bias-less MLP: pass zero biases (kept for API parity; the "
                "reference also requires bias for the fused path, mlp.py:35)")
        self.mlp_sizes = tuple(int(s) for s in mlp_sizes)
        self.activation = activation
        self.impl = impl
        dev = _backend.resolve_device(device)
        for i, (din, dout) in enumerate(zip(self.mlp_sizes[:-1],
                                            self.mlp_sizes[1:])):
            self.register_parameter(f"weight_{i}", nn.Parameter(
                uniform_weight((dout, din), 1.0 / math.sqrt(din), generator,
                               dev, dtype)))
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.zeros(
                dout, dtype=dtype, device=dev)))

    @property
    def num_layers(self) -> int:
        return len(self.mlp_sizes) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.num_layers
        return mlp(x, [getattr(self, f"weight_{i}") for i in range(n)],
                   [getattr(self, f"bias_{i}") for i in range(n)],
                   self.activation, impl=self.impl)

    def extra_repr(self) -> str:
        return f"mlp_sizes={list(self.mlp_sizes)}, activation=" \
               f"{self.activation!r}"
