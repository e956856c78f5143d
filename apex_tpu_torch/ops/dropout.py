"""Counter-hash elementwise dropout: GPT's residual and probability dropout.

Port of ``apex_tpu/models/gpt.py::_dropout`` (``:883-900``), which XLA
computes in the reference: the keep mask is the flash kernels' counter
hash, :func:`apex_tpu_torch.ops.attention.dropout_keep`, with t = 0, the
rows all leading dims flattened and the columns the last dim; a kept
element is divided by (1 − rate) ROUNDED TO x's DTYPE (JAX's weak typing
rounds the Python float to bf16 for a bf16 x: 3 / bf16(0.9) = 3.34375, not
3 / 0.9), in fp32, then rounded to x's dtype; a dropped one is 0. The
gradient is the same function of the cotangent with the same seed (the
VJP of a division by a constant). The mask is never stored: the backward
and a recompute under remat rebuild it from the seed.

:func:`dropout` is the autograd entry. A CUDA tensor launches
:func:`dropout_cuda` (``csrc/dropout.cu``, forward and backward alike); a
CPU tensor, or ``impl="torch"``, runs :func:`dropout_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _backend, _build
from apex_tpu_torch.ops.attention import (_M32, dropout_keep,
                                          dropout_threshold)

#: the dtypes the kernel takes
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: the fault the kernel plants on request, for the chip checks to refuse:
#: kept elements multiplied by float32(1/(1 - rate)) instead of divided by
#: (1 - rate) in x's dtype
PLANTED_FAULTS = ("fp32_scale",)


def divisor(rate: float, dtype: torch.dtype) -> float:
    """1 - rate rounded to ``dtype`` (as a float): the divisor of a kept
    element."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def dropout_plain(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """where(keep, x / (1 - rate in x's dtype), 0) in x's dtype. The
    divisor is a 0-dim tensor on x's device: a CPU scalar would send a CUDA
    division through x * (1/d), another rounding."""
    n = x.shape[-1]
    rows = torch.arange(x.numel() // n, device=x.device)[:, None]
    cols = torch.arange(n, device=x.device)[None, :]
    keep = dropout_keep(seed, 0, rows, cols, rate).reshape(x.shape)
    d = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / d, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def dropout_cuda(x: torch.Tensor, rate: float, seed: int, *,
                 backward: bool = False,
                 planted_fault: Optional[str] = None) -> torch.Tensor:
    """Launch the dropout kernel on a contiguous fp32 or bf16 CUDA tensor:
    a new tensor of x's shape. ``backward`` only picks the counter: the
    forward and the backward are one function. Counts its launches in
    ``.launches``, ``.fwd_launches`` and ``.bwd_launches``."""
    if x.device.type != "cuda":
        raise ValueError("dropout_cuda takes CUDA tensors")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"dropout_cuda takes {KERNEL_DTYPES}; got "
                         f"{x.dtype}" + (
                             " (fp16 in dropout.cu and the flash kernels' "
                             "kDrop instances: ROADMAP queue 2, item 6)"
                             if x.dtype == torch.float16 else ""))
    if x.ndim < 1 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError(f"dropout_cuda takes a contiguous non-empty tensor "
                         f"of rank >= 1; got {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    if planted_fault is not None and planted_fault not in PLANTED_FAULTS:
        raise ValueError(f"planted_fault must be one of {PLANTED_FAULTS}; "
                         f"got {planted_fault!r}")
    n = x.shape[-1]
    if x.numel() // n >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("dropout_cuda: rows and columns must be < 2^31")
    y = torch.empty_like(x)
    inv = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    rc = _build.library().apex_dropout(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
        x.numel(), n, int(seed) & _M32, dropout_threshold(rate),
        divisor(rate, x.dtype), inv, int(planted_fault is not None),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "dropout")
    dropout_cuda.launches += 1
    if backward:
        dropout_cuda.bwd_launches += 1
    else:
        dropout_cuda.fwd_launches += 1
    return y


dropout_cuda.launches = 0
dropout_cuda.fwd_launches = 0
dropout_cuda.bwd_launches = 0


def _apply(x: torch.Tensor, rate: float, seed: int, impl: str,
           backward: bool) -> torch.Tensor:
    if _backend.use_kernel(x, impl):
        return dropout_cuda(x.contiguous(), rate, seed, backward=backward)
    return dropout_plain(x, rate, seed)


class _Dropout(torch.autograd.Function):
    """Forward and backward are the same masked division; only the seed is
    kept."""

    @staticmethod
    def forward(ctx, x, rate, seed, impl):
        ctx.drop = (rate, seed, impl)
        return _apply(x, rate, seed, impl, False)

    @staticmethod
    def backward(ctx, dy):
        rate, seed, impl = ctx.drop
        return _apply(dy, rate, seed, impl, True), None, None, None


def dropout(x: torch.Tensor, rate: float, seed, *,
            impl: str = "auto") -> torch.Tensor:
    """Counter-hash dropout of ``x`` (``gpt.py::_dropout``) with the int32
    ``seed`` (an int, or a one-element int tensor read once on the host):
    differentiable, the mask rebuilt from the seed in the backward. A rate
    of 0 returns x."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return x
    return _Dropout.apply(x, float(rate), int(seed), impl)
