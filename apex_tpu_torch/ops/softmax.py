"""The scaled masked softmax, with the probabilities-saving backward.

Port of ``apex_tpu/ops/softmax.py``: :func:`scaled_masked_softmax` (x
(b, np, sq, sk), a bool mask broadcastable to it, True = masked) and
:func:`scaled_upper_triang_masked_softmax` (the causal triangle built in
the kernel), over one ``torch.autograd.Function`` that saves y only
(``_softmax_core``, ``:44-68``): the backward is dx = scale * y * (dy -
sum(dy * y)). The scale is applied first and :data:`MASK_FILL` put on
masked entries second, exactly as ``_xla_fwd`` (``:31-41``) does, so a
fully masked row comes out uniform.

Dispatch follows :mod:`apex_tpu_torch.ops._backend`: on a CUDA tensor
:func:`softmax_fwd_cuda` and :func:`softmax_bwd_cuda` launch the
hand-written kernels of ``apex_tpu_torch/csrc/softmax.cu`` that replace
the Pallas ``softmax_fwd``/``softmax_bwd``; on a CPU tensor (or with
``impl="torch"``) the plain versions :func:`_torch_fwd` and
:func:`_torch_bwd` run. The kernels read the mask through its strides
(0 on every broadcast dimension); the reference materialises it at x's
shape first (``:90-91``). The backward is told the forward's mask (the
autograd core saves it beside y) and skips the masked entries where that
is exact (see :func:`_torch_bwd`). The reference's ``auto`` (XLA on its TPU
measurement) and its ``sk % 128`` kernel rule do not carry over: any sk
runs the kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch.ops import _backend, _build

#: the fill of masked scores (the reference's ``pallas/softmax.py:25``)
MASK_FILL = -10000.0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NO_MASK, _CAUSAL, _MASK = 0, 1, 2


# --- the plain versions -------------------------------------------------------

def _torch_fwd(x: torch.Tensor, mask: Optional[torch.Tensor],
               scale: float, causal: bool) -> torch.Tensor:
    """``_xla_fwd`` over the last axis of x (…, sq, sk), as
    :func:`softmax_fwd_cuda` takes it: fp32 softmax of the scaled scores
    with :data:`MASK_FILL` on masked entries (the triangle k > q when
    ``causal``, else ``mask`` broadcastable to x, True or nonzero =
    masked), in x's dtype."""
    xf = x.float() * scale
    if causal:
        sq, sk = x.shape[-2], x.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=x.device).tril()
        xf = torch.where(keep, xf, MASK_FILL)
    elif mask is not None:
        xf = torch.where(mask if mask.dtype == torch.bool else mask != 0,
                         MASK_FILL, xf)
    return torch.softmax(xf, dim=-1).to(x.dtype)


def _torch_bwd(dy: torch.Tensor, y: torch.Tensor,
               scale: float) -> torch.Tensor:
    """The explicit backward from the saved probabilities over the last
    axis, in fp32, cast to y's dtype, reading every entry.

    The kernel (:func:`softmax_bwd_cuda`, told the forward's mask) reads
    less. The forward gives every masked entry of a row the same y, 0 on a
    row with a live entry unless its live scaled scores all lie within
    about 90 of :data:`MASK_FILL`. The kernel reads one masked y of each
    row, the guard. Where the guard is 0, it skips the row's masked
    entries: their dx is 0 and they add nothing to the sum. Otherwise (a
    fully masked row, or such a row) it reads the row whole. So for finite
    dy the skip changes no bit of the kernel's dx but the sign of a zero.
    A non-finite dy at an entry whose y is exactly 0 gives NaN here and a
    finite row from the kernel."""
    yf, dyf = y.float(), dy.float()
    dx = scale * yf * (dyf - (dyf * yf).sum(dim=-1, keepdim=True))
    return dx.to(y.dtype)


# --- the kernels --------------------------------------------------------------

def _check_rows(name: str, *ts: torch.Tensor) -> None:
    x = ts[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the softmax kernels take float32 or bfloat16 "
                         f"scores; got {x.dtype} — pass impl='torch' for "
                         f"the plain version")
    for t in ts:
        if t.shape != x.shape or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors of one shape "
                             f"and dtype")
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"{name}: empty softmax axis")


def mask_view(mask: torch.Tensor, shape) -> torch.Tensor:
    """The bool mask as the kernel reads it: broadcast to x's ``shape`` as
    a view (0 strides on broadcast dimensions) and seen as (b, h, q, k)
    over x's rows — row r is (r // (h·q), r // q % h, r % q) — with
    leading 1s added, or extra leading dimensions folded (a copy only
    then)."""
    m = torch.broadcast_to(mask if mask.dtype == torch.bool else mask != 0,
                           shape)
    if m.ndim < 4:
        return m.reshape((1,) * (4 - m.ndim) + tuple(m.shape))
    if m.ndim > 4:
        return m.reshape(-1, *m.shape[-3:])
    return m


def _mask_args(name: str, x: torch.Tensor, mask: Optional[torch.Tensor],
               causal: bool):
    """Both kernels' mask arguments for scores shaped as ``x``: (mode,
    mask pointer, its four byte strides, heads, q_rows, sq, the mask view
    to keep alive through the launch)."""
    if causal and mask is not None:
        raise ValueError(f"{name}: causal takes no mask")
    if causal and x.ndim < 2:
        raise ValueError(f"{name}: causal needs (…, sq, sk)")
    sq = x.shape[-2] if x.ndim >= 2 else 1
    if causal:
        return _CAUSAL, None, None, 1, 1, sq, None
    if mask is None:
        return _NO_MASK, None, None, 1, 1, sq, None
    if mask.device != x.device:
        raise ValueError(f"{name}: the mask must be on x's device")
    m = mask_view(mask, x.shape)
    return (_MASK, m.data_ptr(), (ctypes.c_longlong * 4)(*m.stride()),
            m.shape[1], m.shape[2], sq, m)


def softmax_fwd_cuda(x: torch.Tensor, mask: Optional[torch.Tensor],
                     scale: float, causal: bool) -> torch.Tensor:
    """Launch the forward kernel over the last axis of ``x`` (…, sq, sk):
    causal (the triangle k <= q), or ``mask`` (broadcastable to x, True =
    masked) read through its strides, or neither. Counts its launches in
    ``.launches``."""
    _check_rows("softmax_fwd_cuda", x)
    mode, mptr, strides, heads, q_rows, sq, _m = _mask_args(
        "softmax_fwd_cuda", x, mask, causal)
    sk = x.shape[-1]
    rows = x.numel() // sk
    y = torch.empty_like(x)
    if rows == 0:
        return y
    rc = _build.library().apex_softmax_fwd(
        x.data_ptr(), y.data_ptr(), mptr, strides, heads, q_rows,
        _DTYPE_CODES[x.dtype], mode, rows, sk, sq, float(scale),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "softmax_fwd")
    softmax_fwd_cuda.launches += 1
    return y


softmax_fwd_cuda.launches = 0


def softmax_bwd_cuda(dy: torch.Tensor, y: torch.Tensor, scale: float, *,
                     causal: bool = False,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the backward kernel: dx = scale * y * (dy - sum(dy * y)) per
    row of the last axis, y from :func:`softmax_fwd_cuda` with the same
    ``causal`` and ``mask``. Told them, the kernel skips the masked
    entries of each row whose guard is 0 (see :func:`_torch_bwd`); with
    neither it reads every entry. Counts its launches in ``.launches``."""
    _check_rows("softmax_bwd_cuda", y, dy)
    mode, mptr, strides, heads, q_rows, sq, _m = _mask_args(
        "softmax_bwd_cuda", y, mask, causal)
    sk = y.shape[-1]
    rows = y.numel() // sk
    dx = torch.empty_like(y)
    if rows == 0:
        return dx
    rc = _build.library().apex_softmax_bwd(
        dy.data_ptr(), y.data_ptr(), dx.data_ptr(), mptr, strides, heads,
        q_rows, _DTYPE_CODES[y.dtype], mode, rows, sk, sq, float(scale),
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(rc, "softmax_bwd")
    softmax_bwd_cuda.launches += 1
    return dx


softmax_bwd_cuda.launches = 0


# --- the autograd core --------------------------------------------------------

class _SoftmaxCore(torch.autograd.Function):
    """``_softmax_core``: saves y, and the mask as the caller passed it
    (a (b, 1, 1, sk) key mask, a (1, 1, sq, sk) triangle) for the backward
    kernel's skip; an in-place edit of the mask between the two is
    caught."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal, use_kernel):
        x = x.contiguous()
        if use_kernel:
            y = softmax_fwd_cuda(x, mask, scale, causal)
        else:
            y = _torch_fwd(x, mask, scale, causal)
        ctx.save_for_backward(y, mask)
        ctx.scale, ctx.causal, ctx.use_kernel = scale, causal, use_kernel
        return y

    @staticmethod
    def backward(ctx, dy):
        y, mask = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.use_kernel:
            dx = softmax_bwd_cuda(dy, y, ctx.scale, causal=ctx.causal,
                                  mask=mask)
        else:
            dx = _torch_bwd(dy, y, ctx.scale)
        return dx, None, None, None, None


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0, *,
                          impl: str = "auto") -> torch.Tensor:
    """``ScaledMaskedSoftmax``: softmax over the last axis of x (b, np, sq,
    sk) of ``scale * x`` with masked entries (``mask`` broadcastable to x,
    True or nonzero = masked) set to :data:`MASK_FILL`."""
    return _SoftmaxCore.apply(x, mask, float(scale), False,
                              _backend.use_kernel(x, impl))


def scaled_upper_triang_masked_softmax(x: torch.Tensor, scale: float = 1.0,
                                       *, impl: str = "auto"
                                       ) -> torch.Tensor:
    """``ScaledUpperTriangMaskedSoftmax``: causal softmax over (…, sq, sk),
    key k kept for query q where k <= q."""
    return _SoftmaxCore.apply(x, None, float(scale), True,
                              _backend.use_kernel(x, impl))
