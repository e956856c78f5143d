"""Fused LayerNorm / RMSNorm with the saved-statistics backward.

Port of ``apex_tpu/ops/layer_norm.py``: :func:`fused_layer_norm` and
:func:`fused_rms_norm` over any trailing ``normalized_shape`` (viewed as
(rows, hidden)), one ``torch.autograd.Function`` with the contract of
``_norm_core`` (``:84-115``) — the forward returns y in x's dtype and
saves x, gamma and the fp32 per-row mean and rstd; the backward is
``_xla_bwd``'s formula (``:62-81``) with dgamma and dbeta reduced in fp32,
then cast to the parameters' dtype — and the ``nn.Module`` classes
:class:`FusedLayerNorm`, :class:`FusedRMSNorm` and the ``Mixed*``
aliases (``:190-233``).

Dispatch follows :mod:`apex_tpu_torch.ops._backend`: on a CUDA tensor the
forward launches :func:`ln_fwd_cuda` on :func:`_fwd_plan`'s shape and the
backward :func:`ln_bwd_cuda`, the hand-written kernels of
``apex_tpu_torch/csrc/layer_norm.cu`` that replace the Pallas
``ln_fwd``/``ln_bwd``; on a CPU tensor (or with
``impl="torch"``) the plain versions :func:`_torch_fwd` and
:func:`_torch_bwd`, copies of the reference's ``_xla_fwd``/``_xla_bwd``.
The reference's ``auto`` picks its XLA composition over the kernel from a
TPU measurement (``:147-157``); here no knob picks the composition on the
card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.amp.lists import apply_op_rules
from apex_tpu_torch.ops import _backend, _build
from apex_tpu_torch.ops.matmul import _sm_count

#: the kernels' dtype codes, of x and of the parameters: fp16 x takes fp16
#: or fp32 parameters, fp32 and bf16 x fp32 or bf16 ones
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest row the kernels hold in registers (32 lanes x 128 elements)
KERNEL_MAX_HIDDEN = 4096
#: the backward's partial-sum rows: at most this many CTAs, each owning a
#: fixed set of rows, so dgamma/dbeta are summed in one fixed order
BWD_MAX_CTAS = 256
#: the forward's rows of a group in flight, by 16-byte chunks a thread
#: (``fwd_depth`` in ``csrc/layer_norm.cu``: the registers a thread holds)
FWD_DEPTH = {1: 2, 2: 2, 4: 1}
#: a forward CTA's warps at most, and the warps an SM holds at the
#: kernel's launch bounds, by chunks a thread: 16 of 32 at one chunk (64
#: registers a thread), 8 of 16 at more (128 registers)
FWD_CTA_WARPS = {1: 16, 2: 8, 4: 8}
FWD_SM_WARPS = {1: 32, 2: 16, 4: 16}

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _normalized_size(normalized_shape) -> int:
    if isinstance(normalized_shape, int):
        return normalized_shape
    return math.prod(int(s) for s in normalized_shape)


# --- the plain versions (the reference's XLA path) ----------------------------

def _torch_fwd(x2d: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float, rms: bool) -> Stats:
    """``_xla_fwd``: two-pass fp32 statistics; (y, mean, rstd) with y in
    x's dtype and mean/rstd (rows, 1) fp32."""
    xf = x2d.float()
    if rms:
        mean = torch.zeros((xf.shape[0], 1), dtype=torch.float32,
                           device=xf.device)
        xc = xf
    else:
        mean = xf.mean(dim=1, keepdim=True)
        xc = xf - mean
    var = (xc * xc).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2d.dtype), mean, rstd


def _torch_bwd(dy2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
               rstd: torch.Tensor, weight: Optional[torch.Tensor],
               rms: bool):
    """``_xla_bwd``: (dx in x's dtype, dgamma, dbeta) with the parameter
    gradients fp32 (None without ``weight``)."""
    dy = dy2d.float()
    xf = x2d.float()
    xhat = xf * rstd if rms else (xf - mean) * rstd
    if weight is not None:
        dw = (dy * xhat).sum(dim=0)
        db = dy.sum(dim=0)
        dyw = dy * weight.float()
    else:
        dw = db = None
        dyw = dy
    h = xf.shape[1]
    c2 = (dyw * xhat).sum(dim=1, keepdim=True) / h
    if rms:
        dx = (dyw - xhat * c2) * rstd
    else:
        c1 = dyw.sum(dim=1, keepdim=True) / h
        dx = (dyw - c1 - xhat * c2) * rstd
    return dx.to(x2d.dtype), dw, db


# --- the kernels --------------------------------------------------------------

def _check_kernel_inputs(name: str, x2d: torch.Tensor,
                         weight: Optional[torch.Tensor]) -> None:
    if x2d.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if x2d.ndim != 2 or not x2d.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (rows, hidden) x; got "
                         f"{tuple(x2d.shape)}")
    hidden = x2d.shape[1]
    w_dt = None if weight is None else weight.dtype
    half_x = x2d.dtype == torch.float16
    if x2d.dtype not in _DTYPE_CODES or (w_dt is not None and (
            w_dt not in _DTYPE_CODES or (w_dt == torch.float16) != half_x
            and w_dt != torch.float32)):
        raise ValueError(f"the layer-norm kernels take float32, bfloat16 or "
                         f"float16 x with float32 parameters or parameters "
                         f"of a 16-bit x's own dtype (bfloat16 also with "
                         f"float32 x); got {x2d.dtype}, {w_dt} — pass "
                         f"impl='torch' for the plain version")
    if not 1 <= hidden <= KERNEL_MAX_HIDDEN:
        raise ValueError(f"the layer-norm kernels hold a row of at most "
                         f"{KERNEL_MAX_HIDDEN} in registers; got hidden "
                         f"{hidden} — pass impl='torch' for the plain "
                         f"version")
    if weight is not None and (weight.shape != (hidden,)
                               or weight.device != x2d.device
                               or not weight.is_contiguous()):
        raise ValueError(f"{name}: parameters must be contiguous ({hidden},) "
                         f"tensors on x's device")


def row_shape(hidden: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(16-byte chunks a thread, warps a row) for rows of ``hidden`` in
    ``dtype``: at most 16 elements a thread, then the fewest warps of {1,
    2, 3, 4, 6, 8} that cover the row's chunks (768 in bf16: 3 warps of one
    chunk, no idle lane; 1024: 4; 4096: 8 of two chunks). The backward's
    ``bwd_shape`` in ``csrc/layer_norm.cu`` picks the same."""
    vec = 16 // (4 if dtype == torch.float32 else 2)
    nc = -(-hidden // vec)
    c = 1 if nc <= 256 else 2 if nc <= 512 else 4
    need = -(-nc // (32 * c))
    return c, (need if need <= 4 else 6 if need <= 6 else 8)


class LnFwdPlan(NamedTuple):
    """One forward launch: ``warps`` a row, ``chunks`` 16-byte chunks a
    thread, ``groups`` rows at once a CTA, each group ``depth`` rows in
    flight, ``ctas`` CTAs, ``smem`` bytes of the groups' warp sums."""
    chunks: int
    warps: int
    groups: int
    depth: int
    ctas: int
    smem: int


@functools.lru_cache(maxsize=None)
def _fwd_plan(rows: int, hidden: int, dtype: torch.dtype,
              sms: int) -> LnFwdPlan:
    """The forward's launch from the shapes and the card's ``sms`` alone.
    Few rows (the serve and decode legs' 1-16, a prefill chunk's 256): one
    row a group and as few groups a CTA as spread the rows over the SMs,
    so every row is loaded at once and a call pays one memory latency.
    Many rows (the train legs' 8192-65536): full CTAs, as many as the SMs
    hold at once at the kernel's launch bounds, each group walking every
    (ctas * groups)-th row with ``depth`` - 1 rows' loads in flight."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"no forward kernel for {dtype}")
    c, w = row_shape(hidden, dtype)
    most = max(1, FWD_CTA_WARPS[c] // w)
    groups = min(most, -(-rows // sms))
    resident = sms * max(1, FWD_SM_WARPS[c] // (groups * w))
    ctas = min(-(-rows // groups), resident)
    return LnFwdPlan(c, w, groups, FWD_DEPTH[c], ctas, groups * 2 * w * 4)


def ln_fwd_cuda(x2d: torch.Tensor, weight: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], eps: float,
                rms: bool) -> Stats:
    """Launch the forward kernel on :func:`_fwd_plan`'s shape: (y, mean
    (rows, 1), rstd (rows, 1)). Counts its launches in ``.launches``."""
    if weight is None and bias is not None:
        raise ValueError("bias without weight is not supported")
    _check_kernel_inputs("ln_fwd_cuda", x2d, weight)
    if bias is not None and (bias.dtype != weight.dtype
                             or bias.shape != weight.shape
                             or bias.device != x2d.device
                             or not bias.is_contiguous()):
        raise ValueError("ln_fwd_cuda: bias must be a contiguous tensor of "
                         "weight's shape and dtype on x's device")
    rows, hidden = x2d.shape
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    if rows == 0:
        return y, mean, rstd
    affine = 0 if weight is None else (1 if bias is None else 2)
    index = x2d.device.index
    plan = _fwd_plan(rows, hidden, x2d.dtype, _sm_count(
        torch.cuda.current_device() if index is None else index))
    rc = _build.library().apex_ln_fwd(
        x2d.data_ptr(), None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), _DTYPE_CODES[x2d.dtype],
        0 if weight is None else _DTYPE_CODES[weight.dtype], affine,
        int(rms), rows, hidden, float(eps), plan.chunks, plan.warps,
        plan.groups, plan.ctas, plan.smem,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(rc, "ln_fwd")
    ln_fwd_cuda.launches += 1
    ln_fwd_cuda.f16_launches += x2d.dtype == torch.float16
    return y, mean, rstd


ln_fwd_cuda.launches = 0
ln_fwd_cuda.f16_launches = 0


def bwd_rows_per_cta(rows: int) -> int:
    """The backward's fixed row count per CTA: a function of ``rows``
    alone, so the dgamma/dbeta summation order never depends on the card.
    With ``ctas = ceil(rows / per)``, CTA c owns rows c, c + ctas, c + 2
    ctas, ... (``per`` of them, those below ``rows``)."""
    ctas = min(-(-rows // 4), BWD_MAX_CTAS)
    return -(-rows // max(ctas, 1))


def bwd_launch_shape(hidden: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The backward row kernel's launch shape for rows of ``hidden`` in
    ``dtype``, as ``layer_norm.cu`` picks it from the hidden size: (16-byte
    chunks a thread, warps a row, threads a CTA). Asks the kernel
    library, so it needs the card's build."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"no backward kernel for {dtype}")
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().apex_ln_bwd_shape(
        _DTYPE_CODES[dtype], int(hidden), out), "ln_bwd_shape")
    return tuple(out)


def ln_bwd_cuda(dy2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                rstd: torch.Tensor, weight: Optional[torch.Tensor], rms: bool,
                want_db: bool = True):
    """Launch the backward (the row kernel, then the parameter reduction):
    (dx, dgamma, dbeta) with the parameter gradients in ``weight``'s dtype
    (None without ``weight``; dbeta None unless ``want_db``). Counts one
    launch per call in ``.launches``."""
    _check_kernel_inputs("ln_bwd_cuda", x2d, weight)
    if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype \
            or not dy2d.is_contiguous() or dy2d.device != x2d.device:
        raise ValueError("ln_bwd_cuda: dy must be a contiguous tensor of "
                         "x's shape and dtype on its device")
    rows, hidden = x2d.shape
    for t in (mean, rstd):
        if t.dtype != torch.float32 or t.numel() != rows \
                or not t.is_contiguous():
            raise ValueError("ln_bwd_cuda: mean and rstd must be contiguous "
                             "fp32 with one entry per row")
    dx = torch.empty_like(x2d)
    dw = db = part = None
    if weight is not None:
        dw = torch.empty_like(weight)
        db = torch.empty_like(weight) if want_db else None
    if rows == 0:
        if dw is not None:
            dw.zero_()
            if db is not None:
                db.zero_()
        return dx, dw, db
    per_cta = bwd_rows_per_cta(rows)
    if weight is not None:
        part = torch.empty((-(-rows // per_cta), 2, hidden),
                           dtype=torch.float32, device=x2d.device)
    rc = _build.library().apex_ln_bwd(
        dy2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        None if weight is None else weight.data_ptr(), dx.data_ptr(),
        None if part is None else part.data_ptr(),
        None if dw is None else dw.data_ptr(),
        None if db is None else db.data_ptr(), _DTYPE_CODES[x2d.dtype],
        0 if weight is None else _DTYPE_CODES[weight.dtype], int(rms),
        rows, hidden, per_cta,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(rc, "ln_bwd")
    ln_bwd_cuda.launches += 1
    ln_bwd_cuda.f16_launches += x2d.dtype == torch.float16
    return dx, dw, db


ln_bwd_cuda.launches = 0
ln_bwd_cuda.f16_launches = 0


# --- the autograd core --------------------------------------------------------

class _NormCore(torch.autograd.Function):
    """``_norm_core``: y in x's dtype; saves (x, gamma, mean, rstd)."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, rms, use_kernel):
        x2d = x2d.contiguous()
        if use_kernel:
            y, mean, rstd = ln_fwd_cuda(x2d, weight, bias, eps, rms)
        else:
            y, mean, rstd = _torch_fwd(x2d, weight, bias, eps, rms)
        ctx.save_for_backward(x2d, weight, mean, rstd)
        ctx.rms, ctx.use_kernel = rms, use_kernel
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.use_kernel:
            dx, dw, db = ln_bwd_cuda(dy, x2d, mean, rstd, weight, ctx.rms,
                                     ctx.has_bias)
        else:
            dx, dw, db = _torch_bwd(dy, x2d, mean, rstd, weight, ctx.rms)
            dw = None if weight is None else dw.to(weight.dtype)
        db = db.to(ctx.bias_dtype) if ctx.has_bias else None
        return dx, dw, db, None, None, None


def _norm(x, weight, bias, normalized_shape, eps, rms, impl):
    if weight is None and bias is not None:
        raise ValueError("bias without weight is not supported")
    if normalized_shape is None:
        normalized_shape = ((x.shape[-1],) if weight is None
                            else tuple(weight.shape))
    hidden = _normalized_size(normalized_shape)
    x2d = x.reshape(-1, hidden)
    w = None if weight is None else weight.reshape(hidden)
    b = None if bias is None else bias.reshape(hidden)
    y = _NormCore.apply(x2d, w, b, float(eps), rms,
                        _backend.use_kernel(x, impl))
    return y.reshape(x.shape)


def fused_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     normalized_shape: Optional[Sequence[int]] = None, *,
                     eps: float = 1e-5, impl: str = "auto") -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` dims (default: the
    last, or ``weight``'s shape); statistics in fp32, y in x's dtype.
    FLOAT-class under an O1 policy."""
    x, weight, bias = apply_op_rules("layer_norm", x, weight, bias)
    return _norm(x, weight, bias, normalized_shape, eps, False, impl)


def fused_rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                   normalized_shape: Optional[Sequence[int]] = None, *,
                   eps: float = 1e-5, impl: str = "auto") -> torch.Tensor:
    """RMSNorm (``fused_rms_norm_affine``): no centring, mean 0.
    FLOAT-class under an O1 policy."""
    x, weight = apply_op_rules("rms_norm", x, weight)
    return _norm(x, weight, None, normalized_shape, eps, True, impl)


# --- module wrappers ----------------------------------------------------------

class FusedLayerNorm(nn.Module):
    """``apex.normalization.FusedLayerNorm``: ``weight`` (ones) and
    ``bias`` (zeros) Parameters over ``normalized_shape`` when
    ``elementwise_affine``, on ``device`` (default: the card)."""

    rms = False

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 impl: str = "auto", *,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.impl = impl
        dev = _backend.resolve_device(device)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=dtype, device=dev))
            self.bias = None if self.rms else nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=dtype, device=dev))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rms:
            return fused_rms_norm(x, self.weight, self.normalized_shape,
                                  eps=self.eps, impl=self.impl)
        return fused_layer_norm(x, self.weight, self.bias,
                                self.normalized_shape, eps=self.eps,
                                impl=self.impl)

    def extra_repr(self) -> str:
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}")


class FusedRMSNorm(FusedLayerNorm):
    """``apex.normalization.FusedRMSNorm``: ``weight`` only."""

    rms = True


# The reference's Mixed variants keep fp32 weights with half inputs; every
# norm here computes in fp32 and keeps the parameters' dtype, so these are
# aliases, as in the reference.
MixedFusedLayerNorm = FusedLayerNorm
MixedFusedRMSNorm = FusedRMSNorm
