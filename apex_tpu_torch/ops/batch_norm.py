"""Batch norm over channel-last activations: ResNet's batch norms.

The reference computes batch norm in XLA
(``apex_tpu/parallel/sync_batchnorm.py::sync_batch_norm``, ``:52-133``),
whose fusion stands in for upstream apex's Welford SyncBN kernels and
groupbn's fused add + ReLU epilogue. Eager PyTorch has no such fusion, so
the port computes the same function in a kernel of its own,
``apex_tpu_torch/csrc/batch_norm.cu`` (as ``ops/dropout.py`` does for
GPT's XLA dropout).

x is viewed as (M, C) row-major (NHWC, M = N·H·W). The statistics are
always fp32: the mean first, then the centred second moment (``:88-101``);
then scale, bias, the optional residual and the optional ReLU (``:122-132``),
in that order, and one rounding to the output dtype.

* :func:`bn_plain` is the reference's arithmetic in PyTorch. The CPU and
  ``impl="torch"`` run it, under autograd for the backward
  (:func:`bn_backward_plain` is that backward as a function of the
  kernel's inputs, for the checks on the card).
* :func:`bn_fwd_cuda` and :func:`bn_bwd_cuda` launch the kernels on
  :func:`_bn_plan`'s shape; :class:`BatchNormCore` is the autograd entry
  on the card. There is no fallback: a build or launch failure raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _backend, _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the (x dtype, y dtype) pairs the kernels take: y in x's dtype, or a half
#: y for fp32 x
KERNEL_PAIRS = ((torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float16, torch.float16),
                (torch.float32, torch.bfloat16),
                (torch.float32, torch.float16))
#: the faults the kernels plant on request, for the chip checks to refuse
FWD_FAULTS = {"drop_last_chunk": 1}  # the last row chunk out of the stats
BWD_FAULTS = {"drop_xhat_term": 1}   # dx without −x̂·Σdy'x̂/M

#: threads a CTA of the column passes
CTA_THREADS = 256
#: the stats and reduction passes aim at this many CTAs (8 resident CTAs
#: on each of 132 SMs); a constant, so the sums' order never reads the card
TARGET_CTAS = 1056
#: the apply and dx passes' CTAs (8 resident 256-thread CTAs an SM)
APPLY_CTAS = 1056


class BnPlan(NamedTuple):
    """The kernels' launch shape: ``vec`` channels a thread (16 bytes of x,
    or 1), ``tx`` column vectors by ``ty`` rows a CTA, ``col_blocks`` CTAs
    across the channels; the statistics' ``chunks`` of ``rows_per_chunk``
    rows (the sums' fixed order); ``apply_ctas`` row CTAs of the apply and
    dx passes."""

    vec: int
    tx: int
    ty: int
    col_blocks: int
    chunks: int
    rows_per_chunk: int
    apply_ctas: int


def _bn_plan(rows: int, channels: int, dtype: torch.dtype,
             aligned: bool = True) -> BnPlan:
    """The launch shape for (rows, channels) of ``dtype``: a function of
    these alone, so the chunks — and with them every sum's order — are the
    same on any card. ``aligned``: every operand sits on a 16-byte
    boundary (else one channel a thread)."""
    if rows < 1 or channels < 1:
        raise ValueError(f"batch norm needs rows and channels; got "
                         f"({rows}, {channels})")
    natural = 16 // torch.empty((), dtype=dtype).element_size()
    vec = natural if aligned and channels % natural == 0 else 1
    cv = channels // vec
    tx = min(cv, 32)
    ty = CTA_THREADS // tx
    col_blocks = -(-cv // tx)
    want = max(1, -(-TARGET_CTAS // col_blocks))
    chunks = max(1, min(want, -(-rows // ty)))
    rows_per_chunk = -(-rows // chunks)
    rows_per_chunk = -(-rows_per_chunk // ty) * ty  # whole row groups
    chunks = -(-rows // rows_per_chunk)
    apply_ctas = max(1, min(-(-rows // ty), APPLY_CTAS // col_blocks, 65535))
    return BnPlan(vec, tx, ty, col_blocks, chunks, rows_per_chunk, apply_ctas)


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def bn_plain(x2d: torch.Tensor, scale: Optional[torch.Tensor],
             bias: Optional[torch.Tensor], *, training: bool, eps: float,
             running_mean: Optional[torch.Tensor] = None,
             running_var: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None, relu: bool = False,
             out_dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, var): the reference's arithmetic (``:84-132``) on (M, C)
    ``x2d``; mean and the biased var fp32 (the running ones in eval)."""
    xs = x2d.float()
    if training:
        mean = xs.mean(dim=0)
        centered = xs - mean
        var = (centered * centered).mean(dim=0)
    else:
        mean = running_mean.float()
        var = running_var.float()
    inv = torch.rsqrt(var + eps)
    y = (xs - mean) * inv
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype or x2d.dtype), mean, var


def bn_backward_plain(dy2d: torch.Tensor, x2d: torch.Tensor,
                      y2d: Optional[torch.Tensor],
                      scale: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor], *, training: bool,
                      eps: float,
                      running_mean: Optional[torch.Tensor] = None,
                      running_var: Optional[torch.Tensor] = None,
                      residual: bool = False, relu: bool = False):
    """The backward's plain version, (dx, dresidual, dscale, dbias):
    autograd through :func:`bn_plain` on dy' = dy · [y > 0] (with the
    ReLU; y the forward's output, the tensor :func:`bn_bwd_cuda` reads),
    else dy. dresidual is dy'. Given the same y, the same function as the
    kernel's: two forwards may round a pre-activation within an fp32
    rounding of 0 to opposite sides, and then their masks differ."""
    g = dy2d * (y2d > 0) if relu else dy2d
    leaves = [t.detach().requires_grad_() if t is not None else None
              for t in (x2d, scale, bias)]
    y, _, _ = bn_plain(leaves[0], leaves[1], leaves[2], training=training,
                       eps=eps, running_mean=running_mean,
                       running_var=running_var, out_dtype=dy2d.dtype)
    live = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(y, live, g))
    dx, dscale, dbias = (next(got) if t is not None else None
                         for t in leaves)
    return dx, g if residual else None, dscale, dbias


def _kind(residual: bool, relu: bool) -> str:
    return ("res_relu" if residual and relu else "relu" if relu
            else "res" if residual else "bare")


def _check_inputs(name, x2d, out_dtype, residual):
    if x2d.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if x2d.ndim != 2 or not x2d.is_contiguous() or x2d.numel() == 0:
        raise ValueError(f"{name} takes a contiguous non-empty (M, C) x; "
                         f"got {tuple(x2d.shape)} strides {x2d.stride()}")
    if (x2d.dtype, out_dtype) not in KERNEL_PAIRS:
        raise ValueError(f"{name} takes (x, y) dtypes {KERNEL_PAIRS}; got "
                         f"({x2d.dtype}, {out_dtype})")
    if x2d.shape[0] >= 2 ** 31 or x2d.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: rows and channels must be < 2^31")
    if residual is not None and (
            residual.shape != x2d.shape or residual.dtype != out_dtype
            or not residual.is_contiguous()
            or residual.device != x2d.device):
        raise ValueError(f"{name}: the residual must be a contiguous "
                         f"tensor of x's shape in the output's dtype")


def _w_code(scale, bias, x2d) -> int:
    ws = [w for w in (scale, bias) if w is not None]
    if not ws:
        return -1
    dt = ws[0].dtype
    C = x2d.shape[1]
    for w in ws:
        if w.dtype != dt or w.dtype not in (torch.float32, x2d.dtype) \
                or w.shape != (C,) or not w.is_contiguous() \
                or w.device != x2d.device:
            raise ValueError("scale and bias must be contiguous (C,) "
                             "tensors in fp32 or x's dtype, one dtype for "
                             "both, on x's device")
    return _DTYPE_CODES[dt]


def bn_fwd_cuda(x2d: torch.Tensor, scale: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], *, training: bool,
                eps: float = 1e-5,
                running_mean: Optional[torch.Tensor] = None,
                running_var: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None, relu: bool = False,
                out_dtype: Optional[torch.dtype] = None,
                planted_fault: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward on contiguous (M, C) ``x2d``: (y, stats), stats
    fp32 (5, C) = (mean, var, rstd, scale, bias), the biased var; in eval
    the running mean and var (fp32, (C,)) stand in for the batch's. Counts
    one launch a call in ``.launches``, by epilogue in
    ``.<kind>_launches`` (``res_relu``, ``relu``, ``res``, ``bare``), in
    eval also in ``.eval_launches``."""
    out_dtype = out_dtype or x2d.dtype
    _check_inputs("bn_fwd_cuda", x2d, out_dtype, residual)
    w_code = _w_code(scale, bias, x2d)
    M, C = x2d.shape
    if not training:
        for t in (running_mean, running_var):
            if t is None or t.dtype != torch.float32 or t.shape != (C,) \
                    or not t.is_contiguous() or t.device != x2d.device:
                raise ValueError("bn_fwd_cuda in eval takes fp32 (C,) "
                                 "running mean and var on x's device")
    if planted_fault is not None and planted_fault not in FWD_FAULTS:
        raise ValueError(f"planted_fault must be one of {sorted(FWD_FAULTS)}"
                         f"; got {planted_fault!r}")
    y = torch.empty((M, C), dtype=out_dtype, device=x2d.device)
    plan = _bn_plan(M, C, x2d.dtype, _aligned(x2d, y, residual))
    stats = torch.empty((5, C), dtype=torch.float32, device=x2d.device)
    part = (torch.empty((2, plan.chunks, C), dtype=torch.float32,
                        device=x2d.device) if training else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _build.library().apex_bn_fwd(
        x2d.data_ptr(), ptr(residual), y.data_ptr(), ptr(scale), ptr(bias),
        ptr(None if training else running_mean),
        ptr(None if training else running_var), stats.data_ptr(),
        ptr(part), _DTYPE_CODES[x2d.dtype], _DTYPE_CODES[out_dtype], w_code,
        M, C, int(training), int(relu), float(eps), plan.vec, plan.tx,
        plan.ty, plan.chunks, plan.rows_per_chunk, plan.apply_ctas,
        FWD_FAULTS.get(planted_fault, 0),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(rc, "bn_fwd")
    bn_fwd_cuda.launches += 1
    kind = _kind(residual is not None, relu)
    setattr(bn_fwd_cuda, f"{kind}_launches",
            getattr(bn_fwd_cuda, f"{kind}_launches") + 1)
    bn_fwd_cuda.eval_launches += not training
    return y, stats


def bn_bwd_cuda(dy2d: torch.Tensor, x2d: torch.Tensor,
                y2d: Optional[torch.Tensor], stats: torch.Tensor, *,
                training: bool, residual: bool = False, relu: bool = False,
                w_dtype: Optional[torch.dtype] = None, want_dbias: bool = True,
                planted_fault: Optional[str] = None):
    """Launch the backward: (dx, dresidual, dscale, dbias). dy and the
    saved y (read only with the ReLU, for its mask) in the output's dtype,
    ``stats`` the forward's; dresidual (with ``residual``) is dy' in dy's
    dtype, dscale and dbias (with ``w_dtype``, the parameters' dtype) are
    Σdy'·x̂ and Σdy' over the rows in a fixed order. Counts as
    :func:`bn_fwd_cuda` does."""
    out_dtype = dy2d.dtype
    _check_inputs("bn_bwd_cuda", x2d, out_dtype, None)
    M, C = x2d.shape
    if dy2d.shape != (M, C) or not dy2d.is_contiguous() \
            or dy2d.device != x2d.device:
        raise ValueError("bn_bwd_cuda: dy must be a contiguous tensor of "
                         "x's shape on its device")
    if relu and (y2d is None or y2d.shape != (M, C) or y2d.dtype != out_dtype
                 or not y2d.is_contiguous()):
        raise ValueError("bn_bwd_cuda with the ReLU reads the forward's y: "
                         "a contiguous tensor of x's shape in dy's dtype")
    if stats.shape != (5, C) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError("bn_bwd_cuda: stats must be the forward's fp32 "
                         "(5, C)")
    if planted_fault is not None and planted_fault not in BWD_FAULTS:
        raise ValueError(f"planted_fault must be one of {sorted(BWD_FAULTS)}"
                         f"; got {planted_fault!r}")
    dx = torch.empty_like(x2d)
    dres = torch.empty_like(dy2d) if residual else None
    dscale = dbias = None
    if w_dtype is not None:
        if w_dtype not in (torch.float32, x2d.dtype):
            raise ValueError("scale and bias are fp32 or x's dtype")
        dscale = torch.empty((C,), dtype=w_dtype, device=x2d.device)
        dbias = (torch.empty((C,), dtype=w_dtype, device=x2d.device)
                 if want_dbias else None)
    yr = y2d if relu else None
    plan = _bn_plan(M, C, x2d.dtype, _aligned(dy2d, x2d, yr, dx, dres))
    part = torch.empty((2 * plan.chunks + 2, C), dtype=torch.float32,
                       device=x2d.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _build.library().apex_bn_bwd(
        dy2d.data_ptr(), x2d.data_ptr(), ptr(yr), stats.data_ptr(),
        dx.data_ptr(), ptr(dres), ptr(dscale), ptr(dbias), part.data_ptr(),
        _DTYPE_CODES[x2d.dtype], _DTYPE_CODES[out_dtype],
        -1 if w_dtype is None else _DTYPE_CODES[w_dtype], M, C,
        int(training), int(relu), plan.vec, plan.tx, plan.ty, plan.chunks,
        plan.rows_per_chunk, plan.apply_ctas,
        BWD_FAULTS.get(planted_fault, 0),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(rc, "bn_bwd")
    bn_bwd_cuda.launches += 1
    kind = _kind(residual, relu)
    setattr(bn_bwd_cuda, f"{kind}_launches",
            getattr(bn_bwd_cuda, f"{kind}_launches") + 1)
    bn_bwd_cuda.eval_launches += not training
    return dx, dres, dscale, dbias


for _fn in (bn_fwd_cuda, bn_bwd_cuda):
    for _attr in ("launches", "res_relu_launches", "relu_launches",
                  "res_launches", "bare_launches", "eval_launches"):
        setattr(_fn, _attr, 0)
del _fn, _attr


class BatchNormCore(torch.autograd.Function):
    """The kernels under autograd: forward → (y, stats), stats the fp32
    (5, C) of :func:`bn_fwd_cuda` (no gradient); the saved tensors are x, y
    (with the ReLU: its mask) and the stats."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, residual, running_mean, running_var,
                training, eps, relu, out_dtype):
        y, stats = bn_fwd_cuda(x2d, scale, bias, training=training, eps=eps,
                               running_mean=running_mean,
                               running_var=running_var, residual=residual,
                               relu=relu, out_dtype=out_dtype)
        ctx.save_for_backward(x2d, y if relu else None, stats)
        ctx.cfg = (training, relu, residual is not None,
                   None if scale is None else scale.dtype, bias is not None)
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        x2d, y, stats = ctx.saved_tensors
        training, relu, has_res, w_dtype, has_bias = ctx.cfg
        dx, dres, dscale, dbias = bn_bwd_cuda(
            dy.contiguous(), x2d, y, stats, training=training,
            residual=has_res, relu=relu, w_dtype=w_dtype,
            want_dbias=has_bias)
        return (dx, dscale, dbias, dres, None, None, None, None, None, None)


def batch_norm(x2d: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], *, training: bool,
               eps: float = 1e-5,
               running_mean: Optional[torch.Tensor] = None,
               running_var: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None, relu: bool = False,
               out_dtype: Optional[torch.dtype] = None, impl: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, var) of (M, C) ``x2d``, differentiable in x, scale, bias
    and the residual: a CUDA tensor launches the kernels, a CPU tensor (or
    ``impl="torch"``) runs :func:`bn_plain`. mean and var are fp32 and
    carry no gradient."""
    out_dtype = out_dtype or x2d.dtype
    if _backend.use_kernel(x2d, impl):
        if not training:
            running_mean = running_mean.float().contiguous()
            running_var = running_var.float().contiguous()
        y, stats = BatchNormCore.apply(
            x2d.contiguous(), scale, bias,
            None if residual is None else residual.contiguous(),
            running_mean, running_var, training, float(eps), relu, out_dtype)
        return y, stats[0], stats[1]
    y, mean, var = bn_plain(x2d, scale, bias, training=training, eps=eps,
                            running_mean=running_mean,
                            running_var=running_var, residual=residual,
                            relu=relu, out_dtype=out_dtype)
    return y, mean.detach(), var.detach()
