"""Cross-entropy row statistics.

Port of ``apex_tpu/ops/pallas/xentropy.py::xent_stats`` (``:73-101``): one
pass over (N, V) logits gives, per row, the fp32 max, the exp-sum relative
to it, the raw target logit (0 when the label lies outside [0, V)) and the
raw row sum. Dispatch follows :mod:`apex_tpu_torch.ops._backend`: a CUDA
tensor launches :func:`xent_stats_cuda`, the hand-written kernel
``apex_tpu_torch/csrc/xent_stats.cu``; a CPU tensor (or ``impl="torch"``)
runs :func:`_torch_xent_stats` beside it.

The losses of ``apex_tpu/ops/xentropy.py`` (``:30-100``, the contrib
surface ``apex.contrib.xentropy``): :func:`softmax_cross_entropy_loss`
and :class:`SoftmaxCrossEntropyLoss` write their forward once over
:func:`xent_stats`' four statistics — lse = m + log l, loss = (1 − ε)(lse
− t) + ε(lse − s/V) — so a CUDA tensor runs the ``xent_stats`` kernel and a
CPU tensor its plain version, the same formula either way. The backward
recomputes exp(x − lse) − (1 − ε)·onehot − ε/V in plain PyTorch from the
saved logits and lse (the reference's residuals: never the softmax), as
the reference leaves it to XLA. :func:`binary_cross_entropy` is the
reference's banned-under-O1 op.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from apex_tpu_torch.amp.lists import apply_op_rules
from apex_tpu_torch.ops import _backend, _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: logits per 16-byte load, by dtype: the kernel takes V a multiple of it
KERNEL_VEC = {torch.float32: 4, torch.bfloat16: 8, torch.float16: 8}

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _torch_xent_stats(logits2d: torch.Tensor, labels: torch.Tensor) -> Stats:
    x = logits2d.float()
    m = x.amax(dim=-1)
    l = torch.exp(x - m[:, None]).sum(dim=-1)  # noqa: E741
    inr = (labels >= 0) & (labels < x.shape[-1])
    t = x.gather(1, torch.where(inr, labels, 0).long()[:, None])[:, 0]
    return m, l, torch.where(inr, t, 0.0), x.sum(dim=-1)


def xent_stats_cuda(logits2d: torch.Tensor, labels: torch.Tensor) -> Stats:
    """Launch the row-statistics kernel on (N, V) float32, bfloat16 or
    float16 logits and (N,) int32/int64 labels. Counts its launches in
    ``.launches``, those on fp16 logits also in ``.f16_launches``."""
    if logits2d.device.type != "cuda" or labels.device != logits2d.device:
        raise ValueError("xent_stats_cuda takes CUDA tensors on one device")
    if logits2d.ndim != 2 or labels.shape != (logits2d.shape[0],):
        raise ValueError(f"xent_stats_cuda takes (N, V) logits and (N,) "
                         f"labels; got {tuple(logits2d.shape)} and "
                         f"{tuple(labels.shape)}")
    if logits2d.dtype not in _DTYPE_CODES \
            or labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"the xent_stats kernel takes float32, bfloat16 or "
                         f"float16 logits and int32/int64 labels; got "
                         f"{logits2d.dtype}, {labels.dtype}")
    n, V = logits2d.shape
    vec = KERNEL_VEC[logits2d.dtype]
    if n < 1 or V < 1 or V % vec:
        raise ValueError(f"the xent_stats kernel reads rows in 16-byte "
                         f"loads: V must be a positive multiple of {vec} "
                         f"for {logits2d.dtype}; got ({n}, {V})")
    if not logits2d.is_contiguous() or logits2d.data_ptr() % 16 \
            or not labels.is_contiguous():
        raise ValueError("xent_stats_cuda takes contiguous tensors, the "
                         "logits 16-byte aligned")
    m, l, t, s = (torch.empty((n,), dtype=torch.float32,  # noqa: E741
                              device=logits2d.device) for _ in range(4))
    rc = _build.library().apex_xent_stats(
        logits2d.data_ptr(), labels.data_ptr(), m.data_ptr(), l.data_ptr(),
        t.data_ptr(), s.data_ptr(), _DTYPE_CODES[logits2d.dtype],
        int(labels.dtype == torch.int64), n, V,
        torch.cuda.current_stream(logits2d.device).cuda_stream)
    _build.check(rc, "xent_stats")
    xent_stats_cuda.launches += 1
    xent_stats_cuda.f16_launches += logits2d.dtype == torch.float16
    return m, l, t, s


xent_stats_cuda.launches = 0
xent_stats_cuda.f16_launches = 0


def xent_stats(logits2d: torch.Tensor, labels: torch.Tensor, *,
               impl: str = "auto") -> Stats:
    """(N, V) logits + (N,) integer labels → per-row fp32 stats ``(max,
    sumexp_rel_max, target_logit_raw, row_sum_raw)``; labels outside
    ``[0, V)`` yield ``target_logit_raw == 0``."""
    if _backend.use_kernel(logits2d, impl):
        return xent_stats_cuda(logits2d, labels)
    return _torch_xent_stats(logits2d, labels)


# --- the losses ---------------------------------------------------------------

class _SoftmaxXent(torch.autograd.Function):
    """``_xent_core`` (``apex_tpu/ops/xentropy.py:23-27``, ``:60-86``): the
    forward over :func:`xent_stats`, the residuals the logits, the labels
    and lse (V floats fewer than a saved softmax)."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, half_to_float, impl):
        V = logits.shape[-1]
        lab = labels.long()
        # the reference's take_along_axis: a label in [-V, 0) wraps to V +
        # label; one outside [-V, V) reads NaN
        wrapped = torch.where(lab < 0, lab + V, lab)
        live = (wrapped >= 0) & (wrapped < V)
        m, l, t, s = (x.reshape(labels.shape) for x in xent_stats(  # noqa: E741
            logits.reshape(-1, V), wrapped.reshape(-1), impl=impl))
        lse = m + torch.log(l)
        loss = lse - t
        if smoothing:
            loss = (1.0 - smoothing) * loss + smoothing * (lse - s / V)
        loss = torch.where(live, loss, math.nan)
        wide = half_to_float or logits.dtype == torch.float32
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing = smoothing
        return loss.to(torch.float32 if wide else logits.dtype)

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        eps = ctx.smoothing
        V = logits.shape[-1]
        # exp(x - lse) in place in ONE fp32 buffer; the one-hot of the
        # labels as given: zero for a label outside [0, V) (the forward's
        # wrapped negative labels included, as jax.nn.one_hot gives it)
        g = logits.to(torch.float32, copy=True)
        g.sub_(lse[..., None]).exp_()
        lab = labels.long()[..., None]
        inr = (lab >= 0) & (lab < V)
        g.scatter_add_(-1, torch.where(inr, lab, 0),
                       -(1.0 - eps) * inr.to(torch.float32))
        if eps:
            g.sub_(eps / V)
        g.mul_(dloss[..., None].to(torch.float32))
        return g.to(logits.dtype), None, None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               half_to_float: bool = False, *,
                               impl: str = "auto") -> torch.Tensor:
    """Per-example loss over (..., V) logits and (...) integer labels
    (``apex_tpu/ops/xentropy.py:30-49``): ``(1-ε)·NLL(target) +
    ε·mean-NLL(all classes)`` with ε = ``smoothing``. The loss is fp32 with
    ``half_to_float`` or fp32 logits, else the logits' dtype; the gradient
    has the logits' dtype. A label in [-V, 0) wraps to V + label in the
    forward and a label outside [-V, V) gives a NaN loss, while the
    backward's one-hot is zero for both (the reference's behaviour, ROADMAP
    queue 3). FLOAT-class under O1 (the logits cast to fp32). On a CUDA
    tensor the forward launches the ``xent_stats`` kernel (V a multiple of
    its 16-byte load); ``impl="torch"`` or a CPU tensor runs its plain
    version."""
    if logits.ndim < 1 or tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"labels {tuple(labels.shape)} must match the "
                         f"logits' leading dims {tuple(logits.shape[:-1])}")
    if labels.is_floating_point() or labels.is_complex():
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    logits, = apply_op_rules("cross_entropy", logits)
    return _SoftmaxXent.apply(logits.contiguous(), labels.contiguous(),
                              float(smoothing), bool(half_to_float), impl)


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor, *,
                         eps: float = 1e-12) -> torch.Tensor:
    """Elementwise BCE on probabilities (``apex_tpu/ops/xentropy.py:
    52-63``), clipped to [eps, 1 - eps]: the reference's canonical BANNED
    op — under an O1 policy with a half input it raises (apex's
    ``err_if_any_half``); legal in fp32 or outside O1."""
    probs, targets = apply_op_rules("binary_cross_entropy", probs, targets)
    p = probs.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p))


class SoftmaxCrossEntropyLoss:
    """``apex.contrib.xentropy.SoftmaxCrossEntropyLoss``'s call shape
    (``apex_tpu/ops/xentropy.py:93-100``). ``padding_idx`` is accepted and
    unused, as in the reference."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False, *, impl: str = "auto"):
        del padding_idx  # the reference ignores it too
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          half_to_float, impl=impl)
