"""Cross-entropy row statistics.

Port of ``apex_tpu/ops/pallas/xentropy.py::xent_stats`` (``:73-101``): one
pass over (N, V) logits gives, per row, the fp32 max, the exp-sum relative
to it, the raw target logit (0 when the label lies outside [0, V)) and the
raw row sum. Dispatch follows :mod:`apex_tpu_torch.ops._backend`: a CUDA
tensor launches :func:`xent_stats_cuda`, the hand-written kernel
``apex_tpu_torch/csrc/xent_stats.cu``; a CPU tensor (or ``impl="torch"``)
runs :func:`_torch_xent_stats` beside it.

``softmax_cross_entropy_loss`` of the reference's ``ops/xentropy.py``
joins this module in a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
