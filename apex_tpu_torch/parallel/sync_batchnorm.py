"""Batch normalization of channel-last activations, at one process.

Port of ``apex_tpu/parallel/sync_batchnorm.py``: :class:`BatchNormState`
(``:36-49``), :func:`sync_batch_norm` (``:52-133``) and
:class:`SyncBatchNorm` (``:136-187``). The reference reduces the
statistics over a mesh axis (``axis_name``, default ``"dp"``); its
PyTorch spelling is a ``process_group``, and a group comes with the
multi-GPU surface (ROADMAP queue 1, item 6). Until then the statistics
are the local batch's: ``process_group=None`` is the only value, as the
reference's ``axis_name=None``.

The arithmetic is :mod:`apex_tpu_torch.ops.batch_norm`'s: fp32 statistics
(the mean, then the centred second moment), the output in x's dtype when
the ambient policy keeps norms in fp32, else in its compute dtype
(``:84``). On a CUDA tensor it runs ``csrc/batch_norm.cu``'s kernels, on a
CPU tensor (or ``impl="torch"``) the plain version. The running statistics
use the unbiased variance over ``x.numel() // C`` rows (``:103-117``) and
``num_batches_tracked`` counts up; eval mode normalizes with them and
returns the state unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from apex_tpu_torch.amp.policy import current_policy
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.batch_norm import batch_norm

_GROUP_ITEM = ("comes with the multi-GPU surface (ROADMAP queue 1, "
               "item 6): the port's batch norm runs at one process")


@dataclasses.dataclass
class BatchNormState:
    """Running statistics (the module buffers of the reference)."""

    running_mean: torch.Tensor
    running_var: torch.Tensor
    num_batches_tracked: torch.Tensor

    @classmethod
    def create(cls, num_features: int, dtype: torch.dtype = torch.float32,
               device: Optional[Union[str, torch.device]] = None
               ) -> "BatchNormState":
        dev = _backend.resolve_device(device)
        return cls(
            running_mean=torch.zeros((num_features,), dtype=dtype,
                                     device=dev),
            running_var=torch.ones((num_features,), dtype=dtype, device=dev),
            num_batches_tracked=torch.zeros((), dtype=torch.int32,
                                            device=dev))


def _refuse_group(process_group, process_group_size) -> None:
    if process_group is not None:
        raise TypeError(f"sync_batch_norm(process_group=) {_GROUP_ITEM}")
    if process_group_size is not None:
        raise TypeError(f"sync_batch_norm(process_group_size=) "
                        f"{_GROUP_ITEM}")


def sync_batch_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], state: BatchNormState, *,
                    training: bool = True, momentum: float = 0.1,
                    eps: float = 1e-5, process_group=None,
                    process_group_size: Optional[int] = None,
                    fuse_relu: bool = False,
                    residual: Optional[torch.Tensor] = None,
                    impl: str = "auto"
                    ) -> Tuple[torch.Tensor, BatchNormState]:
    """Batch norm of channel-last ``x`` (..., C): ``(y, new_state)``, y
    differentiable in x, scale, bias and ``residual`` (added after the
    affine, before the ReLU of ``fuse_relu``)."""
    _refuse_group(process_group, process_group_size)
    policy = current_policy()
    out_dtype = x.dtype if policy.keep_norm_f32 else policy.compute_dtype
    C = x.shape[-1]
    x2d = x.reshape(-1, C)
    res2d = None if residual is None else residual.reshape(-1, C)
    y, mean, var = batch_norm(
        x2d, scale, bias, training=training, eps=eps,
        running_mean=state.running_mean, running_var=state.running_var,
        residual=res2d, relu=fuse_relu, out_dtype=out_dtype, impl=impl)
    if training:
        with torch.no_grad():
            count = float(x2d.shape[0])
            unbiased = var * count / max(count - 1.0, 1.0)
            new_state = BatchNormState(
                running_mean=((1 - momentum) * state.running_mean
                              + momentum * mean).to(
                                  state.running_mean.dtype),
                running_var=((1 - momentum) * state.running_var
                             + momentum * unbiased).to(
                                 state.running_var.dtype),
                num_batches_tracked=state.num_batches_tracked + 1)
    else:
        new_state = state
    return y.reshape(x.shape[:-1] + (C,)), new_state


class SyncBatchNorm:
    """The reference module's constructor surface
    (``apex/parallel/optimized_sync_batchnorm.py:9``): holds the config;
    :meth:`init` gives (scale, bias) and the running statistics, a call
    returns the output and the new state and mutates nothing."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 process_group=None, fuse_relu: bool = False):
        _refuse_group(process_group, None)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.process_group = process_group
        self.fuse_relu = fuse_relu

    def init(self, dtype: torch.dtype = torch.float32,
             device: Optional[Union[str, torch.device]] = None
             ) -> Tuple[dict, BatchNormState]:
        dev = _backend.resolve_device(device)
        params = ({"scale": torch.ones((self.num_features,), dtype=dtype,
                                       device=dev),
                   "bias": torch.zeros((self.num_features,), dtype=dtype,
                                       device=dev)}
                  if self.affine else {})
        return params, BatchNormState.create(self.num_features, dtype, dev)

    def __call__(self, params: dict, state: BatchNormState, x: torch.Tensor,
                 *, training: bool = True,
                 residual: Optional[torch.Tensor] = None,
                 impl: str = "auto") -> Tuple[torch.Tensor, BatchNormState]:
        return sync_batch_norm(
            x, params.get("scale"), params.get("bias"), state,
            training=training, momentum=self.momentum, eps=self.eps,
            process_group=self.process_group, fuse_relu=self.fuse_relu,
            residual=residual, impl=impl)
