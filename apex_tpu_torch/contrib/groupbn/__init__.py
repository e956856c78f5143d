"""Group batch norm, at ``bn_group=1``.

Port of ``apex_tpu/contrib/groupbn/__init__.py``'s
:class:`BatchNorm2d_NHWC` (``:41-48``; upstream
``apex/contrib/groupbn/batch_norm.py:7``): NHWC batch norm with the
optional fused residual add and ReLU — :class:`~apex_tpu_torch.parallel.
sync_batchnorm.SyncBatchNorm` at one process, on ``csrc/batch_norm.cu``
on the card. ``bn_group > 1`` (statistics over a group of devices) and
``split_data_axis_for_bn`` (``:25-38``) come with the multi-GPU surface
(ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm


class BatchNorm2d_NHWC(SyncBatchNorm):
    """``bnp.BatchNorm2d_NHWC``'s surface: NHWC batch norm with the
    optional fused residual add (the call's ``residual``) and ReLU."""

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, **kw):
        if bn_group != 1:
            raise TypeError(
                "BatchNorm2d_NHWC(bn_group > 1) reduces over a group of "
                "devices, which comes with the multi-GPU surface (ROADMAP "
                "queue 1, item 6)")
        super().__init__(num_features, fuse_relu=fuse_relu, **kw)
