"""Fused focal loss (contrib surface): a re-export of
:mod:`apex_tpu_torch.ops.focal_loss`, as ``apex_tpu/contrib/focal_loss.py``
re-exports ``apex_tpu.ops.focal_loss``."""

from apex_tpu_torch.ops.focal_loss import focal_loss  # noqa: F401
