"""Fused softmax cross-entropy (contrib surface): a re-export of
:mod:`apex_tpu_torch.ops.xentropy`, as ``apex_tpu/contrib/xentropy.py``
re-exports ``apex_tpu.ops.xentropy``."""

from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)
