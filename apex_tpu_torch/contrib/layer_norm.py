"""FastLayerNorm — LayerNorm for large hidden sizes.

Port of ``apex_tpu/contrib/layer_norm.py`` (``apex.contrib.layer_norm``):
the reference re-exports its ``FusedLayerNorm`` and ``fused_layer_norm``
(``:12-13``) because its Pallas kernel sizes its row block to VMEM and so
streams any hidden size. Here too they are the port's own norm: on a CUDA
tensor with hidden above 4096 the entry launches the cluster kernels of
``csrc/layer_norm_wide.cu`` (hidden up to 65536, FastLayerNorm's range),
at 4096 or below the register kernels of ``csrc/layer_norm.cu``.
"""

from apex_tpu_torch.ops.layer_norm import FusedLayerNorm as FastLayerNorm  # noqa: F401
from apex_tpu_torch.ops.layer_norm import fused_layer_norm as fast_layer_norm  # noqa: F401
