"""Port of :mod:`apex_tpu.ops`: each op's plain PyTorch version beside the
hand-written CUDA kernel that replaces its Pallas kernel."""

from apex_tpu_torch.ops.fused_dense import (  # noqa: F401
    FusedDense,
    FusedDenseGeluDense,
    fused_dense,
    fused_dense_gelu_dense,
)
from apex_tpu_torch.ops.matmul import matmul_bias_act  # noqa: F401
from apex_tpu_torch.ops.mlp import MLP, mlp  # noqa: F401
