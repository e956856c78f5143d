"""Port of :mod:`apex_tpu.optimizers`: FusedAdam, FusedLAMB,
FusedMixedPrecisionLamb, FusedSGD, FusedNovoGrad and FusedAdagrad as
``torch.optim.Optimizer`` s on one shared base (``_fused.py``), and the
chunked multi-tensor layout's functions (``multi_tensor.py``). Every
optimizer keeps its state per tensor: the reference's ``layout`` and
``chunk_size`` are not arguments."""

from apex_tpu_torch.optimizers.multi_tensor import (  # noqa: F401
    ChunkLayout,
    make_layout,
    flatten_to_chunks,
    unflatten_from_chunks,
    per_tensor_sqnorm,
    per_tensor_maxnorm,
    broadcast_per_tensor,
    global_norm,
    multi_tensor_scale,
    multi_tensor_axpby,
    multi_tensor_l2norm,
)
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB  # noqa: F401
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad,
)
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad  # noqa: F401
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (  # noqa
    FusedMixedPrecisionLamb,
)
