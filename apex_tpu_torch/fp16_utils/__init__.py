"""The legacy manual mixed-precision API: port of
:mod:`apex_tpu.fp16_utils` (``__init__.py:13-22``) over the port's
parameter trees and ``torch.optim.Optimizer`` s."""

from apex_tpu_torch.fp16_utils.fp16util import (  # noqa: F401
    BN_CONVERT_EXEMPT,
    FP16Model,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    to_python_float,
)
from apex_tpu_torch.fp16_utils.fp16_optimizer import (  # noqa: F401
    FP16_Optimizer,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (  # noqa: F401
    DynamicLossScaler,
    LossScaler,
)
