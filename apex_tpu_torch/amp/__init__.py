"""Automatic mixed precision: the policy engine.

Port of :mod:`apex_tpu.amp`: the O0-O3 opt levels as :class:`Policy`
values, the O1 per-op cast tables (:mod:`apex_tpu_torch.amp.lists`, which
every ported op consults), the static and dynamic loss scaler
(:mod:`apex_tpu_torch.amp.scaler`), fp32 master weights
(:mod:`apex_tpu_torch.amp.master`) and ``amp.initialize``
(:mod:`apex_tpu_torch.amp.frontend`). ``half_dtype=torch.float16`` is
strict fp16: the flash, LayerNorm and cross-entropy kernels of GPT's train
step take it, and the dynamic scaler finds the overflows it brings.
"""

from apex_tpu_torch.amp.policy import (  # noqa: F401
    Policy,
    O0,
    O1,
    O2,
    O3,
    get_policy,
    with_policy,
    current_policy,
)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScalerState,
    init_loss_scaler,
    scale_loss,
    unscale_grads,
    update_loss_scaler,
    scaled_value_and_grad,
    all_finite,
    apply_if_finite,
    skip_step_if_nonfinite,
    scaler_metrics,
    state_dict,
    load_state_dict,
)
from apex_tpu_torch.amp.master import (  # noqa: F401
    MasterWeights,
    apply_updates_with_master,
)
from apex_tpu_torch.amp.lists import (  # noqa: F401
    apply_op_rules,
    check_banned,
    op_cast_dtype,
    register_float_op,
    register_half_op,
    register_promote_op,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.amp.frontend import (  # noqa: F401
    AmpState,
    initialize,
    half_function,
    float_function,
    promote_function,
    disable_casts,
    master_params,
)
