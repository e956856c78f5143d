"""Model-parallel gradient scaling, at tp=1.

Port of ``apex_tpu/transformer/amp/__init__.py``: the all-finite flag
that every model-parallel rank agrees on (apex's ``GradScaler`` all-reduces
found-inf over the model-parallel group, ``grad_scaler.py:38-49``) and the
scaler update with it. The port runs tp = pp = 1, where the agreed flag is
the local one; the reference's ``axes`` argument comes with the process
groups that give it a second value.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.amp.scaler import (LossScalerState, all_finite,
                                       update_loss_scaler)


def model_parallel_all_finite(grads) -> torch.Tensor:
    """The all-finite flag of ``grads``, agreed over the model-parallel
    ranks: at tp = pp = 1, the local flag (0-dim bool, on the device)."""
    return all_finite(grads)


def update_scaler_model_parallel(state: LossScalerState, grads
                                 ) -> Tuple[LossScalerState, torch.Tensor]:
    """``update_loss_scaler`` with the agreed flag: (new state, finite)."""
    finite = model_parallel_all_finite(grads)
    return update_loss_scaler(state, finite), finite


GradScaler = update_scaler_model_parallel  # the reference's class-name alias
