"""Port of :mod:`apex_tpu.optimizers` (FusedAdam)."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
