"""Port of :mod:`apex_tpu.parallel`: :class:`LARC`, and
:class:`SyncBatchNorm` with :class:`BatchNormState` and
:func:`sync_batch_norm` at one process (``process_group=None``). The
data-parallel gradients, batch norm over a process group,
``create_syncbn_process_group`` and the mesh come with the multi-GPU
surface (ROADMAP queue 1, item 6)."""

from apex_tpu_torch.parallel.larc import LARC  # noqa: F401
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    BatchNormState,
    SyncBatchNorm,
    sync_batch_norm,
)
