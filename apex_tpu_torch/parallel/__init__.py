"""Port of :mod:`apex_tpu.parallel`: :class:`LARC` (the data-parallel
gradients, SyncBatchNorm and the mesh come with the distributed slice)."""

from apex_tpu_torch.parallel.larc import LARC  # noqa: F401
