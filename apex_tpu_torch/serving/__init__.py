"""Port of :mod:`apex_tpu.serving`: continuous batching over a paged KV pool."""

from apex_tpu_torch.serving.engine import ServeStats, ServingEngine  # noqa: F401
from apex_tpu_torch.serving.scheduler import Request, Scheduler, SLOPolicy  # noqa: F401
