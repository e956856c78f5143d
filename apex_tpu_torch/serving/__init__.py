"""Port of :mod:`apex_tpu.serving`: continuous batching over a paged KV pool,
with request-level telemetry (:class:`ServeTelemetry`) and weight
hot-swap (:meth:`ServingEngine.request_swap`)."""

from apex_tpu_torch.serving.engine import ServeStats, ServingEngine  # noqa: F401
from apex_tpu_torch.serving.kv_blocks import (  # noqa: F401
    DEAD_BLOCK,
    BlockAllocator,
    PrefixCache,
    blocks_needed,
)
from apex_tpu_torch.serving.scheduler import Request, Scheduler, SLOPolicy  # noqa: F401
from apex_tpu_torch.serving.telemetry import ServeTelemetry  # noqa: F401
