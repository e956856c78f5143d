"""Port of :mod:`apex_tpu.transformer.tensor_parallel` at tp=1."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    masked_mean, vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
