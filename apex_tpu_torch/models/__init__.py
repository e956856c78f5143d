"""Port of :mod:`apex_tpu.models` (GPT at tp=1: training forward and decode
branch)."""

from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,  # noqa: F401
                                       param_leaves)
