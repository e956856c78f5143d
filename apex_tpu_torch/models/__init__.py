"""Port of :mod:`apex_tpu.models` (GPT's decode branch)."""

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel  # noqa: F401
