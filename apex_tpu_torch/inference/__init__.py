"""Port of :mod:`apex_tpu.inference`: the KV-cached decode engine for GPT
(prefill through the bshd flash kernel, decode steps through the
contiguous decode kernel, chain and tree speculative decoding through the
verify kernels) and its sampler."""

from apex_tpu_torch.inference.engine import DecodeEngine, SpecStats  # noqa: F401
from apex_tpu_torch.inference.sampling import sample_logits  # noqa: F401
