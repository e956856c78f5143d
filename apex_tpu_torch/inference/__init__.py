"""Port of :mod:`apex_tpu.inference`: the KV-cached decode engine for GPT
(prefill through the bshd flash kernel, decode steps through the
contiguous decode kernel, chain and tree speculative decoding through the
verify kernels), its sampler, and the encoder-serving entry
(:func:`jit_encoder`: BERT's hidden states and pooler)."""

from apex_tpu_torch.inference.engine import (  # noqa: F401
    DecodeEngine,
    SpecStats,
    jit_encoder,
)
from apex_tpu_torch.inference.sampling import sample_logits  # noqa: F401
