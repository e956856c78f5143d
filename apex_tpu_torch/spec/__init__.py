"""Port of :mod:`apex_tpu.spec`: the drafter side of speculative decoding
(chain drafters, static draft-tree topologies, the n-gram tree drafter,
the paged-pool model drafter and the adaptive shape controller). The
verify tail is :mod:`apex_tpu_torch.ops.fused_verify`; the rounds run in
:class:`apex_tpu_torch.inference.DecodeEngine` (batch 1, the contiguous
cache) and in :meth:`apex_tpu_torch.serving.ServingEngine.serve` (every
slot at once over the paged pool, degrading tree → chain → plain on
headroom)."""

from apex_tpu_torch.spec.drafter import (  # noqa: F401
    MAX_DRAFT_K,
    Drafter,
    ModelDrafter,
    NGramDrafter,
    validate_drafter,
)
from apex_tpu_torch.spec.tree import (  # noqa: F401
    AdaptiveSpecController,
    DraftTree,
    NGramTreeDrafter,
    PagedModelDrafter,
    draft_tree,
    is_tree_drafter,
)
