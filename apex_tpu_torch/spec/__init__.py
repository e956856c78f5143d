"""Port of :mod:`apex_tpu.spec`: the drafter side of speculative decoding
(chain drafters, static draft-tree topologies and the n-gram tree
drafter). The verify tail is :mod:`apex_tpu_torch.ops.fused_verify`; the
rounds run in :class:`apex_tpu_torch.inference.DecodeEngine`."""

from apex_tpu_torch.spec.drafter import (  # noqa: F401
    MAX_DRAFT_K,
    Drafter,
    ModelDrafter,
    NGramDrafter,
    validate_drafter,
)
from apex_tpu_torch.spec.tree import (  # noqa: F401
    DraftTree,
    NGramTreeDrafter,
    draft_tree,
    is_tree_drafter,
)
