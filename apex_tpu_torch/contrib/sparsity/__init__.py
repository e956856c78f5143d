"""ASP — automatic structured (2:4) sparsity.

Port of ``apex_tpu/contrib/sparsity`` (``apex.contrib.sparsity``): the 2:4
masks (``masklib``), the channel-permutation search (``permutation``) and
:class:`ASP`, which computes and applies the masks and wraps an optimizer
so pruned entries stay 0.
"""

from apex_tpu_torch.contrib.sparsity.asp import ASP  # noqa: F401
from apex_tpu_torch.contrib.sparsity.masklib import (  # noqa: F401
    create_mask,
    mask_2to4_best,
)
from apex_tpu_torch.contrib.sparsity.permutation import (  # noqa: F401
    apply_permutation,
    exhaustive_search,
    greedy_swap_search,
    invert_permutation,
    search_for_good_permutation,
    sum_after_2_to_4,
)
