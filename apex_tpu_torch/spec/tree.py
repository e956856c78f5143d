"""Tree speculative decoding, drafter side: static draft-tree topologies
and the n-gram tree drafter.

Port of ``apex_tpu/spec/tree.py`` (``:67-250``). A draft tree hedges the
first, highest-entropy positions: ``branching`` alternative first tokens,
each continued ``depth`` tokens deep, are scored by the target in ONE
forward, and the tree verify (:func:`apex_tpu_torch.ops.fused_verify_tree`)
emits the deepest fully-accepted root path plus a bonus token.

* :class:`DraftTree` — a fixed topology per ``(branching, depth)``: parent
  pointers, the ancestor-or-self closure (the verify's walk operand and
  the tree-attention mask) and the host walk from a verdict back to
  tokens.
* :class:`NGramTreeDrafter` — the n-gram drafter, branching on the
  runner-up continuations of the first position.

``PagedModelDrafter``, ``AdaptiveSpecController`` and the drafter knobs
they and the serve's tree-to-chain fallback use (``chain_k``, the
``shape`` override of ``propose_tree``) wait for the slice that ports
``ServingEngine.serve(draft=...)``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from apex_tpu_torch.spec.drafter import MAX_DRAFT_K, Drafter

__all__ = ["DraftTree", "draft_tree", "NGramTreeDrafter", "is_tree_drafter"]


class DraftTree:
    """One STATIC draft-tree topology: ``branching`` root branches, each a
    chain of ``depth`` nodes (``branching == 1`` is the chain). Node 0 is
    the committed pending token; drafted node ``1 + b*depth + l`` is
    branch ``b``'s level-``l`` token."""

    def __init__(self, branching: int, depth: int):
        branching, depth = int(branching), int(depth)
        if branching < 1 or depth < 1:
            raise ValueError(
                f"DraftTree needs branching >= 1 and depth >= 1; got "
                f"branching={branching}, depth={depth}")
        if branching * depth > MAX_DRAFT_K:
            raise ValueError(
                f"DraftTree ({branching} branches x depth {depth} = "
                f"{branching * depth} nodes) exceeds MAX_DRAFT_K="
                f"{MAX_DRAFT_K} verify rows — shrink branching or depth "
                f"(branching x depth must be <= {MAX_DRAFT_K})")
        self.branching = branching
        self.depth = depth
        self.num_nodes = branching * depth
        self.n1 = self.num_nodes + 1
        parents = np.zeros((self.n1,), np.int32)
        for b in range(branching):
            for lv in range(depth):
                j = 1 + b * depth + lv
                parents[j] = 0 if lv == 0 else j - 1
        self.parents = parents
        anc = np.zeros((self.n1, self.n1), np.int32)
        anc[0, 0] = 1
        for j in range(1, self.n1):
            anc[j] = anc[parents[j]]
            anc[j, j] = 1
        self.anc = anc

    def path(self, j_star: int) -> List[int]:
        """Node indices of ``j_star``'s root path, root excluded,
        shallow → deep."""
        out = []
        j = int(j_star)
        while j != 0:
            out.append(j)
            j = int(self.parents[j])
        return out[::-1]

    def path_tokens(self, node_tokens: Sequence[int], a: int, j_star: int,
                    next_token: int) -> List[int]:
        """The tokens one tree round emits: the accepted path's drafted
        tokens (``node_tokens[j - 1]`` is node j's) plus the bonus token.
        ``a`` must equal ``j_star``'s depth."""
        nodes = self.path(int(j_star))
        if len(nodes) != int(a):
            raise ValueError(
                f"verify verdict disagrees with the topology: j_star="
                f"{j_star} has depth {len(nodes)} but accept_len={a}")
        return [int(node_tokens[j - 1]) for j in nodes] + [int(next_token)]

    def operands(self, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(parents (batch, N+1), anc (batch, N+1, N+1))`` int32."""
        return (np.tile(self.parents, (batch, 1)),
                np.tile(self.anc, (batch, 1, 1)))


@functools.lru_cache(maxsize=None)
def draft_tree(branching: int, depth: int) -> DraftTree:
    """The cached topology for ``(branching, depth)``."""
    return DraftTree(branching, depth)


def is_tree_drafter(draft) -> bool:
    """A drafter that can propose trees: ``propose_tree`` plus static
    ``depth``/``branching``."""
    return (hasattr(draft, "propose_tree")
            and getattr(draft, "depth", None) is not None
            and getattr(draft, "branching", None) is not None)


class NGramTreeDrafter(Drafter):
    """N-gram drafter with tie-frequency branching: per stream, an
    order-``n`` table maps each context window to every token seen after
    it (count, last position). Branch 0 walks the top candidate like
    :class:`~apex_tpu_torch.spec.drafter.NGramDrafter`; branches 1..
    seed from the runner-ups of the FIRST position. ``k`` is ``depth``:
    the drafted path depth per round."""

    def __init__(self, depth: int = 4, branching: int = 2, n: int = 3):
        draft_tree(branching, depth)  # eager shape validation
        self.depth = int(depth)
        self.branching = int(branching)
        self.k = self.depth
        if int(n) < 1:
            raise ValueError(f"NGramTreeDrafter n must be >= 1, got {n}")
        self.n = int(n)
        # stream -> (window -> token -> (count, last position), consumed)
        self._streams: Dict[int, Any] = {}

    def _table(self, stream: int, context: Sequence[int]):
        n = self.n
        table, consumed = self._streams.get(stream, (None, 0))
        if table is None or consumed > len(context):
            table, consumed = {}, 0  # fresh (or shrunk: a reused id)
        ctx = [int(t) for t in context]
        for i in range(max(consumed, n), len(ctx)):
            stats = table.setdefault(tuple(ctx[i - n:i]), {})
            cnt, _ = stats.get(ctx[i], (0, 0))
            stats[ctx[i]] = (cnt + 1, i)
        self._streams[stream] = (table, len(ctx))
        return table, ctx

    def _candidates(self, table, window: List[int]) -> List[int]:
        """Tokens seen after ``window``, most frequent first (ties to the
        most recent); fallback: repeat the last token."""
        stats = table.get(tuple(window[-self.n:]), None)
        if not stats:
            return [window[-1]]
        return [t for t, _ in sorted(
            stats.items(), key=lambda kv: (-kv[1][0], -kv[1][1]))]

    def _walk(self, table, window: List[int], steps: int) -> List[int]:
        out = []
        w = list(window)
        for _ in range(steps):
            guess = self._candidates(table, w)[0]
            out.append(guess)
            w.append(guess)
        return out

    def propose(self, stream: int, context: Sequence[int]) -> np.ndarray:
        table, ctx = self._table(stream, context)
        window = ctx[-self.n:] if len(ctx) >= self.n else ctx[:]
        return np.asarray(self._walk(table, window, self.k), np.int32)

    def propose_tree(self, stream: int, context: Sequence[int]) -> np.ndarray:
        """Node tokens for the :class:`DraftTree` topology, drafted-node
        order."""
        depth, branching = self.depth, self.branching
        table, ctx = self._table(stream, context)
        window = ctx[-self.n:] if len(ctx) >= self.n else ctx[:]
        cands = self._candidates(table, window)
        out = np.zeros((branching * depth,), np.int32)
        for b in range(branching):
            seed = cands[min(b, len(cands) - 1)]
            chain = [seed] + self._walk(table, window + [seed], depth - 1)
            out[b * depth:(b + 1) * depth] = chain
        return out

    def release(self, stream: int) -> None:
        self._streams.pop(stream, None)
