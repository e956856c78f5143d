"""Tree speculative decoding, drafter side: static draft-tree topologies,
the n-gram tree drafter, the paged-pool model drafter and the
acceptance-adaptive shape controller.

Port of ``apex_tpu/spec/tree.py`` (``:67-560``). A draft tree hedges the
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
* :class:`PagedModelDrafter` — a small GPT drafter whose KV blocks come
  from the serving scheduler's own
  :class:`~apex_tpu_torch.serving.kv_blocks.BlockAllocator` (one refcount
  ledger with the target's streams, freed through the same preempt and
  finish paths); its device side is an inner batch-1
  :class:`~apex_tpu_torch.serving.engine.ServingEngine` over a pool in
  the drafter's geometry, indexed by the shared block ids.
* :class:`AdaptiveSpecController` — per-stream windowed acceptance → a
  (depth, branching) choice from a small static set (host code only).

``chain_k`` (the chain-fallback rung's draft length, ``depth`` on both
drafters here) and the ``shape`` override of ``propose_tree`` serve
``ServingEngine.serve``'s tree → chain → plain ladder and the
controller's per-round choice.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.monitor import spans as monitor_spans
from apex_tpu_torch.spec.drafter import MAX_DRAFT_K, Drafter

__all__ = ["DraftTree", "draft_tree", "NGramTreeDrafter", "PagedModelDrafter",
           "AdaptiveSpecController", "is_tree_drafter"]


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
    seed from the runner-ups of the FIRST position. ``chain_k`` (also
    ``k``) is the chain-fallback rung's draft length: ``depth``."""

    def __init__(self, depth: int = 4, branching: int = 2, n: int = 3):
        draft_tree(branching, depth)  # eager shape validation
        self.depth = int(depth)
        self.branching = int(branching)
        self.k = self.chain_k = self.depth
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

    def propose_tree(self, stream: int, context: Sequence[int],
                     shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Node tokens for the :class:`DraftTree` topology, drafted-node
        order (``shape=(depth, branching)`` overrides the static shape:
        the adaptive controller's per-round choice)."""
        depth, branching = shape or (self.depth, self.branching)
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

    def reset(self) -> None:
        self._streams.clear()


class PagedModelDrafter(Drafter):
    """A small-model drafter whose per-stream KV cache lives in the SHARED
    paged pool: block ids come from the serving scheduler's own
    :class:`~apex_tpu_torch.serving.kv_blocks.BlockAllocator`, so drafter
    blocks count against the same capacity, show in
    ``check_accounting()``, and free through the same eviction path (the
    scheduler calls :meth:`evict_stream` from its preempt and finish
    paths; a resumed stream's context re-grows token-identically, so the
    ``consumed`` frontier rebuilds by replay).

    The device side is an inner batch-1 :class:`~apex_tpu_torch.serving.
    engine.ServingEngine` over a pool in the drafter's geometry indexed
    by the shared block ids, stepped greedily one token at a time through
    its ``decode_step`` (no generator): context rows teacher-force
    through it and branch ``b`` drafts greedily from the frontier logits'
    ``b``-th candidate (ties to the lowest index). Scratch rows past the
    trusted frontier are re-written next round (length masking is the
    rewind). :meth:`bind` wires the drafter to a scheduler;
    ``ServingEngine.serve`` calls it. ``device`` is the inner engine's
    (default the card)."""

    def __init__(self, model, params, *, depth: int = 4,
                 branching: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        draft_tree(branching, depth)  # eager shape validation
        self.depth = int(depth)
        self.branching = int(branching)
        self.k = self.chain_k = self.depth
        self.model = model
        self.params = params
        self.device = device
        self.vocab_size = int(model.config.vocab_size)
        self.block_size: Optional[int] = None  # set at bind
        self.cache_rows: Optional[int] = None  # set at bind
        self._engine = None
        self._pool = None
        self._sched = None
        self._alloc = None
        # stream -> {"table": (max_blocks,) int32, "block_ids": [...],
        #            "n_blocks": int, "consumed": int}
        self._streams: Dict[int, Dict[str, Any]] = {}
        # high-water of live drafter blocks in the shared pool
        self.peak_blocks = 0
        # inner decode steps run: one drafter forward each
        self.steps = 0

    @property
    def tree(self) -> DraftTree:
        return draft_tree(self.branching, self.depth)

    def bind(self, scheduler, *, block_size: int) -> None:
        """Attach to ``scheduler``'s allocator (the shared ledger) and
        build the inner paged engine and its drafter-geometry pool over
        the same block-id space. Rebinding to another scheduler first
        releases every stream's blocks against the old one."""
        if self._sched is scheduler:
            return
        from apex_tpu_torch.serving.engine import ServingEngine

        self.reset()  # old blocks go back to the OLD allocator
        self._sched = scheduler
        self._alloc = scheduler.allocator
        self.block_size = int(block_size)
        self._engine = ServingEngine(
            self.model, num_slots=1, block_size=self.block_size,
            prefill_chunk=self.block_size,
            num_blocks=self._alloc.num_blocks, device=self.device)
        self._pool = self._engine.init_pool()
        self.cache_rows = self._engine.max_s
        scheduler.draft_owner = self

    def _require_bound(self) -> None:
        if self._alloc is None:
            raise ValueError(
                "PagedModelDrafter is not bound to a scheduler — its KV "
                "blocks live in the shared pool, so call bind(scheduler, "
                "block_size=...) first (ServingEngine.serve does this "
                "for you)")

    def _ensure_rows(self, st: Dict[str, Any], rows: int) -> None:
        from apex_tpu_torch.serving.kv_blocks import blocks_needed

        need = blocks_needed(rows, self.block_size) - st["n_blocks"]
        if need <= 0:
            return
        if need > self._alloc.num_free:
            raise RuntimeError(
                f"drafter needs {need} pool block(s) with "
                f"{self._alloc.num_free} free — the serve loop's "
                f"headroom check (round_blocks_needed) should have "
                f"degraded this round to chain/plain decode first")
        for bid in self._alloc.allocate(need):
            st["table"][st["n_blocks"]] = bid
            st["block_ids"].append(bid)
            st["n_blocks"] += 1
        self.peak_blocks = max(self.peak_blocks, self.pool_blocks())

    def round_blocks_needed(self, stream: int, context_len: int,
                            depth: Optional[int] = None) -> int:
        """Fresh pool blocks one round of ``depth`` (default the static
        depth) would allocate for this stream: the serve loop's
        drafter-headroom check."""
        from apex_tpu_torch.serving.kv_blocks import blocks_needed

        self._require_bound()
        st = self._streams.get(stream)
        have = st["n_blocks"] if st is not None else 0
        rows = int(context_len) - 1 + (self.depth if depth is None
                                       else int(depth))
        return max(0, blocks_needed(rows, self.block_size) - have)

    def _step(self, st: Dict[str, Any], tok: int, pos: int) -> torch.Tensor:
        """One greedy inner decode step of ``tok`` at row ``pos``: its
        logits (V,) on the inner engine's device."""
        dev = self._engine.device
        self.steps += 1
        _, logits = self._engine.decode_step(
            self.params, self._pool,
            torch.as_tensor(st["table"][None, :], device=dev),
            torch.tensor([tok], dtype=torch.int32, device=dev),
            torch.tensor([pos + 1], dtype=torch.int32, device=dev))
        return logits[0]

    def propose(self, stream: int, context: Sequence[int]) -> np.ndarray:
        return self.propose_tree(stream, context, shape=(self.k, 1))

    def propose_tree(self, stream: int, context: Sequence[int],
                     shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Node tokens for the ``shape`` (default the static one)
        topology, drafted-node order."""
        from apex_tpu_torch.serving.kv_blocks import DEAD_BLOCK

        self._require_bound()
        depth, branching = shape or (self.depth, self.branching)
        st = self._streams.get(stream)
        if st is None or st["consumed"] > len(context):
            if st is not None:  # shrunk context: a reused stream id
                self.evict_stream(stream)
            st = {"table": np.full((self._engine.max_blocks_per_slot,),
                                   DEAD_BLOCK, np.int32),
                  "block_ids": [], "n_blocks": 0, "consumed": 0}
        ctx = [int(t) for t in context]
        rows = len(ctx) - 1 + depth
        if rows > self.cache_rows:
            raise ValueError(
                f"PagedModelDrafter cache ({self.cache_rows} rows) "
                f"cannot hold context ({len(ctx)}) - 1 + depth "
                f"({depth}) draft rows — raise the drafter model's "
                f"max_seq_len (the engines validate this bound at "
                f"wiring time)")
        # registered before allocating, so peak_blocks counts this
        # stream's fresh blocks too
        self._streams[stream] = st
        self._ensure_rows(st, rows)
        with monitor_spans.span("spec_draft", stream=int(stream)):
            # teacher-force the unconsumed context rows
            for i in range(st["consumed"], len(ctx) - 1):
                self._step(st, ctx[i], i)
            # the frontier row: its logits seed every branch, best first
            # (ties to the lowest index, as a stable descending sort)
            frontier = self._step(st, ctx[-1],
                                  len(ctx) - 1).float().clone()
            seeds = []
            for _ in range(min(branching, frontier.numel())):
                j = int(torch.argmax(frontier))
                seeds.append(j)
                frontier[j] = -torch.inf
            out = np.zeros((branching * depth,), np.int32)
            for b in range(branching):
                tok = seeds[min(b, len(seeds) - 1)]
                out[b * depth] = tok
                # continue the branch greedily; its rows overwrite the
                # scratch rows the previous branch used
                for lv in range(1, depth):
                    tok = int(torch.argmax(self._step(st, tok,
                                                      len(ctx) - 1 + lv)))
                    out[b * depth + lv] = tok
        st["consumed"] = len(ctx)
        return out

    def evict_stream(self, stream: int) -> None:
        """Free the stream's drafter blocks through the shared allocator:
        the scheduler calls this from the same preempt and finish paths
        that free the stream's target blocks."""
        st = self._streams.pop(stream, None)
        if st is not None and st["block_ids"]:
            self._alloc.free(st["block_ids"])

    def release(self, stream: int) -> None:
        self.evict_stream(stream)

    def reset(self) -> None:
        for stream in list(self._streams):
            self.evict_stream(stream)

    def pool_blocks(self) -> int:
        """Live drafter blocks in the shared pool."""
        return sum(st["n_blocks"] for st in self._streams.values())


class AdaptiveSpecController:
    """Per-stream acceptance-adaptive (depth, branching) choice from a
    small STATIC set.

    Each stream keeps its last ``window`` rounds' (accepted, depth)
    pairs. When the windowed acceptance (accepted rows per drafted depth)
    reaches ``hi`` the stream steps UP the ``choices`` ladder (ordered
    shallow → deep); at or below ``lo`` it steps DOWN; one adjustment per
    full window (hysteresis). :meth:`set_cap` bounds the ladder's top.
    Host code only."""

    def __init__(self, choices: Sequence[Tuple[int, int]] = (
            (2, 1), (4, 1), (4, 2)), window: int = 6,
            lo: float = 0.45, hi: float = 0.8):
        if not choices:
            raise ValueError("AdaptiveSpecController needs >= 1 choice")
        for d, b in choices:
            draft_tree(b, d)  # eager shape validation for every choice
        self.choices = tuple((int(d), int(b)) for d, b in choices)
        self.window = int(window)
        self.lo, self.hi = float(lo), float(hi)
        # stream -> {"idx": int, "hist": [(accepted, depth)...],
        #            "since": rounds since the last adjustment}
        self._streams: Dict[int, Dict[str, Any]] = {}
        self.adjustments = 0
        # the ladder's ceiling index (set_cap), None: no cap
        self.cap: Optional[int] = None

    def _state(self, stream: int) -> Dict[str, Any]:
        st = self._streams.get(stream)
        if st is None:
            st = {"idx": 0, "hist": [], "since": 0}
            self._streams[stream] = st
        return st

    def choice(self, stream: int) -> Tuple[int, int]:
        """The stream's current (depth, branching)."""
        return self.choices[self._state(stream)["idx"]]

    def round_shape(self, streams: Sequence[int]) -> Tuple[int, int]:
        """One shape for a batched round: the SHALLOWEST live stream's
        choice."""
        if not streams:
            return self.choices[0]
        return self.choices[min(self._state(s)["idx"] for s in streams)]

    def set_cap(self, shape) -> int:
        """Pin the ladder's ceiling to one of ``choices`` (``None`` lifts
        it): streams above the cap clamp down now, and :meth:`note_round`
        never steps past it. Returns the cap index."""
        if shape is None:
            self.cap = None
            return len(self.choices) - 1
        shape = (int(shape[0]), int(shape[1]))
        if shape not in self.choices:
            raise ValueError(
                f"cap shape {shape} is not one of this controller's "
                f"choices {self.choices} — a cap outside the compiled "
                f"set would force a new trace mid-serve")
        self.cap = self.choices.index(shape)
        for st in self._streams.values():
            if st["idx"] > self.cap:
                st["idx"] = self.cap
                st["since"] = 0
        return self.cap

    def note_round(self, stream: int, accepted: int, depth: int) -> None:
        """Feed one round's verdict and maybe adjust the stream's
        choice."""
        st = self._state(stream)
        st["hist"].append((int(accepted), int(depth)))
        if len(st["hist"]) > self.window:
            st["hist"] = st["hist"][-self.window:]
        st["since"] += 1
        if len(st["hist"]) < self.window or st["since"] < self.window:
            return
        drafted = sum(d for _, d in st["hist"])
        rate = sum(a for a, _ in st["hist"]) / max(drafted, 1)
        top = len(self.choices) - 1 if self.cap is None else self.cap
        if rate >= self.hi and st["idx"] < top:
            st["idx"] += 1
            st["since"] = 0
            self.adjustments += 1
        elif rate <= self.lo and st["idx"] > 0:
            st["idx"] -= 1
            st["since"] = 0
            self.adjustments += 1

    def release(self, stream: int) -> None:
        self._streams.pop(stream, None)

    def reset(self) -> None:
        self._streams.clear()
