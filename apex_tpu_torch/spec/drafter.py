"""Drafters for speculative decoding: propose a STATIC ``k`` tokens per
round, cheaply, per stream.

Port of ``apex_tpu/spec/drafter.py`` (``:1-299``). A drafter only
guesses: the verify tail (:func:`apex_tpu_torch.ops.fused_verify`) accepts
exactly the prefix the target model would have produced, so drafter
quality moves the acceptance rate, never the tokens.

* :class:`NGramDrafter` — host-side n-gram lookahead over the stream's own
  context; no device memory.
* :class:`ModelDrafter` — a GPT with its own KV cache per stream, driven
  one greedy token at a time through the port's
  :class:`~apex_tpu_torch.inference.engine.DecodeEngine` at batch 1.

Every drafter here also drives ``ServingEngine.serve(draft=...)``; the
paged model drafter of that path is :class:`~apex_tpu_torch.spec.tree.
PagedModelDrafter`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from apex_tpu_torch.monitor import spans as monitor_spans

__all__ = ["Drafter", "NGramDrafter", "ModelDrafter", "validate_drafter",
           "MAX_DRAFT_K"]

#: bound on the per-round draft length (``drafter.py:50``)
MAX_DRAFT_K = 32


class Drafter:
    """The drafter protocol: ``propose(stream, context)`` returns exactly
    ``self.k`` int32 token ids continuing ``context`` (the stream's prompt
    plus generated tokens so far). ``vocab_size`` is the id space of the
    proposals (``None``: the target's)."""

    k: int = 0
    vocab_size: Optional[int] = None
    #: the paged-pool granularity the drafter's cache rides, when it has
    #: one; None: no block constraint
    block_size: Optional[int] = None

    def propose(self, stream: int,
                context: Sequence[int]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def release(self, stream: int) -> None:
        """Drop per-stream state (request finished); default no-op."""

    def reset(self) -> None:
        """Drop ALL stream state (a fresh serve reusing ids)."""


def validate_drafter(draft: Drafter, config, *, needed_rows: int,
                     cache_rows: Optional[int] = None,
                     block_size: Optional[int] = None) -> int:
    """Eager validation of a drafter against a target config; every
    mismatch raises a knob-naming ``ValueError``. Returns ``draft.k``.
    ``needed_rows`` is the worst-case cache rows a spec round can touch;
    ``cache_rows`` the drafter's own cache capacity (default: its
    ``cache_rows`` attribute); ``block_size`` the target engine's paged
    granularity, checked against a paged drafter's."""
    k = getattr(draft, "k", None)
    if not isinstance(k, int) or not 1 <= k <= MAX_DRAFT_K:
        raise ValueError(
            f"draft.k must be an int in [1, {MAX_DRAFT_K}] (it shapes "
            f"the verify program); got {k!r}")
    dv = getattr(draft, "vocab_size", None)
    if dv is not None and dv != config.vocab_size:
        raise ValueError(
            f"drafter vocab_size ({dv}) != target vocab_size "
            f"({config.vocab_size}) — drafted ids would index a "
            f"different token space; use a drafter model sharing the "
            f"target's tokenizer/vocab")
    db = getattr(draft, "block_size", None)
    if block_size is not None and db is not None and db != block_size:
        raise ValueError(
            f"drafter block_size ({db}) != engine block_size "
            f"({block_size}) — the drafter's paged cache cannot ride "
            f"the engine's block tables; construct the drafter with "
            f"block_size={block_size} (or leave it None)")
    rows = getattr(draft, "cache_rows", None) \
        if cache_rows is None else cache_rows
    if rows is not None and rows < needed_rows:
        raise ValueError(
            f"drafter cache holds {rows} rows but a spec round can "
            f"touch {needed_rows} (prompt + max_new_tokens + k) — "
            f"raise the drafter's max_seq_len to >= {needed_rows}")
    depth = getattr(draft, "depth", None)
    branching = getattr(draft, "branching", None)
    if depth is not None and branching is not None:
        depth, branching = int(depth), int(branching)
        nodes = depth * branching
        if nodes > MAX_DRAFT_K:
            raise ValueError(
                f"draft tree ({branching} branches x depth {depth} = "
                f"{nodes} nodes) exceeds MAX_DRAFT_K={MAX_DRAFT_K} "
                f"verify rows — shrink branching or depth so "
                f"branching x depth <= {MAX_DRAFT_K}")
        if depth + 1 > needed_rows:
            raise ValueError(
                f"draft tree depth ({depth}) + 1 bonus row exceeds the "
                f"per-slot row cap ({needed_rows}) — shrink the drafter's "
                f"depth to <= {needed_rows - 1} or raise the engine's "
                f"max_seq_len")
        chain_k = getattr(draft, "chain_k", k)
        if not isinstance(chain_k, int) or not 1 <= chain_k <= depth:
            raise ValueError(
                f"tree drafter chain_k must be an int in [1, depth="
                f"{depth}] (the chain-fallback rung cannot draft deeper "
                f"than the tree); got {chain_k!r}")
    return k


class NGramDrafter(Drafter):
    """Host-side n-gram drafter: per stream, an order-``n`` suffix table
    maps each length-``n`` window of the context to the token that
    followed it (latest occurrence wins); :meth:`propose` walks it ``k``
    steps from the context's tail, repeating the last token on a miss.
    The table updates incrementally from the stream's consumed
    frontier."""

    def __init__(self, k: int = 4, n: int = 3):
        if not 1 <= int(k) <= MAX_DRAFT_K:
            raise ValueError(
                f"NGramDrafter k must be in [1, {MAX_DRAFT_K}], got {k}")
        if int(n) < 1:
            raise ValueError(f"NGramDrafter n must be >= 1, got {n}")
        self.k = int(k)
        self.n = int(n)
        # stream -> (suffix table, consumed context length)
        self._streams: Dict[int, Any] = {}

    def propose(self, stream: int, context: Sequence[int]) -> np.ndarray:
        n = self.n
        table, consumed = self._streams.get(stream, (None, 0))
        if table is None or consumed > len(context):
            table, consumed = {}, 0  # fresh (or shrunk: a reused id)
        ctx = [int(t) for t in context]
        for i in range(max(consumed, n), len(ctx)):
            table[tuple(ctx[i - n:i])] = ctx[i]
        self._streams[stream] = (table, len(ctx))
        window: List[int] = ctx[-n:] if len(ctx) >= n else ctx[:]
        out = []
        for _ in range(self.k):
            guess = table.get(tuple(window[-n:]), window[-1])
            out.append(guess)
            window.append(guess)
        return np.asarray(out, np.int32)

    def release(self, stream: int) -> None:
        self._streams.pop(stream, None)

    def reset(self) -> None:
        self._streams.clear()


class ModelDrafter(Drafter):
    """A GPT drafter: greedy continuations from (usually) a small model,
    one contiguous KV cache per stream.

    It rides the port's :class:`~apex_tpu_torch.inference.engine.
    DecodeEngine` at batch 1 and greedy: context tokens are teacher-forced
    through ``decode_step`` row by row and the k proposals decoded from
    the frontier. Drafted rows land past the trusted frontier and are
    re-written when the stream catches up (length masking IS the rewind).
    ``max_seq_len`` sizes every stream's cache (a multiple of 128; default
    the model's position table rounded up) and must cover the target's
    worst case plus ``k``; the engines check it through
    :func:`validate_drafter`."""

    def __init__(self, model, params, *, k: int = 4,
                 max_seq_len: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        from apex_tpu_torch.inference.engine import DecodeEngine

        if not 1 <= int(k) <= MAX_DRAFT_K:
            raise ValueError(
                f"ModelDrafter k must be in [1, {MAX_DRAFT_K}], got {k}")
        self.k = int(k)
        self.model = model
        self.params = params
        self.vocab_size = int(model.config.vocab_size)
        if max_seq_len is None:
            max_seq_len = ((model.config.max_seq_len + 127) // 128) * 128
        self.engine = DecodeEngine(model, max_seq_len=max_seq_len,
                                   temperature=0.0, device=device)
        self.cache_rows = self.engine.max_s
        # stream -> {"cache": cache dict, "consumed": rows trusted as real}
        self._streams: Dict[int, Dict[str, Any]] = {}

    def _step(self, cache, tok: int, pos: int) -> int:
        tokens = torch.tensor([tok], dtype=torch.int32,
                              device=self.engine.device)
        _, nxt, _ = self.engine.decode_step(self.params, cache, tokens, pos)
        return nxt

    def propose(self, stream: int, context: Sequence[int]) -> np.ndarray:
        st = self._streams.get(stream)
        if st is None or st["consumed"] > len(context):
            st = {"cache": self.engine.init_cache(1), "consumed": 0}
        cache, consumed = st["cache"], st["consumed"]
        ctx = [int(t) for t in context]
        if len(ctx) - 1 + self.k > self.cache_rows:
            raise ValueError(
                f"ModelDrafter cache ({self.cache_rows} rows) cannot "
                f"hold context ({len(ctx)}) + k ({self.k}) draft rows — "
                f"raise max_seq_len")
        # one spec_draft span a round (the decode_step spans nest under
        # it); no-op while monitoring is off
        with monitor_spans.span("spec_draft", stream=int(stream)):
            # teacher-force the unconsumed context rows (every token but
            # the last writes its k/v; its greedy candidate is discarded)
            for i in range(consumed, len(ctx) - 1):
                self._step(cache, ctx[i], i)
            # draft greedily from the frontier, one row further each step
            out = []
            tok = ctx[-1]
            for j in range(self.k):
                tok = int(self._step(cache, tok, len(ctx) - 1 + j)[0])
                out.append(tok)
        st["cache"], st["consumed"] = cache, len(ctx)
        self._streams[stream] = st
        return np.asarray(out, np.int32)

    def release(self, stream: int) -> None:
        self._streams.pop(stream, None)

    def reset(self) -> None:
        self._streams.clear()
