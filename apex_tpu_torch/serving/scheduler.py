"""Continuous-batching request scheduler: fixed slots, paged blocks,
chunked prefill — all host-side bookkeeping.

Port of ``apex_tpu/serving/scheduler.py`` (plain numpy host code):
:class:`Request`, :class:`SLOPolicy`, :class:`PrefillWork` and
:class:`Scheduler`, with the same policies and the same decisions, held
identical to the reference by ``tests/test_torch_kv_blocks.py``. The
device side never sees traffic, only fixed-shape operand *contents*
(tokens, lengths, block tables). The speculative rounds' methods are here
(``decode_batch(lookahead=)``, :meth:`Scheduler.note_spec`,
:meth:`Scheduler.note_spec_tokens`, the ``draft_owner`` whose drafter
blocks free with their stream); the reference's telemetry hooks and
``ReplanPolicy`` are later slices of the port.

Policies:

* **Optimistic FCFS admission against live-token demand.** A request is
  admitted when a slot is free AND the pool (free blocks plus whatever
  the prefix cache could reclaim) covers its FIRST prefill chunk beyond
  any shared prefix — not its worst case. Blocks are allocated lazily
  as tokens land; mid-flight shortfall is handled by preemption.
* **Prefix sharing (copy-on-write).** At admission the prompt's full
  blocks are looked up in the :class:`~apex_tpu_torch.serving.kv_blocks.
  PrefixCache`; hits are retained (refcount + 1) and mapped straight
  into the slot's table row, and prefill RESUMES at the first uncached
  block. At least the block holding the prompt's last token is always
  recomputed privately (its final-row logits seed the first sampled
  token): that recompute IS the copy-on-write.
* **Preemption = evict-and-recompute.** When an in-flight allocation
  cannot be satisfied, the scheduler reclaims prefix-cache residents
  first, then evicts the LOWEST-priority (most recently admitted)
  request, which re-queues at the FRONT with its generated tokens
  intact. On re-admission the generated tokens are teacher-forced
  through prefill, the re-prefill's sampled token is DISCARDED, and
  decode resumes from exactly the pre-eviction state. The OLDEST request
  is never preempted for a younger one's benefit.
* **SLO-aware dispatch.** :class:`SLOPolicy`'s knobs (shortest-prompt
  admission, a wider prefill share) are driven by serving telemetry in
  the reference; without telemetry they keep their defaults.
* **Chunked prefill.** Prompts enter the cache ``prefill_chunk`` tokens
  at a time, interleaved with decode steps.
* **Eviction = free + clear.** A finished request's references go back
  to the allocator and its table row resets to the dead block.
* **Speculative rewind.** A spec round reserves blocks for its drafted
  rows (``lookahead``); :meth:`Scheduler.note_spec_tokens` commits the
  accepted tokens and frees the reservation past the new frontier in
  reverse allocation order, so the allocator's LIFO free list is restored
  exactly.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.serving.kv_blocks import (
    DEAD_BLOCK,
    ROOT_EID,
    BlockAllocator,
    BlockTables,
    PrefixCache,
    blocks_needed,
)


@dataclasses.dataclass
class Request:
    """One generation request plus its serving-side result fields.

    ``arrival_s`` is on the caller's clock (the engine only admits
    requests whose arrival is in the past). The scheduler stamps
    ``admit_s`` / ``first_token_s`` / ``finish_s`` on the same clock and
    appends every sampled token to ``tokens``.
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_s: List[float] = dataclasses.field(default_factory=list)
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    # how many times the request was preempted, and how many full prompt
    # blocks its FIRST admission pulled straight from the prefix cache
    evictions: int = 0
    prefix_hit_blocks: int = 0
    # cache rows live at the moment of the last eviction (sizes the
    # recompute_tokens accounting at re-admission)
    _progress_at_evict: int = 0


@dataclasses.dataclass
class SLOPolicy:
    """SLO-aware dispatch knobs: ``prefer_short_prompts`` flips admission
    to shortest-arrived-prompt-first, ``prefill_share`` runs up to that
    many prefill chunks per engine iteration. Both change only host-side
    dispatch order and repetition."""

    prefill_share: int = 1
    prefer_short_prompts: bool = False


@dataclasses.dataclass
class _Slot:
    """Host state of one batch slot (None request = free)."""

    request: Optional[Request] = None
    prefilled: int = 0   # effective-prompt tokens already in the cache
    length: int = 0      # total cache rows live (prompt + generated-1)
    n_blocks: int = 0    # blocks mapped to this slot (incl. shared)
    block_ids: List[int] = dataclasses.field(default_factory=list)
    last_token: int = 0  # the sampled token the next decode step consumes
    generated: int = 0   # tokens sampled so far
    # the token rows prefill actually runs: the original prompt, plus —
    # after a preemption — the already-generated tokens teacher-forced
    # back in (all but the last, which the resumed decode re-consumes)
    eprompt: Optional[np.ndarray] = None
    registered_blocks: int = 0  # full blocks already offered to the cache
    parent_eid: int = ROOT_EID  # cache-chain parent for the next insert
    resumed: bool = False      # re-admitted mid-generation: discard the
    #                            re-prefill's sampled token

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefill_done(self) -> bool:
        return (self.request is not None and self.eprompt is not None
                and self.prefilled >= len(self.eprompt))


@dataclasses.dataclass
class PrefillWork:
    """One chunk of one slot's prompt: run ``tokens`` (padded to the
    chunk size) at cache positions ``[start, start + live)``."""

    slot: int
    tokens: np.ndarray  # (prefill_chunk,) int32, zero-padded past live
    start: int
    live: int
    is_last: bool
    rid: int = -1


class Scheduler:
    """See the module docstring for the policy; this class is the
    mechanism. Drive it as the engine does::

        sched.admit(now)
        work = sched.next_prefill(now)     # -> PrefillWork | None
        ... run the chunk ...; sched.note_prefill(work, token, now)
        batch = sched.decode_batch(now)    # -> (tokens, lengths) | None
        ... run the step ...; sched.note_decode(sampled, now)
    """

    def __init__(self, *, num_slots: int, block_size: int,
                 max_blocks_per_slot: int, allocator: BlockAllocator,
                 prefill_chunk: int,
                 prefix_cache: Optional[PrefixCache] = None,
                 policy: Optional[SLOPolicy] = None):
        if prefill_chunk < block_size or prefill_chunk % block_size:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must be a positive "
                f"multiple of block_size ({block_size}) — chunks write "
                f"whole blocks")
        if (prefix_cache is not None
                and prefix_cache.allocator is not allocator):
            raise ValueError(
                "prefix_cache must index the scheduler's own allocator "
                "(its retains/releases and the pool's refcounts are one "
                "accounting)")
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        self.prefill_chunk = int(prefill_chunk)
        self.allocator = allocator
        self.prefix_cache = prefix_cache
        self.policy = policy
        self.tables = BlockTables(num_slots, max_blocks_per_slot)
        self._slots = [_Slot() for _ in range(self.num_slots)]
        self._waiting: Deque[Request] = deque()
        # admission order of live slots: prefill picks the oldest first,
        # preemption the YOUNGEST (the tail) — FCFS priority both ways
        self._admit_order: List[int] = []
        self.completed: List[Request] = []
        self.preemptions = 0
        self.recompute_tokens = 0
        # a drafter whose KV blocks live in this allocator
        # (PagedModelDrafter.bind sets it): its evict_stream runs from
        # _finish and _preempt, so drafter blocks free with their stream
        self.draft_owner = None

    # --- capacity accounting -------------------------------------------------

    def _worst_blocks(self, req: Request) -> int:
        # generation leaves the LAST sampled token out of the cache (it
        # is returned, never decoded from), hence the -1
        rows = len(req.prompt) + max(req.max_new_tokens - 1, 0)
        return blocks_needed(rows, self.block_size)

    def _effective_prompt(self, req: Request) -> np.ndarray:
        """The rows prefill must run: the prompt, plus — after a
        preemption mid-generation — every generated token but the last
        teacher-forced back in."""
        if req.tokens:
            return np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.tokens[:-1], np.int32)])
        return np.asarray(req.prompt, np.int32)

    def _make_room(self, need: int, requester: int, now: float) -> bool:
        """Free pool blocks until ``need`` fit: reclaim LRU prefix-cache
        residents first, then preempt the YOUNGEST in-flight request.
        Returns False when the requester itself was the youngest and got
        preempted (the caller skips it this round). Where the reference
        raises (the requester is the only stream left), the requester's
        own drafter blocks are freed first (``draft_owner.evict_stream``:
        the drafter rebuilds them by replay); only then does it raise."""
        alloc = self.allocator
        while alloc.num_free < need:
            if (self.prefix_cache is not None
                    and self.prefix_cache.reclaim(
                        need - alloc.num_free) > 0):
                continue
            victim = self._admit_order[-1] if self._admit_order else None
            if victim is None or (victim == requester
                                  and len(self._admit_order) == 1):
                if victim is not None and self.draft_owner is not None:
                    free = alloc.num_free
                    self.draft_owner.evict_stream(
                        self._slots[victim].request.rid)
                    if alloc.num_free > free:
                        continue
                raise RuntimeError(
                    f"cannot make room for {need} block(s): nothing to "
                    f"reclaim or preempt with {alloc.num_free} free of "
                    f"{alloc.num_blocks - 1} — the pool is too small "
                    f"for a single in-flight request (submit() should "
                    f"have refused it)")
            self._preempt(victim, now)
            if victim == requester:
                return False
        return True

    # --- request intake ------------------------------------------------------

    def submit(self, req: Request) -> None:
        cap = self.max_blocks_per_slot * self.block_size
        rows = len(req.prompt) + max(req.max_new_tokens - 1, 0)
        if len(req.prompt) < 1 or req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: prompt and max_new_tokens must be "
                f">= 1 (the final prefill chunk samples the first token)")
        if rows > cap:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) needs {rows} "
                f"cache rows; a slot holds {cap} "
                f"(max_blocks_per_slot={self.max_blocks_per_slot} x "
                f"block_size={self.block_size})")
        # a request whose worst case exceeds the WHOLE pool could never
        # pass the admission gate: refuse it eagerly instead of stalling
        pool_cap = self.allocator.num_blocks - 1
        need = self._worst_blocks(req)
        if need > pool_cap:
            raise ValueError(
                f"request {req.rid}: worst case needs {need} blocks — "
                f"ceil((prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} - 1) / block_size "
                f"{self.block_size}) — but the pool only has {pool_cap} "
                f"allocatable (num_blocks={self.allocator.num_blocks} "
                f"minus 1 dead block); it could never be admitted. "
                f"Raise num_blocks to >= {need + 1} (worst-case blocks "
                f"+ the dead block) or shorten the request")
        self._waiting.append(req)

    def admit(self, now: float) -> List[int]:
        """Move arrived waiting requests into free slots while the
        OPTIMISTIC gate holds: the pool (free + prefix-cache
        reclaimable) must cover the request's FIRST prefill chunk beyond
        its shared prefix. Order is FCFS, or shortest-arrived-prompt-
        first under ``policy.prefer_short_prompts``. Returns the slots
        admitted this call."""
        B, C = self.block_size, self.prefill_chunk
        admitted = []
        while self._waiting:
            free_slots = [i for i, s in enumerate(self._slots) if s.free]
            if not free_slots:
                break
            arrived = [k for k, r in enumerate(self._waiting)
                       if r.arrival_s <= now]
            if not arrived:
                break
            k = arrived[0]
            if self.policy is not None and self.policy.prefer_short_prompts:
                k = min(arrived, key=lambda j: len(
                    self._waiting[j].prompt) + len(self._waiting[j].tokens))
            req = self._waiting[k]
            ep = self._effective_prompt(req)
            chain = (self.prefix_cache.match(ep, count=False)
                     if self.prefix_cache is not None else [])
            shared = min(len(chain), (len(ep) - 1) // B)
            first_rows = min(shared * B + C, len(ep))
            need = blocks_needed(first_rows, B) - shared
            # reclaimable headroom EXCLUDES the chain blocks this very
            # admission would retain: counting them would admit into
            # guaranteed self-preemption
            self_pinned = sum(
                1 for e in chain[:shared]
                if self.allocator.refcount(e.block_id) == 1)
            headroom = self.allocator.num_free + (
                self.prefix_cache.reclaimable() - self_pinned
                if self.prefix_cache is not None else 0)
            if need > headroom:
                break  # pool pressure: hold order, retry next step
            del self._waiting[k]
            admitted.append(self._admit_one(free_slots[0], req, ep, now,
                                            chain))
        return admitted

    def _admit_one(self, i: int, req: Request, ep: np.ndarray,
                   now: float, chain) -> int:
        """Bind ``req`` to slot ``i``: retain its cached prefix chain into
        the table row, set prefill to resume at the first uncached block,
        and — on a re-admission after preemption — restore the decode
        state so the resumed stream is the unpreempted stream."""
        B = self.block_size
        if self.prefix_cache is not None:
            self.prefix_cache.commit_match(ep, chain)
        # never use a hit on the block holding the prompt's LAST token:
        # its final-row logits seed the first sample
        shared = min(len(chain), (len(ep) - 1) // B)
        slot = _Slot(request=req, eprompt=ep)
        for idx in range(shared):
            bid = chain[idx].block_id
            self.allocator.retain([bid])
            self.tables.assign(i, idx, bid)
            slot.block_ids.append(bid)
        slot.n_blocks = shared
        slot.registered_blocks = shared
        slot.parent_eid = chain[shared - 1].eid if shared else ROOT_EID
        slot.prefilled = shared * B
        slot.length = slot.prefilled
        if req.admit_s is None:
            req.prefix_hit_blocks = shared
        else:
            # evict-and-recompute: rows live at eviction that must be
            # prefilled AGAIN beyond what the cache handed back
            self.recompute_tokens += max(
                0, int(req._progress_at_evict) - shared * B)
        if req.tokens:
            slot.resumed = True
            slot.generated = len(req.tokens)
            slot.last_token = int(req.tokens[-1])
        self._slots[i] = slot
        self._admit_order.append(i)
        req.admit_s = now
        return i

    # --- chunked prefill -----------------------------------------------------

    def next_prefill(self, now: float = 0.0) -> Optional[PrefillWork]:
        """The oldest admitted slot still prefilling → its next chunk
        (allocating the blocks the chunk's LIVE tokens land in, making
        room first under pool pressure). Chunks run over the slot's
        EFFECTIVE prompt and resume at the shared-prefix frontier."""
        for i in list(self._admit_order):
            slot = self._slots[i]
            if slot.request is None or slot.prefill_done:
                continue
            req = slot.request
            ep = slot.eprompt
            start = slot.prefilled
            live = min(self.prefill_chunk, len(ep) - start)
            need = blocks_needed(start + live, self.block_size) - slot.n_blocks
            if need > 0:
                if not self._make_room(need, i, now):
                    continue  # the slot preempted ITSELF: next candidate
                for bid in self.allocator.allocate(need):
                    self.tables.assign(i, slot.n_blocks, bid)
                    slot.block_ids.append(bid)
                    slot.n_blocks += 1
            tokens = np.zeros((self.prefill_chunk,), np.int32)
            tokens[:live] = ep[start:start + live]
            return PrefillWork(
                slot=i, tokens=tokens, start=start, live=live,
                is_last=(start + live >= len(ep)), rid=req.rid)
        return None

    def note_prefill(self, work: PrefillWork, sampled_token: int,
                     now: float) -> List[Request]:
        """Record a finished chunk; on the LAST chunk ``sampled_token`` is
        the request's first generated token — unless the slot is resuming
        after a preemption, whose re-prefill sample is discarded. Freshly
        completed full prompt blocks are offered to the prefix cache.
        Returns requests finished by this call."""
        slot = self._slots[work.slot]
        slot.prefilled += work.live
        slot.length = slot.prefilled
        self._register_prefix_blocks(work.slot)
        if not work.is_last:
            return []
        req = slot.request
        if slot.resumed:
            slot.resumed = False  # back in steady decode
            return []
        slot.last_token = int(sampled_token)
        slot.generated = 1
        req.tokens.append(int(sampled_token))
        req.token_s.append(now)
        req.first_token_s = now
        if slot.generated >= req.max_new_tokens:
            return [self._finish(work.slot, now)]
        return []

    def _register_prefix_blocks(self, i: int) -> None:
        """Offer every freshly completed FULL effective-prompt block to
        the prefix cache, chained on the slot's verified parent."""
        if self.prefix_cache is None:
            return
        slot = self._slots[i]
        B = self.block_size
        full = min(slot.prefilled // B, len(slot.eprompt) // B)
        for idx in range(slot.registered_blocks, full):
            slot.parent_eid = self.prefix_cache.insert(
                slot.parent_eid, slot.eprompt[idx * B:(idx + 1) * B],
                slot.block_ids[idx])
            slot.registered_blocks = idx + 1

    # --- decode --------------------------------------------------------------

    def decoding_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots)
                if s.request is not None and s.prefill_done]

    def decode_batch(self, now: float = 0.0, lookahead: int = 0
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The next decode step's host operands: ``(tokens, lengths)``
        over the full slot array — ``lengths[i]`` counts live rows
        INCLUDING slot i's incoming token (0 marks a dead slot). Allocates
        the new block when a slot crosses a block boundary, visiting slots
        OLDEST-FIRST so that under pool pressure the youngest yields.
        None when nothing is decoding. ``lookahead`` reserves blocks for
        that many EXTRA rows past the incoming token: a speculative
        round's drafted rows (:meth:`note_spec_tokens` rewinds the
        reservation to the accepted frontier)."""
        tokens = np.zeros((self.num_slots,), np.int32)
        lengths = np.zeros((self.num_slots,), np.int32)
        any_live = False
        for i in list(self._admit_order):
            slot = self._slots[i]
            if slot.request is None or not slot.prefill_done:
                continue
            need = blocks_needed(slot.length + 1 + lookahead,
                                 self.block_size) - slot.n_blocks
            if need > 0:
                if not self._make_room(need, i, now):
                    continue  # the slot preempted ITSELF this round
                for bid in self.allocator.allocate(need):
                    self.tables.assign(i, slot.n_blocks, bid)
                    slot.block_ids.append(bid)
                    slot.n_blocks += 1
            tokens[i] = slot.last_token
            lengths[i] = slot.length + 1
            any_live = True
        if not any_live:
            return None
        return tokens, lengths

    def note_spec(self, drafted: np.ndarray, accepted: np.ndarray,
                  next_tokens: np.ndarray, now: float) -> List[Request]:
        """Record one CHAIN speculative round: per decoding slot, the
        accepted draft prefix plus the corrected token, committed through
        :meth:`note_spec_tokens`."""
        emitted = {}
        for i in self.decoding_slots():
            a = int(accepted[i])
            emitted[i] = [int(t) for t in drafted[i][:a]] \
                + [int(next_tokens[i])]
        return self.note_spec_tokens(emitted, now)

    def note_spec_tokens(self, emitted_by_slot: Dict[int, List[int]],
                         now: float) -> List[Request]:
        """Commit one speculative round's emissions (a chain prefix or a
        tree path, already per-slot token lists) capped at each request's
        remaining budget, and REWIND the block tables to the accepted
        frontier: blocks reserved past ``blocks_needed(new length)`` free
        in reverse allocation order (the allocator's LIFO free list is
        restored exactly; an all-rejected round leaves tables, lengths and
        free list as a plain decode step would) and their table entries
        reset to the dead block. A round's tokens share one timestamp.
        Returns requests finished by the round."""
        finished = []
        B = self.block_size
        for i, emitted in emitted_by_slot.items():
            slot = self._slots[i]
            req = slot.request
            emitted = emitted[:req.max_new_tokens - slot.generated]
            m = len(emitted)
            req.tokens.extend(emitted)
            req.token_s.extend([now] * m)
            slot.generated += m
            slot.length += m
            slot.last_token = emitted[-1]
            keep = blocks_needed(slot.length, B)
            while slot.n_blocks > keep:
                bid = slot.block_ids.pop()
                slot.n_blocks -= 1
                self.tables.assign(i, slot.n_blocks, DEAD_BLOCK)
                self.allocator.free([bid])
            if slot.generated >= req.max_new_tokens:
                finished.append(self._finish(i, now))
        return finished

    def note_decode(self, sampled: np.ndarray, now: float) -> List[Request]:
        """Record one decode step's samples; returns requests finished
        (and evicted) by it."""
        finished = []
        for i in self.decoding_slots():
            slot = self._slots[i]
            slot.length += 1
            slot.last_token = int(sampled[i])
            slot.generated += 1
            req = slot.request
            req.tokens.append(int(sampled[i]))
            req.token_s.append(now)
            if slot.generated >= req.max_new_tokens:
                finished.append(self._finish(i, now))
        return finished

    # --- eviction ------------------------------------------------------------

    def _finish(self, i: int, now: float) -> Request:
        slot = self._slots[i]
        req = slot.request
        req.finish_s = now
        self.allocator.free(slot.block_ids)
        if self.draft_owner is not None:
            # the stream's drafter blocks free through the same path
            self.draft_owner.evict_stream(req.rid)
        self.tables.clear(i)
        self._slots[i] = _Slot()
        self._admit_order.remove(i)
        self.completed.append(req)
        return req

    def _preempt(self, i: int, now: float) -> Request:
        """Evict-and-recompute: release slot ``i``'s block references and
        re-queue the request at the FRONT of the waiting line with its
        generated tokens intact."""
        slot = self._slots[i]
        req = slot.request
        req.evictions += 1
        req._progress_at_evict = (slot.length if slot.prefill_done
                                  else slot.prefilled)
        self.preemptions += 1
        self.allocator.free(slot.block_ids)
        if self.draft_owner is not None:
            # the drafter's frontier rebuilds by replay on re-admission
            self.draft_owner.evict_stream(req.rid)
        self.tables.clear(i)
        self._slots[i] = _Slot()
        self._admit_order.remove(i)
        self._waiting.appendleft(req)
        return req

    def blocks_held(self, i: int) -> int:
        """Pool blocks currently allocated to slot ``i``."""
        return self._slots[i].n_blocks

    def slot_length(self, i: int) -> int:
        """Live cache rows of slot ``i`` (the spec round's headroom check
        reads this before reserving draft rows)."""
        return self._slots[i].length

    def slot_rid(self, i: int) -> int:
        """Request id bound to slot ``i`` (the drafter's stream key)."""
        return self._slots[i].request.rid

    def slot_context(self, i: int) -> List[int]:
        """Slot ``i``'s TRUE token stream — prompt plus every generated
        token — the context the drafter continues (not the effective
        prompt: a resumed stream is the unpreempted stream, so the
        drafter's frontier survives eviction)."""
        req = self._slots[i].request
        return [int(t) for t in req.prompt] + list(req.tokens)

    # --- state queries -------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(1 for s in self._slots if s.request is not None)

    def idle(self) -> bool:
        """No request anywhere: waiting empty and every slot free."""
        return not self._waiting and self.num_active == 0
