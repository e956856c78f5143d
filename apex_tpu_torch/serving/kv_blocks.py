"""Paged KV cache: fixed-size blocks in one pool updated in place, host
free list, per-slot block tables — refcounted, with copy-on-write sharing
and a block-level prefix cache.

Line-for-line port of ``apex_tpu/serving/kv_blocks.py`` (plain numpy host
code; the allocation order, tables, refcounts and evictions are held
identical to the reference's by ``tests/test_torch_kv_blocks.py``).

The contiguous engine allocates ``batch × max_s`` cache rows up front —
every admitted request pays for the LONGEST possible sequence whether it
uses 30 tokens or 3000. Paging breaks the cache into fixed-size blocks
(``block_size`` tokens each) living in ONE pre-allocated pool

    {"k"/"v": (layers, num_blocks, kv_heads, block_size, head_dim)}

and gives each slot a BLOCK TABLE mapping its logical kv blocks to pool
indices. Memory is then bound by live tokens (rounded up to the block),
the pool's shape never changes, and admit/evict is pure host bookkeeping:
allocate/free block ids and rewrite a table row — the device tensors are
never reshaped.

Device-side consumers resolve the indirection two ways: the CUDA decode
kernel reads each slot's table row and offsets its loads by it
(:func:`apex_tpu_torch.ops.decode_attention.paged_decode_attn_cuda`); the
plain version gathers the table into the contiguous view. Both are driven
through ``decode_attention(..., block_tables=)``.

Block 0 is the reserved **dead block**: never allocated, it absorbs the
writes of inactive slots and backs every unused table entry, so the
device step needs no masking branches for slots that do not exist —
their writes land somewhere harmless and their columns are length-masked
anyway. All bookkeeping here is plain host Python/numpy.

**Sharing (serving tier 2).** Blocks carry a REFCOUNT: N requests with
a common prompt prefix map their table rows onto the same physical
blocks (:meth:`BlockAllocator.retain` per extra reference;
:meth:`BlockAllocator.free` decrements and only returns a block to the
free list when the last reference drops). Sharing is copy-on-write in
the only form a paged prompt cache needs: shared blocks hold IMMUTABLE
full blocks of prompt k/v and are never write targets — a request that
must (re)compute rows inside a block it would otherwise share gets a
private block and recomputes the content into it (the "copy" IS the
prefill of that block, which runs anyway; no device copy program
exists, so the two-executable contract is untouched). The scheduler
enforces the never-write-shared invariant structurally: writes land
strictly past a slot's shared prefix.

:class:`PrefixCache` is the index that makes sharing findable: full
prompt blocks are keyed by their CONTENT CHAIN — ``(parent entry,
block's token tuple)`` — so a key equality means the entire token
prefix up to and including this block is identical. Lookups bucket by
hash but always compare the FULL key (a hash collision can never alias
two different prefixes onto one cache block). The cache holds one
refcount on every resident block (so a warm cache survives its
requests) and releases LRU leaves under pool pressure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# pool index every unused table entry and every inactive-slot write
# resolves to; excluded from the free list forever
DEAD_BLOCK = 0


def blocks_needed(tokens: int, block_size: int) -> int:
    """Blocks covering ``tokens`` cache rows: ceil(tokens / block_size)."""
    return -(-int(tokens) // int(block_size))


class BlockAllocator:
    """Host-side refcounted free list over pool blocks ``[1, num_blocks)``.

    LIFO reuse (a just-freed block is hottest in cache and cheapest to
    re-load) with double-free/foreign-id checks — an allocator bug here
    would silently cross-wire two requests' caches, so it must be loud.

    **Refcounts.** :meth:`allocate` hands out blocks at refcount 1;
    :meth:`retain` adds a reference (a second request sharing a prefix
    block, or the :class:`PrefixCache` keeping one resident);
    :meth:`free` DECREMENTS, and a block only physically returns to the
    free list when its count reaches zero. ``alloc_total`` /
    ``free_total`` count PHYSICAL pool transitions (pop off / return to
    the free list), so the :attr:`leaked` identity
    ``alloc_total - free_total - num_live == 0`` stays refcount-exact:
    retains never drift it, and over-freeing a shared block past its
    refcount is still a loud double free (the block leaves ``_live`` at
    zero, so the next free raises).

    **Residency.** :meth:`mark_resident` flags blocks whose reference
    is held by the prefix cache rather than a live request. The leak
    detectors subtract :attr:`num_resident` from ``num_live`` when the
    engine is idle — a warm prefix cache is capacity doing its job, not
    a leak.

    Accounting for the serving telemetry: lifetime
    ``alloc_total`` / ``free_total`` counters, the monotone
    ``high_water`` of live blocks, the :attr:`leaked` witness, and
    :meth:`fragmentation_pct` over the free list. All host-side ints;
    the counters never change allocation behavior.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"the pool needs >= 2 blocks (block {DEAD_BLOCK} is the "
                f"reserved dead block); got num_blocks={num_blocks}")
        self.num_blocks = int(num_blocks)
        # ascending pop order on a fresh pool: low ids first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._live: set = set()
        self._ref: Dict[int, int] = {}   # live block id -> refcount >= 1
        self._resident: set = set()      # live blocks the cache pins
        self.alloc_total = 0
        self.free_total = 0
        self.high_water = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._live)

    @property
    def num_resident(self) -> int:
        """Live blocks whose reference is the prefix cache's (marked by
        :meth:`mark_resident`) — warm capacity, not demand."""
        return len(self._resident)

    @property
    def leaked(self) -> int:
        """Blocks the physical counters cannot account for: every pop
        off the free list is matched by a return or is still live, so
        this is exactly zero unless ``_free``/``_live`` were mutated
        outside the API (the silent-corruption case the telemetry must
        make loud). Refcount churn (retain/partial free) never moves
        it: only the 1→0 transition counts as a physical free."""
        return self.alloc_total - self.free_total - self.num_live

    def refcount(self, bid: int) -> int:
        """Current reference count of ``bid`` (0 when not live)."""
        return self._ref.get(int(bid), 0)

    def is_shared(self, bid: int) -> bool:
        """More than one reference — a write target must copy first
        (for immutable prompt blocks: recompute into a private block)."""
        return self._ref.get(int(bid), 0) > 1

    def check_accounting(self) -> None:
        """Raise ``RuntimeError`` if the pool invariants broke: a block
        lost to both lists, a block on both, counter drift, or a
        refcount that disagrees with liveness (every live block must
        hold a count >= 1, exactly the live set must be counted, and
        resident blocks must be live)."""
        overlap = self._live.intersection(self._free)
        missing = (self.num_blocks - 1) - self.num_free - self.num_live
        bad_ref = (set(self._ref) != self._live
                   or any(c < 1 for c in self._ref.values()))
        stray_resident = self._resident - self._live
        if overlap or missing or self.leaked or bad_ref or stray_resident:
            raise RuntimeError(
                f"block pool accounting broken: leaked={self.leaked}, "
                f"{missing} block(s) on neither list, "
                f"{len(overlap)} on both, refcounts "
                f"{'corrupt' if bad_ref else 'ok'}, "
                f"{len(stray_resident)} resident-but-not-live — "
                f"free/live/ref were mutated outside the allocator API")

    def fragmentation_pct(self) -> float:
        """Free-list fragmentation: 100 * (1 - 1/runs) where ``runs``
        counts maximal runs of consecutive block ids among the free
        blocks — 0 when the free ids form one contiguous range (the
        fresh-pool state), approaching 100 as reuse shreds it. Purely
        diagnostic: paging is indirection-oblivious, but a shredded
        free list means future requests' blocks scatter across the
        pool (worse load locality on the gather path)."""
        if not self._free:
            return 0.0
        ids = sorted(self._free)
        runs = 1 + sum(1 for a, b in zip(ids, ids[1:]) if b != a + 1)
        return 100.0 * (1.0 - 1.0 / runs)

    def allocate(self, n: int = 1) -> List[int]:
        """Pop ``n`` block ids at refcount 1; raises when the pool
        cannot satisfy it (callers make room first — reclaim prefix
        residents, then preempt — so hitting this is a scheduler bug,
        not backpressure)."""
        if n > len(self._free):
            raise RuntimeError(
                f"KV block pool exhausted: requested {n} blocks with "
                f"{len(self._free)} free of {self.num_blocks - 1} "
                f"allocatable — the scheduler should have reclaimed "
                f"prefix-cache residents or preempted a request first")
        ids = [self._free.pop() for _ in range(n)]
        self._live.update(ids)
        for bid in ids:
            self._ref[bid] = 1
        self.alloc_total += n
        if self.num_live > self.high_water:
            self.high_water = self.num_live
        return ids

    def retain(self, ids: Iterable[int]) -> None:
        """Add one reference to each live block in ``ids`` (a request
        mapping its table row onto a shared prefix, or the prefix cache
        pinning a resident block). Retaining a non-live block is loud —
        it would share memory the pool no longer owns."""
        for bid in ids:
            bid = int(bid)
            if bid not in self._live:
                raise ValueError(
                    f"cannot retain block id {bid}: not live")
            self._ref[bid] += 1

    def free(self, ids: Iterable[int]) -> None:
        """Drop one reference per id; a block physically returns to the
        free list (and counts in ``free_total``) only when its last
        reference drops."""
        for bid in ids:
            bid = int(bid)
            if bid == DEAD_BLOCK:
                raise ValueError("cannot free the reserved dead block")
            if bid not in self._live:
                raise ValueError(
                    f"double free / foreign block id {bid} (not live)")
            self._ref[bid] -= 1
            if self._ref[bid] > 0:
                continue  # other holders remain: no physical free
            del self._ref[bid]
            self._live.remove(bid)
            self._resident.discard(bid)
            self._free.append(bid)
            self.free_total += 1

    def mark_resident(self, bid: int) -> None:
        """Flag a live block as prefix-cache-resident (its reference is
        warm capacity, not request demand)."""
        bid = int(bid)
        if bid not in self._live:
            raise ValueError(
                f"cannot mark block id {bid} resident: not live")
        self._resident.add(bid)

    def unmark_resident(self, bid: int) -> None:
        self._resident.discard(int(bid))


class BlockTables:
    """Per-slot block tables: ``(num_slots, max_blocks)`` int32 host
    array, every unused entry pinned at :data:`DEAD_BLOCK`. The device
    step receives a copy each call (same shape every time — the contents
    churn, the shape never does)."""

    def __init__(self, num_slots: int, max_blocks: int):
        self.num_slots = int(num_slots)
        self.max_blocks = int(max_blocks)
        self._table = np.zeros((self.num_slots, self.max_blocks), np.int32)

    def assign(self, slot: int, logical_idx: int, block_id: int) -> None:
        self._table[slot, logical_idx] = block_id

    def row(self, slot: int) -> np.ndarray:
        return self._table[slot]

    def clear(self, slot: int) -> None:
        self._table[slot] = DEAD_BLOCK

    def asarray(self) -> np.ndarray:
        """The full (num_slots, max_blocks) table (a view; callers hand
        it to torch.tensor, which copies it to the device)."""
        return self._table


@dataclasses.dataclass
class _PrefixEntry:
    """One cached full block: ``(parent, tokens)`` is the FULL identity
    key (parent entry ids are never reused, and the parent was itself
    verified on lookup, so key equality == the whole token prefix up to
    and including this block is identical)."""

    eid: int               # unique, monotonically assigned, never reused
    parent_eid: int        # 0 = root (this is the prompt's first block)
    tokens: Tuple[int, ...]
    block_id: int
    nchildren: int = 0     # live child entries (only leaves are evictable)
    stamp: int = 0         # LRU recency (cache-wide monotone tick)
    # provenance: the trace id of the request whose prefill indexed this
    # block — a later request's prefix hit can name which request paid
    # for the warm block it rode (pure bookkeeping, not identity)
    created_by: Optional[str] = None


#: parent id of a prompt's first block (entry ids start at 1)
ROOT_EID = 0


class PrefixCache:
    """Block-level prefix index: chained full-token keys → physical
    pool blocks, LRU-evicted under pool pressure.

    N requests sharing a system prompt :meth:`match` the same chain of
    entries, retain the underlying blocks, and skip those prefill
    chunks entirely — TTFT on a hit collapses to the unshared tail.
    The cache holds ONE refcount of its own on every indexed block
    (``mark_resident``), so a warm prefix survives the requests that
    built it; :meth:`reclaim` releases least-recently-used LEAF entries
    whose block nobody else references when the pool needs room.

    **Collision safety.** Lookups bucket by :meth:`_hash` but a hit is
    only declared after comparing the FULL ``(parent_eid, tokens)``
    key — two different token blocks (or the same tokens under
    different prefixes) can never alias one physical block, no matter
    how the hash behaves (pinned by the forced-collision test).

    **Leaf-first eviction.** A child entry is only reachable through
    its parent (lookups walk the chain from the prompt's first block),
    so evicting an inner entry would strand its subtree as unreachable
    resident blocks. ``nchildren`` tracks live children; only entries
    with none are eviction candidates. An entry whose block some
    request still references (refcount > 1) is never reclaimed — and
    because a request retains its shared prefix contiguously from
    block 0, a pinned descendant implies a pinned ancestor, which
    makes :meth:`reclaimable` (the count of refcount-1 entries) exact.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 capacity_blocks: Optional[int] = None):
        self.allocator = allocator
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size}")
        self.capacity_blocks = (None if capacity_blocks is None
                                else int(capacity_blocks))
        self._buckets: Dict[int, List[_PrefixEntry]] = {}
        self._by_eid: Dict[int, _PrefixEntry] = {}
        self._next_eid = ROOT_EID + 1
        self._tick = 0
        # block-level lookup accounting (the prefix_hit_rate numerator/
        # denominator the serve record carries)
        self.block_hits = 0
        self.block_queries = 0
        self.inserts = 0
        self.evictions = 0

    # --- identity ------------------------------------------------------------

    def _hash(self, parent_eid: int, tokens: Tuple[int, ...]) -> int:
        """Bucket key ONLY — a hit still compares the full key (tests
        override this with a constant to prove collisions cannot
        alias)."""
        return hash((parent_eid, tokens))

    def _find(self, parent_eid: int,
              tokens: Tuple[int, ...]) -> Optional[_PrefixEntry]:
        for e in self._buckets.get(self._hash(parent_eid, tokens), ()):
            # FULL key comparison on every hash hit: collision-safe
            if e.parent_eid == parent_eid and e.tokens == tokens:
                return e
        return None

    # --- queries -------------------------------------------------------------

    @property
    def num_entries(self) -> int:
        return len(self._by_eid)

    @property
    def num_resident_blocks(self) -> int:
        """One block per entry: the warm footprint."""
        return len(self._by_eid)

    def hit_rate(self) -> Optional[float]:
        """Block-level hit rate over every full block queried at
        admission (None before any query)."""
        if not self.block_queries:
            return None
        return self.block_hits / self.block_queries

    def reclaimable(self) -> int:
        """Blocks the cache could free right now: entries whose block
        only the cache references. Exact (not an estimate): a request
        pins its shared prefix contiguously from block 0, so a
        refcount-1 entry's whole subtree is refcount-1 and frees
        leaf-first."""
        return sum(1 for e in self._by_eid.values()
                   if self.allocator.refcount(e.block_id) == 1)

    # --- the serving-side API ------------------------------------------------

    def match(self, prompt: Sequence[int],
              count: bool = True) -> List[_PrefixEntry]:
        """The longest cached chain covering ``prompt``'s full blocks,
        walked left to right (each link verified by full-key compare).
        Stamps matched entries most-recently-used and feeds the
        block-level hit/miss accounting — unless ``count=False``: the
        admission gate's PRE-CHECK, which must be side-effect-free (a
        held-back request retried every step would otherwise both
        double-count the stats and keep its chain pinned MRU against
        ``reclaim`` without ever using it; the gate follows up with
        :meth:`commit_match` when the admission really happens). The
        caller decides how much of the chain to USE (at least the block
        holding the prompt's last token must be recomputed privately —
        its final-row logits seed the first sampled token)."""
        B = self.block_size
        full = len(prompt) // B
        if count:
            self.block_queries += full
        chain: List[_PrefixEntry] = []
        parent = ROOT_EID
        for i in range(full):
            key = tuple(int(t) for t in prompt[i * B:(i + 1) * B])
            e = self._find(parent, key)
            if e is None:
                break
            if count:
                self._tick += 1
                e.stamp = self._tick
            chain.append(e)
            parent = e.eid
        if count:
            self.block_hits += len(chain)
        return chain

    def commit_match(self, prompt: Sequence[int],
                     chain: List[_PrefixEntry]) -> None:
        """The counting/stamping half of :meth:`match`, for a chain
        obtained with ``count=False`` that an admission then really
        used (nothing can mutate the cache between the gate's pre-check
        and the admission — same call, same thread — so re-walking the
        buckets would only duplicate work)."""
        self.block_queries += len(prompt) // self.block_size
        for e in chain:
            self._tick += 1
            e.stamp = self._tick
        self.block_hits += len(chain)

    def insert(self, parent_eid: int, tokens: Sequence[int],
               block_id: int, trace_id: Optional[str] = None) -> int:
        """Index one freshly prefilled full block under its chain key;
        returns the entry id to parent the NEXT block on. If the key is
        already present (two requests raced the same prefix through
        prefill), the existing entry wins and the caller's private
        block is simply not indexed — both copies are live and correct,
        only one is findable. At capacity the LRU leaf is reclaimed
        first; if nothing is reclaimable the block is not indexed
        (bounded residency beats an unbounded warm set). ``trace_id``
        records which request's prefill paid for the block
        (``created_by`` provenance on the entry)."""
        key = tuple(int(t) for t in tokens)
        if len(key) != self.block_size:
            raise ValueError(
                f"prefix cache indexes FULL blocks only: got {len(key)} "
                f"tokens, block_size={self.block_size}")
        if parent_eid != ROOT_EID and parent_eid not in self._by_eid:
            # the parent was reclaimed out from under the caller's
            # chain (capacity pressure from other traffic): an entry
            # under it would be unreachable — skip indexing, and keep
            # returning the dangling eid so the chain stays skipped
            return parent_eid
        found = self._find(parent_eid, key)
        if found is not None:
            self._tick += 1
            found.stamp = self._tick
            return found.eid
        if (self.capacity_blocks is not None
                and self.num_entries >= self.capacity_blocks):
            if self.reclaim(1) < 1:
                # nothing evictable: skip indexing — and return a
                # DANGLING eid (never assigned to an entry), not the
                # still-valid parent: otherwise the slot's NEXT block
                # could insert under its grandparent once capacity
                # frees, mis-keying the content chain (a prompt's
                # second block findable as a first block — exactly the
                # aliasing the chain key exists to prevent)
                self._next_eid += 1
                return self._next_eid - 1
            if parent_eid != ROOT_EID and parent_eid not in self._by_eid:
                return parent_eid  # the reclaim took the parent itself
        self.allocator.retain([block_id])
        self.allocator.mark_resident(block_id)
        self._tick += 1
        e = _PrefixEntry(eid=self._next_eid, parent_eid=int(parent_eid),
                         tokens=key, block_id=int(block_id),
                         stamp=self._tick, created_by=trace_id)
        self._next_eid += 1
        self._buckets.setdefault(self._hash(e.parent_eid, key),
                                 []).append(e)
        self._by_eid[e.eid] = e
        if e.parent_eid != ROOT_EID:
            self._by_eid[e.parent_eid].nchildren += 1
        self.inserts += 1
        return e.eid

    def reclaim(self, n: int) -> int:
        """Release up to ``n`` blocks back to the pool, least-recently-
        used LEAF entries first, skipping any block a request still
        references. Returns the number actually freed. The per-block
        candidate rescan is bounded by the POOL, not by traffic: every
        entry pins a distinct live block, so ``num_entries <
        allocator.num_blocks`` always."""
        freed = 0
        while freed < n:
            candidates = [e for e in self._by_eid.values()
                          if e.nchildren == 0
                          and self.allocator.refcount(e.block_id) == 1]
            if not candidates:
                break
            victim = min(candidates, key=lambda e: e.stamp)
            self._evict(victim)
            freed += 1
        return freed

    def _evict(self, e: _PrefixEntry) -> None:
        bucket = self._buckets[self._hash(e.parent_eid, e.tokens)]
        bucket.remove(e)
        if not bucket:
            del self._buckets[self._hash(e.parent_eid, e.tokens)]
        del self._by_eid[e.eid]
        if e.parent_eid != ROOT_EID and e.parent_eid in self._by_eid:
            self._by_eid[e.parent_eid].nchildren -= 1
        self.allocator.unmark_resident(e.block_id)
        self.allocator.free([e.block_id])
        self.evictions += 1

    def clear(self) -> int:
        """Drop every unpinned entry (leaf-first); returns blocks
        freed. Pinned entries (shared with a live request) stay."""
        return self.reclaim(self.num_entries)
