"""The speculative rounds' host side against the JAX reference, on the
CPU: the scheduler's ``decode_batch(lookahead=)``, ``note_spec`` and
``note_spec_tokens`` (commit and LIFO rewind) with a drafter owner, the
``AdaptiveSpecController`` and ``validate_drafter``'s checks. All of it is
host code on both sides, so everything must be equal exactly: block
tables, live lengths, the free list (in order), the blocks each slot
holds, the emitted tokens, the finished requests and the drafter
evictions, after every call of a scripted sequence.
"""

import numpy as np
import pytest

from apex_tpu.serving.kv_blocks import BlockAllocator as JBlockAllocator
from apex_tpu.serving.kv_blocks import PrefixCache as JPrefixCache
from apex_tpu.serving.scheduler import Request as JRequest
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu.spec import AdaptiveSpecController as JAdaptive
from apex_tpu.spec import validate_drafter as jvalidate
from apex_tpu_torch.serving.kv_blocks import BlockAllocator, PrefixCache
from apex_tpu_torch.serving.scheduler import Request, Scheduler
from apex_tpu_torch.spec import AdaptiveSpecController, validate_drafter

B, CHUNK, MAX_BLOCKS = 16, 16, 8


class _Owner:
    """A drafter owner: records the streams the scheduler evicts."""

    def __init__(self):
        self.evicted = []

    def evict_stream(self, rid):
        self.evicted.append(int(rid))


def _pair(num_blocks):
    out = []
    for Alloc, Cache, Sched in ((JBlockAllocator, JPrefixCache, JScheduler),
                                (BlockAllocator, PrefixCache, Scheduler)):
        alloc = Alloc(num_blocks)
        sched = Sched(num_slots=2, block_size=B,
                      max_blocks_per_slot=MAX_BLOCKS, allocator=alloc,
                      prefill_chunk=CHUNK, prefix_cache=Cache(alloc, B))
        sched.draft_owner = _Owner()
        out.append(sched)
    return out


def _state(s):
    slots = range(s.num_slots)
    return (s.tables.asarray().tolist(), list(s.allocator._free),
            sorted(s.allocator._live),
            [s.blocks_held(i) for i in slots],
            [s.slot_length(i) if s._slots[i].request is not None else -1
             for i in slots],
            [(r.rid, [int(t) for t in r.tokens]) for r in s.completed],
            list(s.draft_owner.evicted), s.preemptions)


def _same(j, t, what):
    assert _state(t) == _state(j), what


def _submit(pair, prompts, new):
    for i, (p, n) in enumerate(zip(prompts, new)):
        pair[0].submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
        pair[1].submit(Request(rid=i, prompt=p, max_new_tokens=n))


def _prefill_all(pair):
    j, t = pair
    j.admit(0.0)
    t.admit(0.0)
    _same(j, t, "admit")
    while True:
        wj, wt = j.next_prefill(0.0), t.next_prefill(0.0)
        assert (wj is None) == (wt is None)
        if wj is None:
            return
        assert (wj.slot, wj.start, wj.live, wj.is_last) == \
            (wt.slot, wt.start, wt.live, wt.is_last)
        np.testing.assert_array_equal(wj.tokens, wt.tokens)
        j.note_prefill(wj, 100 + wj.rid, 0.0)
        t.note_prefill(wt, 100 + wt.rid, 0.0)
        _same(j, t, f"prefill {wj.rid}@{wj.start}")


def _batch(pair, lookahead):
    bj = pair[0].decode_batch(0.0, lookahead=lookahead)
    bt = pair[1].decode_batch(0.0, lookahead=lookahead)
    assert (bj is None) == (bt is None)
    if bj is not None:
        for x, y in zip(bj, bt):
            np.testing.assert_array_equal(x, y)
    _same(*pair, f"decode_batch(lookahead={lookahead})")
    return bt


def test_scripted_spec_rounds_match_reference():
    """Slot 0's 14-token prompt puts its 4-row reservation across the
    16-row block boundary; an all-rejected chain round, a partly accepted
    one crossing the boundary, a tree round committed as token lists, a
    plain step between them, and rounds past a request's budget (capped,
    finishing it and evicting its drafter stream)."""
    pair = _pair(num_blocks=12)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 14).astype(np.int32),
               rng.integers(0, 256, 30).astype(np.int32)]
    _submit(pair, prompts, new=[12, 9])
    _prefill_all(pair)
    k = 4
    free_before = list(pair[1].allocator._free)
    tables_before = pair[1].tables.asarray().copy()
    # 1: every draft rejected: the reservation rewinds to a plain step's
    _batch(pair, k)
    drafted = rng.integers(0, 256, (2, k)).astype(np.int32)
    for s in pair:
        s.note_spec(drafted, np.array([0, 0]), np.array([7, 8]), 0.0)
    _same(*pair, "all rejected")
    # each slot's reservation crossed into one more block; both rewound
    # (each slot's in reverse allocation order, the slots in slot order)
    assert sorted(pair[1].allocator._free) == sorted(free_before)
    assert (pair[1].tables.asarray() == tables_before).all()
    # 2: slot 0 accepts all 4 and crosses the boundary, slot 1 accepts 2
    _batch(pair, k)
    for s in pair:
        s.note_spec(drafted, np.array([4, 2]), np.array([9, 10]), 0.0)
    _same(*pair, "partial")
    # 3: a plain step between rounds
    _batch(pair, 0)
    for s in pair:
        s.note_decode(np.array([11, 12]), 0.0)
    _same(*pair, "plain")
    # 4: a tree round of depth 3, committed as emitted token lists
    _batch(pair, 3)
    for s in pair:
        s.note_spec_tokens({0: [1, 2, 3], 1: [4]}, 0.0)
    _same(*pair, "tree")
    # 5: rounds until both finish; emissions past the budget are capped
    for step in range(6):
        if _batch(pair, k) is None:
            break
        for s in pair:
            s.note_spec(drafted, np.array([4, 4]), np.array([5, 6]), 0.0)
        _same(*pair, f"round {step}")
    assert [r.rid for r in pair[1].completed] == [0, 1]
    assert [len(r.tokens) for r in pair[1].completed] == [12, 9]
    assert pair[1].draft_owner.evicted == [0, 1]
    pair[1].allocator.check_accounting()


def test_preemption_evicts_the_drafter_stream():
    """A pool too small for both streams' reservations: decode_batch's
    room-making preempts the youngest stream, and the drafter owner hears
    of it from the same path, in both schedulers."""
    pair = _pair(num_blocks=6)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, 31).astype(np.int32),
               rng.integers(0, 256, 31).astype(np.int32)]
    _submit(pair, prompts, new=[40, 40])
    _prefill_all(pair)
    drafted = np.full((2, 4), 3, np.int32)
    for _ in range(4):
        if _batch(pair, 4) is None:
            break
        live = [i for i in range(2) if pair[1]._slots[i].request is not None
                and pair[1]._slots[i].prefill_done]
        acc = np.array([4, 4])
        for s in pair:
            s.note_spec(drafted, acc, np.array([1, 2]), 0.0)
        _same(*pair, f"live {live}")
    assert pair[1].preemptions > 0
    assert pair[1].draft_owner.evicted == pair[0].draft_owner.evicted != []


def test_lone_stream_frees_its_own_drafter_blocks_first():
    """Where the reference raises (the requester is the only stream and
    the pool is short), the port frees that stream's own drafter blocks
    first and goes on."""

    class Owner:
        def __init__(self, alloc):
            self.alloc, self.held = alloc, {}

        def evict_stream(self, rid):
            self.alloc.free(self.held.pop(rid, []))

    alloc = BlockAllocator(4)
    sched = Scheduler(num_slots=1, block_size=B, max_blocks_per_slot=4,
                      allocator=alloc, prefill_chunk=CHUNK)
    owner = sched.draft_owner = Owner(alloc)
    sched.submit(Request(rid=0, prompt=np.arange(16, dtype=np.int32),
                         max_new_tokens=30))
    sched.admit(0.0)
    w = sched.next_prefill(0.0)
    sched.note_prefill(w, 5, 0.0)
    owner.held[0] = alloc.allocate(2)  # the drafter's blocks
    assert alloc.num_free == 0
    assert sched.decode_batch(0.0) is not None  # its row 16 needs a block
    assert 0 not in owner.held and sched.blocks_held(0) == 2
    alloc.check_accounting()


# --- the adaptive controller ---------------------------------------------------

@pytest.mark.parametrize("window", [1, 3, 6])
def test_adaptive_controller_steps_as_reference(window):
    """Scripted acceptance on three streams (easy, hard, mixed), a cap set
    and lifted mid-way and a release: every choice, round shape and the
    adjustment count equal the reference's after every call."""
    kw = dict(choices=((2, 1), (4, 1), (4, 2)), window=window)
    j, t = JAdaptive(**kw), AdaptiveSpecController(**kw)
    rng = np.random.default_rng(window)
    for r in range(40):
        for stream in range(3):
            d, _ = t.choice(stream)
            assert (d, _) == j.choice(stream)
            a = {0: d, 1: 0, 2: int(rng.integers(0, d + 1))}[stream]
            j.note_round(stream, a, d)
            t.note_round(stream, a, d)
        if r == 15:
            assert t.set_cap((4, 1)) == j.set_cap((4, 1))
        if r == 25:
            assert t.set_cap(None) == j.set_cap(None)
        if r == 30:
            j.release(1)
            t.release(1)
        for streams in ([0], [1, 2], [0, 1, 2], []):
            assert t.round_shape(streams) == j.round_shape(streams)
        assert t.adjustments == j.adjustments
        assert t.cap == j.cap
    with pytest.raises(ValueError, match="choices"):
        t.set_cap((3, 3))


def test_adaptive_controller_validates_its_choices():
    with pytest.raises(ValueError, match="MAX_DRAFT_K"):
        AdaptiveSpecController(choices=((8, 8),))
    with pytest.raises(ValueError, match="choice"):
        AdaptiveSpecController(choices=())


# --- validate_drafter -----------------------------------------------------------

class _Cfg:
    vocab_size = 256


class _Stub:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("stub,kw,match", [
    (dict(k=4, block_size=32), dict(block_size=16), "block_size"),
    (dict(k=4, cache_rows=64), dict(), "max_seq_len"),
    (dict(k=4), dict(cache_rows=64), "max_seq_len"),
    (dict(k=2, depth=3, branching=2, chain_k=4), dict(), "chain_k"),
    (dict(k=2, depth=3, branching=2, chain_k=0), dict(), "chain_k"),
    (dict(k=4, vocab_size=100), dict(), "vocab_size"),
    (dict(k=40), dict(), "draft.k"),
    (dict(k=2, depth=3, branching=2, chain_k=2, block_size=16,
          cache_rows=128), dict(block_size=16), None),
])
def test_validate_drafter_checks_as_reference(stub, kw, match):
    d = _Stub(**stub)
    if match is None:
        assert validate_drafter(d, _Cfg, needed_rows=128, **kw) \
            == jvalidate(d, _Cfg, needed_rows=128, **kw) == stub["k"]
        return
    for fn in (jvalidate, validate_drafter):
        with pytest.raises(ValueError, match=match):
            fn(d, _Cfg, needed_rows=128, **kw)
