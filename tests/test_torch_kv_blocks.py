"""Port parity: apex_tpu_torch's block allocator, prefix cache and scheduler
against apex_tpu's, on the same scripted churn.

These are host-side numpy modules ported line for line, so the check is
exact: after every step the allocation order (the free list), the block
tables, the refcounts, the resident set, the prefix cache's counters, the
preemptions and the completion order must be identical, and
``check_accounting`` must hold on both.
"""

import numpy as np
import pytest

from apex_tpu.serving import kv_blocks as jkv
from apex_tpu.serving import scheduler as jsched
from apex_tpu_torch.serving import kv_blocks as tkv
from apex_tpu_torch.serving import scheduler as tsched


def _alloc_state(a):
    a.check_accounting()
    return (list(a._free), sorted(a._ref.items()), sorted(a._resident),
            a.alloc_total, a.free_total, a.high_water)


def _cache_state(c):
    return (c.block_hits, c.block_queries, c.inserts, c.evictions,
            sorted((e.eid, e.parent_eid, e.tokens, e.block_id, e.nchildren,
                    e.stamp) for e in c._by_eid.values()))


def _sched_state(s):
    return (_alloc_state(s.allocator),
            None if s.prefix_cache is None else _cache_state(s.prefix_cache),
            s.tables.asarray().tolist(), list(s._admit_order),
            [r.rid for r in s._waiting], [r.rid for r in s.completed],
            s.preemptions, s.recompute_tokens,
            [(r.rid, list(r.tokens), r.evictions, r.prefix_hit_blocks)
             for r in s.completed])


def _make(mod_kv, mod_s, *, num_blocks, cache=True, capacity=None,
          slots=3, bs=4, max_blocks=6, chunk=8):
    alloc = mod_kv.BlockAllocator(num_blocks)
    pc = (mod_kv.PrefixCache(alloc, bs, capacity_blocks=capacity)
          if cache else None)
    return mod_s.Scheduler(num_slots=slots, block_size=bs,
                           max_blocks_per_slot=max_blocks, allocator=alloc,
                           prefill_chunk=chunk, prefix_cache=pc,
                           policy=mod_s.SLOPolicy())


def _trace(seed, n, vocab=50):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 9).astype(np.int32)
    out = []
    for rid in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(1, 8))).astype(
            np.int32)
        prompt = (np.concatenate([shared, tail]) if rng.random() < 0.6
                  else rng.integers(0, vocab, int(rng.integers(2, 14)))
                  .astype(np.int32))
        out.append((rid, prompt, int(rng.integers(1, 9))))
    return out


def _drive(seed, n, **kw):
    """Run both schedulers through the same churn, with the engine's loop
    shape and a deterministic stand-in for the sampled tokens."""
    js = _make(jkv, jsched, **kw)
    ts = _make(tkv, tsched, **kw)
    for rid, prompt, n_new in _trace(seed, n):
        js.submit(jsched.Request(rid=rid, prompt=prompt,
                                 max_new_tokens=n_new))
        ts.submit(tsched.Request(rid=rid, prompt=prompt,
                                 max_new_tokens=n_new))
    step = 0
    while not js.idle():
        assert not ts.idle()
        assert js.admit(0.0) == ts.admit(0.0)
        jw, tw = js.next_prefill(), ts.next_prefill()
        assert (jw is None) == (tw is None)
        if jw is not None:
            assert (jw.slot, jw.start, jw.live, jw.is_last, jw.rid) == \
                (tw.slot, tw.start, tw.live, tw.is_last, tw.rid)
            np.testing.assert_array_equal(jw.tokens, tw.tokens)
            tok = (7 * jw.rid + step) % 50
            js.note_prefill(jw, tok, 0.0)
            ts.note_prefill(tw, tok, 0.0)
        jb, tb = js.decode_batch(), ts.decode_batch()
        assert (jb is None) == (tb is None)
        if jb is not None:
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a, b)
            sampled = (np.arange(js.num_slots) * 3 + step) % 50
            js.note_decode(sampled, 0.0)
            ts.note_decode(sampled, 0.0)
        assert _sched_state(js) == _sched_state(ts), f"step {step}"
        step += 1
    assert ts.idle()
    return js, ts


@pytest.mark.parametrize("seed,num_blocks,capacity", [
    (0, 9, None), (1, 7, None), (2, 12, 3), (3, 19, None)])
def test_scheduler_churn_identical(seed, num_blocks, capacity):
    js, ts = _drive(seed, 14, num_blocks=num_blocks, capacity=capacity)
    assert len(ts.completed) == 14


def test_churn_exercises_preemption_and_prefix_hits():
    js, ts = _drive(1, 14, num_blocks=7)
    assert ts.preemptions > 0
    assert sum(r.prefix_hit_blocks for r in ts.completed) > 0
    assert ts.prefix_cache.evictions > 0


def test_scheduler_without_prefix_cache_identical():
    _drive(4, 10, num_blocks=8, cache=False)


def test_allocator_script_identical():
    ja, ta = jkv.BlockAllocator(8), tkv.BlockAllocator(8)
    script = [("allocate", 3), ("retain", [1, 2]), ("free", [1]),
              ("allocate", 2), ("free", [2, 2, 3]), ("mark", 4),
              ("allocate", 1), ("free", [4, 5]), ("allocate", 3)]
    for op, arg in script:
        outs = []
        for a in (ja, ta):
            if op == "allocate":
                outs.append(a.allocate(arg))
            elif op == "retain":
                a.retain(arg)
            elif op == "free":
                a.free(arg)
            else:
                a.mark_resident(arg)
        if op == "allocate":
            assert outs[0] == outs[1]
        assert _alloc_state(ja) == _alloc_state(ta)
        assert ja.fragmentation_pct() == ta.fragmentation_pct()
    for a in (ja, ta):
        with pytest.raises(ValueError, match="dead block"):
            a.free([0])
        with pytest.raises(ValueError, match="not live"):
            a.retain([7])
        with pytest.raises(RuntimeError, match="exhausted"):
            a.allocate(99)
    assert tkv.blocks_needed(17, 16) == jkv.blocks_needed(17, 16) == 2


def test_prefix_cache_script_identical():
    caches = []
    for mod in (jkv, tkv):
        a = mod.BlockAllocator(10)
        caches.append((a, mod.PrefixCache(a, 2, capacity_blocks=3)))
    prompts = [[1, 2, 3, 4, 5], [1, 2, 3, 9], [7, 7, 1, 2], [1, 2, 8, 8]]
    for prompt in prompts:
        for a, c in caches:
            chain = c.match(prompt)
            parent = chain[-1].eid if chain else tkv.ROOT_EID
            for i in range(len(chain), len(prompt) // 2):
                (bid,) = a.allocate(1)
                parent = c.insert(parent, prompt[2 * i:2 * i + 2], bid)
                a.free([bid])
        (ja, jc), (ta, tc) = caches
        assert _cache_state(jc) == _cache_state(tc)
        assert _alloc_state(ja) == _alloc_state(ta)
    assert [c.reclaim(2) for _, c in caches] == [2, 2]
    assert _cache_state(caches[0][1]) == _cache_state(caches[1][1])
    with pytest.raises(ValueError, match="FULL blocks"):
        caches[1][1].insert(tkv.ROOT_EID, [1], 1)
