"""Port parity: ServingEngine.request_swap (weight hot-swap between
dispatch steps) against apex_tpu's, on the same weights (through the
bridge) and the same requests.

The reference's hot-swap tests (``tests/test_serving.py:1230-1385``),
ported: a swap to equal weights is token-identical to no swap; a swap to
other weights changes the tokens after the swap step and no earlier one;
an unreached swap is dropped at drain (after a raise too); the ``swap``
event rides the telemetry; every tree, shape, dtype or device mismatch
raises naming its leaf. Beyond them: a perturbed swap at step n gives the
reference's greedy tokens for the same swap; the engine rebinds to the
new tensors (the caller's old ones are never written, the pool stays
where it is); and a model whose ``decode_rel_bias`` table lives in the
params and changes with the swap gives the reference's logits after it.
fp32 on the CPU; logits agree to 1e-4.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import monitor as jmon
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.ops.attention import BucketedBias as JBucketedBias
from apex_tpu.serving import Request as JRequest
from apex_tpu.serving import ServingEngine as JServingEngine
from apex_tpu_torch import monitor as tmon
from apex_tpu_torch.models.convert import params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.ops.attention import BucketedBias
from apex_tpu_torch.serving import Request, ServeTelemetry, ServingEngine
from apex_tpu_torch.utils.pytree import tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's tiny serving GPT (tests/test_serving.py:57-63)
TINY = dict(vocab_size=97, max_seq_len=128, hidden_size=32, num_layers=2,
            num_heads=4, num_kv_heads=2, attention_impl="flash")
ENGINE = dict(num_slots=2, block_size=8, prefill_chunk=8)
BUCKETS, MAX_DISTANCE = 16, 32


class JParamRelGPT(JGPTModel):
    """The reference GPT with a decode bias whose table is a parameter."""

    def decode_rel_bias(self, params):
        return JBucketedBias(params["rel_table"], bidirectional=False,
                             max_distance=MAX_DISTANCE)


class ParamRelGPT(GPTModel):
    def decode_rel_bias(self, params):
        return BucketedBias(params["rel_table"], bidirectional=False,
                            max_distance=MAX_DISTANCE)


def _perturb(tree, seed, std):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + std * rng.standard_normal(
        np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def tiny():
    """(reference model, its params, port model, port params, perturbed
    weights as numpy) — the perturbation seeded, 0.05 a leaf."""
    jm = JGPTModel(JGPTConfig(**TINY, remat=False, dropout=0.0))
    np_tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(23)))
    tm = GPTModel(GPTConfig(**TINY, remat=False))
    jolt = _perturb(np_tree, 99, 0.05)
    return (jm, jax.tree.map(jnp.asarray, np_tree), tm,
            params_from_jax(np_tree, tm.config, device="cpu"), jolt)


def _reqs(Req, n=3, max_new=10):
    rng = np.random.default_rng(5)
    return [Req(rid=i, prompt=np.asarray(rng.integers(0, 97, int(
        rng.integers(1, 20))), np.int32), max_new_tokens=int(
            rng.integers(4, max_new))) for i in range(n)]


def _serve(tm, tp, swap=None, at_step=None, reqs=None, **kw):
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    if swap is not None:
        eng.request_swap(swap, at_step=at_step, source="test-ckpt")
    done = eng.serve(tp, reqs if reqs is not None else _reqs(Request),
                     clock=lambda: 0.0, **kw)
    return eng, {r.rid: list(r.tokens) for r in done}, done


def _ref_serve(jm, jp, swap=None, at_step=None):
    eng = JServingEngine(jm, **ENGINE)
    if swap is not None:
        eng.request_swap(swap, at_step=at_step)
    done = eng.serve(jp, _reqs(JRequest), clock=lambda: 0.0,
                     telemetry=False)
    return eng, {r.rid: [int(t) for t in r.tokens] for r in done}


def test_equal_weights_swap_is_token_identical(tiny):
    jm, jp, tm, tp, _ = tiny
    _, base, _ = _serve(tm, tp)
    clone = tree_map(lambda t: t.clone(), tp)
    eng, swapped, _ = _serve(tm, tp, swap=clone, at_step=5)
    assert base == swapped
    assert eng.last_stats.swaps == 1
    # and the no-swap serve is the reference's
    assert base == _ref_serve(jm, jp)[1]


def _token_steps(tm, tp, swap=None, at_step=None):
    """Each emitted token's dispatch step: the serve's decode and prefill
    steps counted in the order the loop calls them."""
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    if swap is not None:
        eng.request_swap(swap, at_step=at_step)
    step = [0]
    born = {}
    for name in ("prefill_chunk", "decode_step"):
        real = getattr(eng, name)

        def counted(*a, _real=real, **k):
            out = _real(*a, **k)
            step[0] += 1
            return out

        setattr(eng, name, counted)
    reqs = _reqs(Request)
    lens = {r.rid: 0 for r in reqs}

    def clock():
        # stamp every new token with the steps run so far
        for r in reqs:
            while lens[r.rid] < len(r.tokens):
                born[(r.rid, lens[r.rid])] = step[0]
                lens[r.rid] += 1
        return 0.0

    eng.serve(tp, reqs, clock=clock)
    clock()
    return {r.rid: list(r.tokens) for r in reqs}, born, eng


def test_perturbed_swap_changes_only_later_tokens_as_the_reference(tiny):
    jm, jp, tm, tp, jolt = tiny
    at = 6
    base, born, _ = _token_steps(tm, tp)
    new = params_from_jax(jolt, tm.config, device="cpu")
    swapped, born2, eng = _token_steps(tm, tp, swap=new, at_step=at)
    assert eng.last_stats.swaps == 1
    assert born == born2  # greedy lengths fix the schedule
    before = after_changed = 0
    for (rid, i), s in born.items():
        if s <= at:  # made by a dispatch before the swap landed
            assert swapped[rid][i] == base[rid][i]
            before += 1
        elif swapped[rid][i] != base[rid][i]:
            after_changed += 1
    assert before > 0 and after_changed > 0
    # the reference, given the same swap, emits the same tokens
    _, want = _ref_serve(jm, jp, swap=jax.tree.map(jnp.asarray, jolt),
                         at_step=at)
    assert swapped == want


def test_swap_rebinds_leaving_caller_tensors_and_pool(tiny):
    _, _, tm, tp, jolt = tiny
    old = tree_map(lambda t: t.clone(), tp)
    new = params_from_jax(jolt, tm.config, device="cpu")
    new_ptrs = [t.data_ptr() for t in jax.tree_util.tree_leaves(
        new, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    eng.request_swap(new, at_step=3)
    seen = []
    real = eng.decode_step

    def spy(params, pool, *a, **k):
        seen.append((pool["k"].data_ptr(), pool["v"].data_ptr(),
                     params["lnf_w"].data_ptr()))
        return real(params, pool, *a, **k)

    eng.decode_step = spy
    eng.serve(tp, _reqs(Request), clock=lambda: 0.0)
    assert eng.last_stats.swaps == 1
    assert len({s[:2] for s in seen}) == 1  # the pool never moved
    used = {s[2] for s in seen}
    assert used == {tp["lnf_w"].data_ptr(), new["lnf_w"].data_ptr()}
    # the caller's old tensors were never written; the new ones neither
    for a, b in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(
            old)):
        assert torch.equal(a, b)
    assert new_ptrs == [t.data_ptr() for t in jax.tree_util.tree_leaves(
        new, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert eng.last_pool["k"].data_ptr() == seen[0][0]


def test_unreached_swap_is_dropped_not_leaked(tiny):
    _, _, tm, tp, jolt = tiny
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    jolted = params_from_jax(jolt, tm.config, device="cpu")
    eng.request_swap(jolted, at_step=10_000)
    reqs = [Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=3)]
    done = eng.serve(tp, reqs)
    assert eng.last_stats.swaps == 0
    assert eng._pending_swap is None
    want = [list(r.tokens) for r in done]
    done2 = eng.serve(tp, [Request(rid=0, prompt=np.zeros(4, np.int32),
                                   max_new_tokens=3)])
    assert eng.last_stats.swaps == 0
    assert [list(r.tokens) for r in done2] == want
    # the drop survives a mid-run exception too
    eng.request_swap(jolted, at_step=10_000)
    real = eng.decode_step

    def boom(*a, **k):
        raise RuntimeError("injected mid-serve failure")

    eng.decode_step = boom
    try:
        with pytest.raises(RuntimeError, match="injected"):
            eng.serve(tp, [Request(rid=0, prompt=np.zeros(4, np.int32),
                                   max_new_tokens=3)])
    finally:
        eng.decode_step = real
    assert eng._pending_swap is None
    # a newer request replaces an unapplied one
    eng.request_swap(jolted, at_step=10_000)
    eng.request_swap(tp, at_step=1, source="second")
    assert eng._pending_swap[2] == "second"


def test_swap_event_rides_telemetry_and_record(tiny):
    _, _, tm, tp, _ = tiny
    stream = io.StringIO()
    tmon.enable(stream=stream)
    try:
        tel = ServeTelemetry(slots=2, status="SKIP", reason="cpu smoke")
        clone = tree_map(lambda t: t.clone(), tp)
        _serve(tm, tp, swap=clone, at_step=3, telemetry=tel)
    finally:
        tmon.disable()
    lines = stream.getvalue().splitlines()
    assert jmon.validate_jsonl(lines) == []
    recs = [json.loads(ln) for ln in lines]
    swaps = [r for r in recs if r.get("phase") == "swap"]
    assert len(swaps) == 1
    assert swaps[0]["rid"] == -1 and swaps[0]["swap_source"] == "test-ckpt"
    assert swaps[0]["step"] >= 3 and swaps[0]["dur_ms"] >= 0
    assert swaps[0]["trace_id"].startswith("serve-")
    assert tel.swaps == 1 and tel.final_fields()["swaps"] == 1


def test_mismatches_are_eager_and_leaf_named(tiny):
    _, _, tm, tp, _ = tiny
    req = [Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=2)]
    cases = [
        (dict(tp, lnf_w=torch.zeros(tp["lnf_w"].shape[0] + 1)),
         r"\['lnf_w'\].*\(33,\)"),
        (dict(tp, lnf_w=tp["lnf_w"].to(torch.bfloat16)), "bfloat16"),
        (dict(tp, lnf_w=torch.empty(tp["lnf_w"].shape, device="meta")),
         r"\['lnf_w'\].*meta"),
        (dict(tp, extra_head=torch.zeros(2)), r"adds \[\"\['extra_head'\]"),
        ({k: v for k, v in tp.items() if k != "lnf_b"}, "drops.*lnf_b"),
        (dict(tp, layers=tp["layers"][:1]), r"drops.*\['layers'\]\[1\]"),
        (dict(tp, layers=[dict(tp["layers"][0], qkv=dict(
            tp["layers"][0]["qkv"], weight=tp["layers"][0]["qkv"][
                "weight"].t().contiguous())), tp["layers"][1]]),
         r"\['layers'\]\[0\]\['qkv'\]\['weight'\]"),
    ]
    for bad, match in cases:
        eng = ServingEngine(tm, device="cpu", **ENGINE)
        eng.request_swap(bad)
        with pytest.raises(ValueError, match=match):
            eng.serve(tp, req)
        assert eng._pending_swap is None
    # the reference names the same leaves (its stacked layers aside)
    ServingEngine._validate_swap_avals(tp, tree_map(torch.clone, tp))


# --- the decode bias's table, swapped with the params ------------------------

@pytest.fixture(scope="module")
def rel_models():
    cfg = dict(vocab_size=256, max_seq_len=128, hidden_size=64,
               num_layers=2, num_heads=4)
    jm = JParamRelGPT(JGPTConfig(**cfg, tp_size=1, remat=False,
                                 attention_impl="flash"))
    np_tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(11)
    tables = [(rng.standard_normal((BUCKETS, 4)) * 0.5).astype(np.float32)
              for _ in range(2)]
    tm = ParamRelGPT(GPTConfig(**cfg, attention_impl="flash"))
    tp = params_from_jax(np_tree, tm.config, device="cpu")
    return jm, np_tree, tm, tp, tables


def _with_table(tree, table, torch_side):
    out = dict(tree)
    out["rel_table"] = (torch.from_numpy(table.copy()) if torch_side
                        else jnp.asarray(table))
    return out


def test_decode_bias_swap_gives_the_reference_logits(rel_models):
    """A hot-swap that changes only the decode bias's table: the port's
    decode-step logits after the swap are the reference's under the new
    table (not the old one's), step after step, though the old table is
    freed and its storage may hold the new one."""
    jm, np_tree, tm, tp, (t_old, t_new) = rel_models
    S, bs, nb, nblocks = 2, 16, 8, 17
    rng = np.random.default_rng(5)
    c = tm.config
    base = (rng.standard_normal((c.num_layers, nblocks, c.kv_heads, bs,
                                 c.head_dim)) * 0.5).astype(np.float32)
    tables = np.arange(1, 1 + S * nb, dtype=np.int32).reshape(S, nb) % 16 + 1
    lengths = np.array([40, 77], np.int32)
    tokens = np.array([5, 9], np.int32)
    je = JServingEngine(jm, num_slots=S, block_size=bs, num_blocks=nblocks)
    te = ServingEngine(tm, device="cpu", num_slots=S, block_size=bs,
                       num_blocks=nblocks)

    def ref(table):
        _, _, lg = je._decode_step_body(
            _with_table(jax.tree.map(jnp.asarray, np_tree), table, False),
            {"k": jnp.asarray(base), "v": jnp.asarray(base[::-1].copy())},
            jnp.asarray(tables), jnp.asarray(tokens), jnp.asarray(lengths),
            jax.random.PRNGKey(0))
        return np.asarray(lg)

    def port(params):
        _, lg = te.decode_step(
            params, {"k": torch.from_numpy(base.copy()),
                     "v": torch.from_numpy(base[::-1].copy())},
            torch.from_numpy(tables), torch.from_numpy(tokens),
            torch.from_numpy(lengths))
        return lg.numpy()

    old = _with_table(tp, t_old, True)
    np.testing.assert_allclose(port(old), ref(t_old), **TOL)
    del old  # the old table's storage is free for the new one
    new = _with_table(tp, t_new, True)
    want_new = ref(t_new)
    assert np.abs(want_new - ref(t_old)).max() > 1e-3
    for _ in range(2):
        np.testing.assert_allclose(port(new), want_new, **TOL)


def test_decode_bias_swap_serve_matches_the_reference(rel_models):
    """A whole greedy serve of the hooked model with a swap at step 5 to a
    new table: the reference's tokens, and not the no-swap serve's."""
    jm, np_tree, tm, tp, (t_old, t_new) = rel_models
    geo = dict(num_slots=3, block_size=16, prefill_chunk=32, num_blocks=25)
    rng = np.random.default_rng(7)
    trace = [(i, rng.integers(0, 256, int(rng.integers(4, 40))).astype(
        np.int32), int(rng.integers(6, 16))) for i in range(5)]

    def ref(swap):
        eng = JServingEngine(jm, **geo)
        if swap:
            eng.request_swap(_with_table(jax.tree.map(jnp.asarray, np_tree),
                                         t_new, False), at_step=5)
        done = eng.serve(_with_table(jax.tree.map(jnp.asarray, np_tree),
                                     t_old, False),
                         [JRequest(rid=r, prompt=p, max_new_tokens=n)
                          for r, p, n in trace], clock=lambda: 0.0,
                         telemetry=False)
        return {r.rid: [int(t) for t in r.tokens] for r in done}

    def port(swap):
        eng = ServingEngine(tm, device="cpu", **geo)
        if swap:
            eng.request_swap(_with_table(tp, t_new, True), at_step=5)
        done = eng.serve(_with_table(tp, t_old, True),
                         [Request(rid=r, prompt=p, max_new_tokens=n)
                          for r, p, n in trace], clock=lambda: 0.0)
        assert eng.last_stats.swaps == int(swap)
        return {r.rid: list(r.tokens) for r in done}

    swapped = port(True)
    assert swapped == ref(True)
    assert swapped != port(False)
