"""Port parity: apex_tpu_torch's GPT decode branch and ServingEngine against
apex_tpu's, on the same weights (through the bridge) and the same inputs.

fp32 on the CPU; matmuls in full fp32 (TF32 off, stated here because the
same file runs its kernel cases on a card). Logits agree to 1e-4 (fp32
sums in another order through a 2-layer stack); whole greedy serves must
be token-identical per request, preemption and prefix hits included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.serving.engine import ServingEngine as JServingEngine
from apex_tpu.serving.scheduler import Request as JRequest
from apex_tpu_torch.models.convert import params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.serving.engine import ServingEngine
from apex_tpu_torch.serving.scheduler import Request

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
# the small serving config (bench.py's CPU smoke shape): 2 slots, 16-row
# blocks, 32-token chunks, 8 allocatable blocks of 16 worst-case
SMALL = dict(vocab_size=256, max_seq_len=128, hidden_size=64, num_layers=2,
             num_heads=4)
ENGINE = dict(num_slots=2, block_size=16, prefill_chunk=32, num_blocks=9)


def _models(num_kv_heads=None, seed=0):
    jcfg = JGPTConfig(**SMALL, num_kv_heads=num_kv_heads, tp_size=1,
                      remat=False, attention_impl="flash")
    jm = JGPTModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    # non-zero biases and LN affines, so the bridge's every leaf matters
    rng = np.random.default_rng(seed + 1)
    np_tree = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
        .astype(np.float32), jp)
    jp = jax.tree.map(jnp.asarray, np_tree)
    cfg = GPTConfig(**SMALL, num_kv_heads=num_kv_heads,
                    attention_impl="flash")
    return jm, jp, GPTModel(cfg), params_from_jax(np_tree, cfg,
                                                  device="cpu")


def _trace(seed, n_req, vocab, prompt_rng, newtok_rng, sys_len):
    """A seeded trace: half the prompts open with one of two shared
    system prompts; everything arrives at t=0 so admission order does not
    depend on the clock."""
    rng = np.random.default_rng(seed)
    sys_prompts = [rng.integers(0, vocab, sys_len).astype(np.int32)
                   for _ in range(2)]
    out = []
    for i in range(n_req):
        tail = rng.integers(0, vocab, int(rng.integers(*prompt_rng))
                            ).astype(np.int32)
        if rng.random() < 0.5:
            prompt = np.concatenate([sys_prompts[int(rng.integers(2))],
                                     tail])
        else:
            prompt = np.concatenate([
                rng.integers(0, vocab, sys_len).astype(np.int32), tail])
        out.append((i, prompt, int(rng.integers(*newtok_rng))))
    return out


class TestDecodeBranch:
    @pytest.mark.parametrize("num_kv_heads", [None, 2])
    def test_decode_qkv_and_block_match_reference(self, num_kv_heads):
        jm, jp, tm, tp = _models(num_kv_heads)
        c = tm.config
        rng = np.random.default_rng(3)
        b, nb, bs = 3, 4, 16
        num_blocks = b * nb + 1
        x = rng.standard_normal((b, 1, c.hidden_size)).astype(np.float32)
        pk = rng.standard_normal(
            (num_blocks, c.kv_heads, bs, c.head_dim)).astype(np.float32)
        pv = rng.standard_normal(pk.shape).astype(np.float32)
        tables = rng.permutation(np.arange(1, num_blocks)).reshape(b, nb)
        tables[2, 2:] = 0  # dead-block entries past the live rows
        tables = tables.astype(np.int32)
        lengths = np.array([40, 64, 0], np.int32)
        jlayer = jax.tree.map(lambda a: a[1], jp["layers"])
        tlayer = tp["layers"][1]

        jq, jk, jv = jm.decode_qkv(jlayer, jnp.asarray(x))
        tq, tk, tv = tm.decode_qkv(tlayer, torch.from_numpy(x))
        for j, t in ((jq, tq), (jk, tk), (jv, tv)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)

        want = jm.decode_block(jlayer, jnp.asarray(x), jq, jnp.asarray(pk),
                               jnp.asarray(pv), jnp.asarray(lengths),
                               block_tables=jnp.asarray(tables))
        got = tm.decode_block(tlayer, torch.from_numpy(x), tq,
                              torch.from_numpy(pk), torch.from_numpy(pv),
                              torch.from_numpy(lengths),
                              block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_unembed_and_embedding_match_reference(self):
        jm, jp, tm, tp = _models()
        ids = np.array([[0, 5, 255, 256, -1]], np.int32)  # 2 out of range
        want = jm.embedding(jp["embedding"], jnp.asarray(ids))
        got = tm.embedding(tp["embedding"], torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert not got[0, 3:].any(), "out-of-range ids must embed to zeros"
        x = np.random.default_rng(0).standard_normal(
            (2, 1, 64)).astype(np.float32)
        np.testing.assert_allclose(
            tm.unembed(tp, torch.from_numpy(x)).numpy(),
            np.asarray(jm.unembed(jp, jnp.asarray(x))), **TOL)


def _engines(jm, tm, **kw):
    args = dict(ENGINE, **kw)
    return JServingEngine(jm, **args), ServingEngine(tm, device="cpu",
                                                     **args)


def _pool_np(pool):
    return {k: np.asarray(v) for k, v in pool.items()}


class TestPrefillChunk:
    @pytest.mark.parametrize("start,live", [(0, 32), (16, 20), (48, 7)])
    def test_prefill_chunk_matches_reference(self, start, live):
        jm, jp, tm, tp = _models(num_kv_heads=2)
        je, te = _engines(jm, tm)
        rng = np.random.default_rng(start + live)
        row = np.array([3, 7, 1, 5, 2, 8, 0, 0], np.int32)
        tokens = np.zeros(32, np.int32)
        tokens[:live] = rng.integers(0, 256, live)
        base = rng.standard_normal(
            (2, 9, 2, 16, 16)).astype(np.float32) * 0.5
        jpool = {"k": jnp.asarray(base), "v": jnp.asarray(base[::-1].copy())}
        tpool = {"k": torch.from_numpy(base.copy()),
                 "v": torch.from_numpy(base[::-1].copy())}
        jpool, jtok, jlogits = je._prefill_chunk_body(
            jp, jpool, jnp.asarray(row), jnp.asarray(tokens),
            jnp.int32(start), jnp.int32(live), jax.random.PRNGKey(0))
        ttok, tlogits = te.prefill_chunk(
            tp, tpool, torch.from_numpy(row), torch.from_numpy(tokens),
            start, live)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL)
        assert int(ttok) == int(jtok)
        jn = _pool_np(jpool)
        for name in ("k", "v"):
            np.testing.assert_allclose(tpool[name].numpy(), jn[name], **TOL)

    def test_clamped_chunk_start_reproduces_reference(self):
        """A chunk starting at a prefix-hit frontier within one chunk of
        max_s: the reference's lax.dynamic_slice clamps the table slice's
        start (engine.py:543-544), so the chunk's rows land one block
        EARLY — over the block holding positions 96..111, which may be a
        shared prefix block — and the block for 112..127 is never
        written. The port reproduces the clamp exactly; this pins both
        the agreement and the reference's misplacement (a caveat recorded
        in ROADMAP.md, not a port fault)."""
        jm, jp, tm, tp = _models()
        je, te = _engines(jm, tm)
        row = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)
        start, live = 112, 8  # start // B + C // B = 7 + 2 > 8 blocks
        tokens = np.zeros(32, np.int32)
        tokens[:live] = np.arange(10, 10 + live)
        base = np.random.default_rng(0).standard_normal(
            (2, 9, 4, 16, 16)).astype(np.float32)
        jpool = {"k": jnp.asarray(base), "v": jnp.asarray(base)}
        tpool = {"k": torch.from_numpy(base.copy()),
                 "v": torch.from_numpy(base.copy())}
        jpool, _, jlogits = je._prefill_chunk_body(
            jp, jpool, jnp.asarray(row), jnp.asarray(tokens),
            jnp.int32(start), jnp.int32(live), jax.random.PRNGKey(0))
        _, tlogits = te.prefill_chunk(tp, tpool, torch.from_numpy(row),
                                      torch.from_numpy(tokens), start, live)
        jn = _pool_np(jpool)
        np.testing.assert_allclose(tpool["k"].numpy(), jn["k"], **TOL)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL)
        # the reference wrote block row[6] (positions 96..111), not row[7]
        assert not np.allclose(jn["k"][:, 7], base[:, 7])
        np.testing.assert_array_equal(jn["k"][:, 8], base[:, 8])


def _serve_both(jm, jp, tm, tp, trace, **engine_kw):
    je, te = _engines(jm, tm, **engine_kw)
    jreqs = [JRequest(rid=r, prompt=p, max_new_tokens=n)
             for r, p, n in trace]
    treqs = [Request(rid=r, prompt=p, max_new_tokens=n)
             for r, p, n in trace]
    jsched, tsched = je.make_scheduler(), te.make_scheduler()
    jdone = je.serve(jp, jreqs, clock=lambda: 0.0, scheduler=jsched,
                     telemetry=False)
    tdone = te.serve(tp, treqs, clock=lambda: 0.0, scheduler=tsched)
    return je, te, jsched, tsched, jdone, tdone


class TestServe:
    @pytest.mark.parametrize("num_kv_heads", [None, 2])
    def test_greedy_serve_token_identical_under_churn(self, num_kv_heads):
        jm, jp, tm, tp = _models(num_kv_heads)
        trace = _trace(7, 8, 256, (4, 40), (2, 24), 32)
        je, te, jsched, tsched, jdone, tdone = _serve_both(
            jm, jp, tm, tp, trace)
        assert len(tdone) == len(trace)
        assert [r.rid for r in tdone] == [r.rid for r in jdone]
        for jr, tr in zip(jdone, tdone):
            assert tr.tokens == [int(t) for t in jr.tokens], tr.rid
            assert tr.evictions == jr.evictions
            assert tr.prefix_hit_blocks == jr.prefix_hit_blocks
        js, ts = je.last_stats, te.last_stats
        assert (ts.decode_steps, ts.prefill_chunks, ts.blocks_high_water) \
            == (js.decode_steps, js.prefill_chunks, js.blocks_high_water)
        assert tsched.preemptions == jsched.preemptions > 0
        assert sum(r.prefix_hit_blocks for r in tdone) > 0
        tsched.allocator.check_accounting()
        assert tsched.allocator.num_live == tsched.allocator.num_resident

    def test_sampled_serve_stays_in_top_k_support(self):
        """Every sampled token lies in the top-k of its step's logits,
        recomputed by the reference's full causal forward over the
        finished sequence (a 1e-4 margin absorbs fp32 reordering)."""
        jm, jp, tm, tp = _models()
        top_k = 5
        te = ServingEngine(tm, device="cpu", temperature=1.0, top_k=top_k,
                           **ENGINE)
        trace = _trace(11, 6, 256, (4, 40), (2, 16), 32)
        reqs = [Request(rid=r, prompt=p, max_new_tokens=n)
                for r, p, n in trace]
        done = te.serve(tp, reqs, clock=lambda: 0.0,
                        generator=torch.Generator().manual_seed(0))
        assert len(done) == len(trace)
        assert te.last_stats.decode_steps > 0
        for r in done:
            assert len(r.tokens) == r.max_new_tokens
            seq = np.concatenate([r.prompt, np.asarray(r.tokens[:-1],
                                                       np.int32)])
            logits = np.asarray(jm.logits(jp, jnp.asarray(seq)[None]))[0]
            rows = logits[len(r.prompt) - 1:]
            kth = np.sort(rows, axis=-1)[:, -top_k]
            picked = rows[np.arange(len(r.tokens)), r.tokens]
            assert (picked >= kth - 1e-4).all(), r.rid

    def test_sampled_serve_is_reproducible_from_the_seed(self):
        jm, jp, tm, tp = _models()
        trace = _trace(5, 4, 256, (4, 30), (2, 10), 16)

        def run():
            te = ServingEngine(tm, device="cpu", temperature=0.8, top_k=20,
                               top_p=0.9, **ENGINE)
            done = te.serve(tp, [Request(rid=r, prompt=p, max_new_tokens=n)
                                 for r, p, n in trace],
                            clock=lambda: 0.0,
                            generator=torch.Generator().manual_seed(3))
            return {r.rid: r.tokens for r in done}

        assert run() == run()


class TestEngineSurface:
    def test_later_slices_raise(self):
        """Quantized pools are ported: an illegal kv_dtype raises the
        reference's ValueError; tensor parallelism is still a later
        slice."""
        _, _, tm, tp = _models()
        with pytest.raises(ValueError, match="kv_dtype must be None"):
            ServingEngine(tm, device="cpu", kv_dtype="int4", **ENGINE)
        assert ServingEngine(tm, device="cpu", kv_dtype="fp8_e4m3",
                             **ENGINE).quantized

        class Plan:
            tp = 2

        with pytest.raises(NotImplementedError, match="tensor-parallel"):
            ServingEngine(tm, device="cpu", plan=Plan(), **ENGINE)
        te = ServingEngine(tm, device="cpu", **ENGINE)
        # speculative serving is ported: a drafter without k is refused
        with pytest.raises(ValueError, match="draft.k"):
            te.serve(tp, [], draft=object())
        te_s = ServingEngine(tm, device="cpu", temperature=0.5, **ENGINE)
        with pytest.raises(ValueError, match="generator"):
            te_s.serve(tp, [])

    def test_pool_layout_and_bytes(self):
        _, _, tm, _ = _models(num_kv_heads=2)
        te = ServingEngine(tm, device="cpu", **ENGINE)
        pool = te.init_pool()
        assert pool["k"].shape == (2, 9, 2, 16, 16)
        assert te.pool_bytes() == 2 * pool["k"].numel() * 4
        assert not pool["k"].any() and not pool["v"].any()

    def test_bridge_checks_shapes(self):
        jm, jp, _, _ = _models()
        tree = jax.tree.map(np.asarray, jp)
        bad = GPTConfig(**dict(SMALL, hidden_size=32))
        with pytest.raises(ValueError, match="embedding.weight"):
            params_from_jax(tree, bad, device="cpu")
