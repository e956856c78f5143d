"""Port parity: a model's ``decode_rel_bias`` hook through the port's
DecodeEngine and ServingEngine against the reference's, on the same
weights (through the bridge) and the same inputs.

A model that defines ``decode_rel_bias(params) -> BucketedBias`` (a causal
bucketed table, as ``tests/test_inference.py``'s test model) gets the bias
threaded into every decode block by both engines
(``apex_tpu/inference/engine.py:279-293``,
``apex_tpu/serving/engine.py:647-674``). With a nonzero table the port's
logits must equal the reference's biased ones (fp32, 1e-4: two layers of
sums in another order) and differ from the unbiased ones; a zero table is
bitwise a no-op; the speculative entries refuse such a model. The
reference runs its XLA path (the CPU default).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference.engine import DecodeEngine as JDecodeEngine
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.ops.attention import BucketedBias as JBucketedBias
from apex_tpu.serving.engine import ServingEngine as JServingEngine
from apex_tpu_torch.inference import DecodeEngine
from apex_tpu_torch.models.convert import params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.ops.attention import BucketedBias
from apex_tpu_torch.serving.engine import ServingEngine
from apex_tpu_torch.serving.scheduler import Request
from apex_tpu_torch.spec.drafter import NGramDrafter

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=256, max_seq_len=128, hidden_size=64, num_layers=2,
             num_heads=4)
ENGINE = dict(num_slots=3, block_size=16, prefill_chunk=32, num_blocks=25)
BUCKETS, MAX_DISTANCE = 16, 32


class JRelGPT(JGPTModel):
    table = None

    def decode_rel_bias(self, params):
        return JBucketedBias(jnp.asarray(self.table), bidirectional=False,
                             max_distance=MAX_DISTANCE)


class RelGPT(GPTModel):
    table = None

    def decode_rel_bias(self, params):
        return BucketedBias(torch.from_numpy(self.table),
                            bidirectional=False, max_distance=MAX_DISTANCE)


def models(table, num_kv_heads=None, seed=0):
    """(JAX model, JAX params, port model, port params), the models
    carrying ``table`` (None: the stock models, no hook)."""
    jcfg = JGPTConfig(**SMALL, num_kv_heads=num_kv_heads, tp_size=1,
                      remat=False, attention_impl="flash")
    jm = (JGPTModel if table is None else JRelGPT)(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    np_tree = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
        .astype(np.float32), jp)
    cfg = GPTConfig(**SMALL, num_kv_heads=num_kv_heads,
                    attention_impl="flash")
    tm = (GPTModel if table is None else RelGPT)(cfg)
    if table is not None:
        jm.table = tm.table = table
    return (jm, jax.tree.map(jnp.asarray, np_tree), tm,
            params_from_jax(np_tree, cfg, device="cpu"))


def seeded_table(seed=44, heads=4):
    return (np.random.default_rng(seed).standard_normal((BUCKETS, heads))
            * 0.5).astype(np.float32)


def decode_logits(jm, jp, tm, tp, steps=4, b=2, s=8):
    """Each engine's logits of ``steps`` greedy decode steps after an
    s-token prefill: (reference (steps, b, V), port (steps, b, V))."""
    prompt = np.random.default_rng(43).integers(0, 256, (b, s)).astype(
        np.int32)
    key = jax.random.PRNGKey(0)
    je = JDecodeEngine(jm)
    cache, tok, _ = je.prefill(jp, jnp.asarray(prompt), key)
    want = []
    for t in range(steps):
        cache, tok, lg = je.decode_step(jp, cache, tok, jnp.int32(s + t),
                                        key)
        want.append(np.asarray(lg))
    te = DecodeEngine(tm, device="cpu")
    tcache, ttok, _ = te.prefill(tp, torch.from_numpy(prompt))
    got = []
    for t in range(steps):
        tcache, ttok, lg = te.decode_step(tp, tcache, ttok, s + t)
        got.append(lg.numpy())
    return np.stack(want), np.stack(got)


def serve_step_logits(jm, jp, tm, tp, seed=3):
    """One ServingEngine decode step of both engines on the same pool,
    tables and lengths (a dead slot among them): (reference logits, port
    logits), each (S, V)."""
    c = tm.config
    rng = np.random.default_rng(seed)
    S, bs, nb = ENGINE["num_slots"], ENGINE["block_size"], 8
    base = (rng.standard_normal((c.num_layers, ENGINE["num_blocks"],
                                 c.kv_heads, bs, c.head_dim)) * 0.5
            ).astype(np.float32)
    ids = rng.permutation(np.arange(1, ENGINE["num_blocks"]))
    tables = np.zeros((S, nb), np.int32)
    lengths = np.array([37, 0, 100], np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // bs)):
            tables[i, j] = ids[i * nb + j]
    tokens = rng.integers(0, 256, S).astype(np.int32)
    je = JServingEngine(jm, **ENGINE)
    _, _, want = je._decode_step_body(
        jp, {"k": jnp.asarray(base), "v": jnp.asarray(base[::-1].copy())},
        jnp.asarray(tables), jnp.asarray(tokens), jnp.asarray(lengths),
        jax.random.PRNGKey(0))
    te = ServingEngine(tm, device="cpu", **ENGINE)
    _, got = te.decode_step(
        tp, {"k": torch.from_numpy(base.copy()),
             "v": torch.from_numpy(base[::-1].copy())},
        torch.from_numpy(tables), torch.from_numpy(tokens),
        torch.from_numpy(lengths))
    live = lengths > 0
    return np.asarray(want)[live], got.numpy()[live]


@pytest.mark.parametrize("num_kv_heads", [None, 2])
def test_decode_engine_applies_the_hook(num_kv_heads):
    """The fault the port had: DecodeEngine.decode_step dropped the hook,
    so a nonzero table gave the unbiased logits."""
    table = seeded_table()
    want, got = decode_logits(*models(table, num_kv_heads))
    np.testing.assert_allclose(got, want, **TOL)
    plain, _ = decode_logits(*models(None, num_kv_heads))
    assert np.abs(want - plain).max() > 1e-3, "the table moved nothing"


@pytest.mark.parametrize("num_kv_heads", [None, 2])
def test_serving_engine_applies_the_hook(num_kv_heads):
    """The same fault in ServingEngine.decode_step (the paged kernel's
    path)."""
    table = seeded_table(seed=45)
    want, got = serve_step_logits(*models(table, num_kv_heads))
    np.testing.assert_allclose(got, want, **TOL)
    plain, _ = serve_step_logits(*models(None, num_kv_heads))
    assert np.abs(want - plain).max() > 1e-3, "the table moved nothing"


def test_zero_table_is_bitwise_a_no_op():
    zero = np.zeros((BUCKETS, 4), np.float32)
    _, biased = decode_logits(*models(zero))
    _, plain = decode_logits(*models(None))
    np.testing.assert_array_equal(biased, plain)
    _, biased = serve_step_logits(*models(zero))
    _, plain = serve_step_logits(*models(None))
    np.testing.assert_array_equal(biased, plain)


def test_greedy_serve_with_the_hook_matches_reference():
    """A whole greedy serve of a hooked model: the tokens equal the
    reference's serve (prefill unbiased in both, decode biased)."""
    jm, jp, tm, tp = models(seeded_table(seed=46))
    rng = np.random.default_rng(7)
    trace = [(i, rng.integers(0, 256, int(rng.integers(4, 40))).astype(
        np.int32), int(rng.integers(2, 12))) for i in range(5)]
    from apex_tpu.serving.scheduler import Request as JRequest
    je = JServingEngine(jm, **ENGINE)
    jdone = je.serve(jp, [JRequest(rid=r, prompt=p, max_new_tokens=n)
                          for r, p, n in trace], clock=lambda: 0.0,
                     telemetry=False)
    te = ServingEngine(tm, device="cpu", **ENGINE)
    tdone = te.serve(tp, [Request(rid=r, prompt=p, max_new_tokens=n)
                          for r, p, n in trace], clock=lambda: 0.0)
    assert {r.rid: r.tokens for r in tdone} == {
        r.rid: [int(t) for t in r.tokens] for r in jdone}


def test_speculative_entries_refuse_a_hooked_model():
    _, _, tm, tp = models(seeded_table())
    eng = DecodeEngine(tm, device="cpu")
    prompt = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="relative-position bias"):
        eng.generate(tp, prompt, 4, draft=NGramDrafter(k=2))
    serve = ServingEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="relative-position bias"):
        serve.serve(tp, [], draft=NGramDrafter(k=2))
    with pytest.raises(ValueError, match="decode relative-position bias"):
        ServingEngine(tm, device="cpu", kv_dtype="int8", **ENGINE)


def test_kernel_operands_follow_the_table():
    """The kernels' lookup is kept per bias while its table is unchanged
    (the engines make one bias a step for every layer) and rebuilt after
    an in-place update of the table."""
    table = torch.from_numpy(seeded_table())
    bias = BucketedBias(table, bidirectional=False,
                        max_distance=MAX_DISTANCE)
    lut, bucket, _ = bias.kernel_operands()
    assert bias.kernel_operands()[0] is lut
    assert lut.shape == (4, 2 * MAX_DISTANCE + 1)
    torch.testing.assert_close(lut, table.t()[:, bucket.long()])
    table.mul_(2.0)
    again = bias.kernel_operands()[0]
    assert again is not lut
    torch.testing.assert_close(again, 2.0 * lut)
