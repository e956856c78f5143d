"""Port parity: ``ServingEngine.serve(draft=...)`` against the JAX
reference, on the CPU in fp32 (TF32 off, as ``test_torch_serving.py``).

Greedy spec serves with the chain n-gram drafter, the tree n-gram
drafter, a ``PagedModelDrafter`` (a 1-layer GPT of the target's
vocabulary) and the target as its own paged drafter must be
token-identical, request by request, to the reference's plain serve and
to the port's plain serve; the reference's own spec serve with the same
drafter runs the same rounds, so every ``ServeStats`` counter (rounds,
drafted, accepted, nodes, degraded, slot-rounds, steps, chunks, the block
high-water) must equal its counters. A sampled spec serve at T 0.8,
top_k 20, top_p 0.9 completes every request with in-vocabulary tokens,
reproducibly from its generator's seed.
"""

import jax
import numpy as np
import pytest
import torch

from apex_tpu.serving.engine import ServingEngine as JServingEngine
from apex_tpu.serving.scheduler import Request as JRequest
from apex_tpu.spec import NGramDrafter as JNGramDrafter
from apex_tpu.spec import NGramTreeDrafter as JNGramTreeDrafter
from apex_tpu.spec import PagedModelDrafter as JPagedModelDrafter
from apex_tpu_torch.models.convert import params_from_jax
from apex_tpu_torch.serving.engine import ServingEngine
from apex_tpu_torch.serving.scheduler import Request
from apex_tpu_torch.spec import (NGramDrafter, NGramTreeDrafter,
                                 PagedModelDrafter)
from test_torch_serving import _models

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ENGINE = dict(num_slots=3, block_size=16, prefill_chunk=16)
COUNTERS = ("decode_steps", "prefill_chunks", "blocks_high_water",
            "spec_rounds", "spec_drafted", "spec_accepted", "tree_rounds",
            "spec_nodes", "spec_degraded", "spec_slot_rounds")
DRAFTER = dict(num_layers=1, hidden_size=32, num_heads=2)


def trace(n=6, seed=0, newtok=(2, 24)):
    """(rid, prompt, max_new_tokens): prompts of 4-40 tokens, all
    arriving at t=0."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, int(rng.integers(4, 40))).astype(
        np.int32), int(rng.integers(*newtok))) for i in range(n)]


def serve_port(tm, tp, reqs, draft=None, adaptive=None, **kw):
    eng = ServingEngine(tm, device="cpu", **dict(ENGINE, **kw))
    done = eng.serve(tp, [Request(rid=r, prompt=p, max_new_tokens=n)
                          for r, p, n in reqs], clock=lambda: 0.0,
                     draft=draft, adaptive=adaptive)
    return eng, done


def serve_ref(jm, jp, reqs, draft=None, adaptive=None, **kw):
    eng = JServingEngine(jm, **dict(ENGINE, **kw))
    done = eng.serve(jp, [JRequest(rid=r, prompt=p, max_new_tokens=n)
                          for r, p, n in reqs], clock=lambda: 0.0,
                     telemetry=False, draft=draft, adaptive=adaptive)
    return eng, done


def tokens(done):
    return {r.rid: [int(t) for t in r.tokens] for r in done}


@pytest.fixture(scope="module")
def target():
    return _models()


@pytest.fixture(scope="module")
def drafter_model():
    """A 1-layer GPT with the target's vocabulary, on the JAX side and
    through the bridge on the port's."""
    from apex_tpu.models.gpt import GPTConfig as JGPTConfig
    from apex_tpu.models.gpt import GPTModel as JGPTModel
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

    cfg = dict(vocab_size=256, max_seq_len=128, **DRAFTER)
    jm = JGPTModel(JGPTConfig(**cfg, tp_size=1, remat=False,
                              attention_impl="flash"))
    np_tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(9)))
    tm = GPTModel(GPTConfig(**cfg, attention_impl="flash"))
    return (jm, jax.tree.map(jax.numpy.asarray, np_tree), tm,
            params_from_jax(np_tree, tm.config, device="cpu"))


@pytest.fixture(scope="module")
def plain(target):
    jm, jp, tm, tp = target
    reqs = trace()
    _, jdone = serve_ref(jm, jp, reqs)
    _, tdone = serve_port(tm, tp, reqs)
    assert tokens(jdone) == tokens(tdone)
    return tokens(tdone)


def _drafters(kind, target, drafter_model):
    jm, jp, tm, tp = target
    if kind == "ngram_chain":
        return JNGramDrafter(4), NGramDrafter(4)
    if kind == "ngram_tree":
        return JNGramTreeDrafter(4, 2), NGramTreeDrafter(4, 2)
    if kind == "paged":
        djm, djp, dtm, dtp = drafter_model
        return (JPagedModelDrafter(djm, djp, depth=3, branching=2),
                PagedModelDrafter(dtm, dtp, depth=3, branching=2,
                                  device="cpu"))
    # the target drafting for itself: every draft is accepted
    return (JPagedModelDrafter(jm, jp, depth=4, branching=2),
            PagedModelDrafter(tm, tp, depth=4, branching=2, device="cpu"))


@pytest.mark.parametrize("kind", ["ngram_chain", "ngram_tree", "paged",
                                  "self"])
def test_greedy_spec_serve_matches_reference(kind, target, drafter_model,
                                             plain):
    jm, jp, tm, tp = target
    jdraft, tdraft = _drafters(kind, target, drafter_model)
    reqs = trace()
    teng, tdone = serve_port(tm, tp, reqs, draft=tdraft)
    assert tokens(tdone) == plain
    jeng, jdone = serve_ref(jm, jp, reqs, draft=jdraft)
    assert tokens(jdone) == plain
    ts, js = teng.last_stats, jeng.last_stats
    assert {c: getattr(ts, c) for c in COUNTERS} \
        == {c: getattr(js, c) for c in COUNTERS}
    assert ts.spec_rounds > 0
    assert ts.tree_rounds == (0 if kind == "ngram_chain" else ts.spec_rounds
                              - ts.spec_degraded)
    assert ts.spec_acceptance_rate == js.spec_acceptance_rate
    assert ts.spec_efficiency == js.spec_efficiency
    if kind == "self":
        assert ts.spec_accepted == ts.spec_drafted
    if kind in ("paged", "self"):
        assert tdraft.peak_blocks == jdraft.peak_blocks > 0
        assert tdraft.pool_blocks() == 0


@pytest.mark.parametrize("tree", [False, True])
def test_sampled_spec_serve_with_top_p(tree, target):
    """T 0.8, top_k 20, top_p 0.9: every request completes with
    in-vocabulary tokens, and the same seed gives the same tokens."""
    _, _, tm, tp = target
    reqs = trace(seed=3)

    def run():
        eng = ServingEngine(tm, device="cpu", temperature=0.8, top_k=20,
                            top_p=0.9, **ENGINE)
        draft = NGramTreeDrafter(4, 2) if tree else NGramDrafter(4)
        done = eng.serve(tp, [Request(rid=r, prompt=p, max_new_tokens=n)
                              for r, p, n in reqs], clock=lambda: 0.0,
                         draft=draft,
                         generator=torch.Generator().manual_seed(4))
        assert eng.last_stats.spec_rounds > 0
        assert eng.last_stats.tree_rounds == (eng.last_stats.spec_rounds
                                              if tree else 0)
        return done

    done = run()
    assert sorted(r.rid for r in done) == [r for r, _, _ in reqs]
    for r in done:
        assert len(r.tokens) == r.max_new_tokens
        assert all(0 <= t < 256 for t in r.tokens)
    assert tokens(run()) == tokens(done)
