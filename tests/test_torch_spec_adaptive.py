"""Port parity on the CPU (fp32) for the rest of speculative serving:
drafter-pool preemption, the adaptive shape controller end to end, and
``DecodeEngine.generate(adaptive=)``.

* Drafter-pool preemption, held to the contract of the reference's
  ``tests/test_tree_spec.py::TestDrafterPoolAccounting::
  test_preemption_evicts_drafter_blocks`` at a pool that really
  preempts: 3 slots of 16-row blocks and ``num_blocks=7`` (6 allocatable
  for requests of up to 63 rows, 4 blocks each, beside the drafter's own
  blocks). The spec serve with a ``PagedModelDrafter`` evicts streams
  that hold drafter blocks (``evictions > 0``), its ladder degrades
  rounds (``spec_degraded > 0``), the allocator's accounting is exact at
  drain with no drafter block left, and every request's tokens equal the
  plain serve's at the same pool size, the port's and the reference's.
* ``serve(draft=NGramTreeDrafter, adaptive=AdaptiveSpecController)``:
  tokens equal the plain serve's, every counter the reference's adaptive
  serve's, and every dispatched tree shape is one of the controller's
  choices.
* ``DecodeEngine.generate(draft=NGramTreeDrafter, adaptive=...)`` at
  greedy: token-identical to the reference's and to plain greedy, with
  the same ``SpecStats``.
* ``serve``'s and ``generate``'s knob checks raise as the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference.engine import DecodeEngine as JDecodeEngine
from apex_tpu.spec import AdaptiveSpecController as JAdaptive
from apex_tpu.spec import NGramDrafter as JNGramDrafter
from apex_tpu.spec import NGramTreeDrafter as JNGramTreeDrafter
from apex_tpu_torch.inference import DecodeEngine
from apex_tpu_torch.spec import (AdaptiveSpecController, NGramDrafter,
                                 NGramTreeDrafter, PagedModelDrafter)
from test_torch_decode_engine import MHA, models
from test_torch_serving import _models
from test_torch_spec_serve import (COUNTERS, DRAFTER, serve_port, serve_ref,
                                   tokens, trace)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the pool at which the drafter's blocks and the target streams' really
#: compete: 6 allocatable blocks of 16 rows for 3 slots
PREEMPT_BLOCKS = 7


@pytest.fixture(scope="module")
def target():
    return _models()


def test_drafter_pool_preemption(target):
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

    jm, jp, tm, tp = target
    dm = GPTModel(GPTConfig(vocab_size=256, max_seq_len=128, **DRAFTER))
    dp = dm.init(torch.Generator().manual_seed(9), device="cpu")
    reqs = trace(n=8)
    _, jplain = serve_ref(jm, jp, reqs, num_blocks=PREEMPT_BLOCKS)
    _, tplain = serve_port(tm, tp, reqs, num_blocks=PREEMPT_BLOCKS)
    assert tokens(tplain) == tokens(jplain)
    draft = PagedModelDrafter(dm, dp, depth=3, branching=2, device="cpu")
    eng, done = serve_port(tm, tp, reqs, draft=draft,
                           num_blocks=PREEMPT_BLOCKS)
    assert tokens(done) == tokens(tplain)
    assert any(r.evictions > 0 for r in done), \
        "pool pressure never preempted a stream"
    assert eng.last_stats.spec_degraded > 0, "the headroom ladder never ran"
    assert draft.peak_blocks > 0 and draft.pool_blocks() == 0
    alloc = draft._alloc
    alloc.check_accounting()
    assert alloc.num_live == alloc.num_resident


class _Recording(AdaptiveSpecController):
    """The controller, recording every round shape it hands out."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.shapes = []

    def round_shape(self, streams):
        shape = super().round_shape(streams)
        self.shapes.append(shape)
        return shape


def test_adaptive_serve_matches_reference(target):
    jm, jp, tm, tp = target
    reqs = trace(n=6, seed=5, newtok=(8, 40))
    _, plain = serve_port(tm, tp, reqs)
    kw = dict(choices=((2, 1), (4, 1), (4, 2)), window=2)
    ctl = _Recording(**kw)
    eng, done = serve_port(tm, tp, reqs, draft=NGramTreeDrafter(4, 2),
                           adaptive=ctl)
    jeng, jdone = serve_ref(jm, jp, reqs, draft=JNGramTreeDrafter(4, 2),
                            adaptive=JAdaptive(**kw))
    assert tokens(done) == tokens(plain) == tokens(jdone)
    ts, js = eng.last_stats, jeng.last_stats
    assert {c: getattr(ts, c) for c in COUNTERS} \
        == {c: getattr(js, c) for c in COUNTERS}
    assert ctl.adjustments > 0 and set(ctl.shapes) <= set(kw["choices"])
    assert len(set(ctl.shapes)) > 1


def test_serve_knob_checks_match_reference(target):
    jm, jp, tm, tp = target
    cases = [
        (dict(adaptive="A"), "needs a drafter"),
        (dict(draft="chain", adaptive="A"), "TREE drafter"),
        (dict(draft="tree2", adaptive="A"), "depth"),
        (dict(draft="k0"), "draft.k"),
    ]
    for kw, match in cases:
        for side in ("ref", "port"):
            ref = side == "ref"
            args = {}
            if "draft" in kw:
                args["draft"] = {
                    "chain": (JNGramDrafter if ref else NGramDrafter)(4),
                    "tree2": (JNGramTreeDrafter if ref
                              else NGramTreeDrafter)(2, 2),
                    "k0": type("D", (), {"k": 0})()}[kw["draft"]]
            if "adaptive" in kw:
                args["adaptive"] = (JAdaptive if ref
                                    else AdaptiveSpecController)()
            with pytest.raises(ValueError, match=match):
                if ref:
                    serve_ref(jm, jp, trace(n=1), **args)
                else:
                    serve_port(tm, tp, trace(n=1), **args)


@pytest.fixture(scope="module")
def mha():
    return models(MHA)


def test_generate_adaptive_matches_reference(mha, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", "0")
    jm, jp, tm, tp = mha
    blk = np.random.default_rng(1).integers(0, 256, 32)
    toks = np.tile(blk, 4)[None].astype(np.int32)
    n_new = 40
    kw = dict(choices=((2, 1), (4, 1), (4, 2)), window=2)
    jeng = JDecodeEngine(jm)
    with jax.default_matmul_precision("highest"):
        want = jeng.generate(jp, jnp.asarray(toks), n_new,
                             draft=JNGramTreeDrafter(4, 2),
                             adaptive=JAdaptive(**kw))
    eng = DecodeEngine(tm, device="cpu")
    plain = eng.generate(tp, torch.from_numpy(toks), n_new)
    ctl = AdaptiveSpecController(**kw)
    got = eng.generate(tp, torch.from_numpy(toks), n_new,
                       draft=NGramTreeDrafter(4, 2), adaptive=ctl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    st, jst = eng.last_spec_stats, jeng.last_spec_stats
    assert (st.rounds, st.drafted, st.accepted, st.nodes) == \
        (jst.rounds, jst.drafted, jst.accepted, jst.nodes)
    assert ctl.adjustments > 0
    with pytest.raises(ValueError, match="requires draft"):
        eng.generate(tp, torch.from_numpy(toks), 2, adaptive=ctl)
    with pytest.raises(ValueError, match="tree-capable"):
        eng.generate(tp, torch.from_numpy(toks), 2, draft=NGramDrafter(4),
                     adaptive=ctl)
