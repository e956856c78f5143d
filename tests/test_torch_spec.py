"""Port parity: apex_tpu_torch's speculative decoding against apex_tpu's —
the verify ops, the drafters and ``DecodeEngine.generate(draft=...)``.

The reference runs with ``APEX_TPU_PALLAS=interpret`` (its Pallas verify
kernels in interpret mode) and with ``=0``; the port runs its plain
versions (CPU tensors). Sampled verification gets the reference's own
noise: ``u_acc``/``u_gum`` are drawn here exactly as
``apex_tpu.ops.fused_verify`` draws them from its key and fed to the port.

Tolerances: verify verdicts (accept length, winning node, next token)
identical, greedy and sampled — the rows here hold no near-ties; spec
outputs token-identical to JAX's spec outputs and to the port's plain
greedy ``generate``; ``SpecStats`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference.engine import DecodeEngine as JDecodeEngine
from apex_tpu.ops.fused_verify import fused_verify as jverify
from apex_tpu.ops.fused_verify import fused_verify_tree as jverify_tree
from apex_tpu.ops.pallas import verify as jv
from apex_tpu.spec import ModelDrafter as JModelDrafter
from apex_tpu.spec import NGramDrafter as JNGramDrafter
from apex_tpu.spec import NGramTreeDrafter as JNGramTreeDrafter
from apex_tpu.spec.tree import draft_tree as jdraft_tree
from apex_tpu_torch.inference import DecodeEngine
from apex_tpu_torch.ops import fused_verify as vmod
from apex_tpu_torch.spec import (MAX_DRAFT_K, ModelDrafter, NGramDrafter,
                                 NGramTreeDrafter, draft_tree,
                                 validate_drafter)
from test_torch_decode_engine import GQA, MHA, MODES, jengines, models

V = 256
SAMPLED = dict(temperature=0.8, top_k=50)


@pytest.fixture(params=MODES)
def ref_mode(request, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", request.param)
    return request.param


@pytest.fixture(scope="module")
def mha():
    return models(MHA)


@pytest.fixture(scope="module")
def gqa():
    return models(GQA, seed=3)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_noise(key, b, rows):
    """The reference's own draws (``apex_tpu/ops/fused_verify.py``)."""
    ka, kg = jax.random.split(key)
    tiny = jnp.finfo(jnp.float32).tiny
    return (jax.random.uniform(ka, (b, rows), jnp.float32, minval=tiny,
                               maxval=1.0),
            jax.random.uniform(kg, (b, rows, V), jnp.float32, minval=tiny,
                               maxval=1.0))


def _logits(b, rows, seed):
    """Logits with a forced argmax tie in row 1 (indices 3 and 7)."""
    x = np.random.default_rng(seed).standard_normal((b, rows, V)).astype(
        np.float32) * 4.0
    x[:, 1, 7] = x[:, 1].max(-1) + 1.0
    x[:, 1, 3] = x[:, 1, 7]
    return x


def _chain_drafts(logits, seed):
    """Drafts that follow their row's argmax (ties to the lowest index)
    except the last, a random token — with top_k 50 of 256 usually one
    the filter removes."""
    cand = np.asarray(jv.row_argmax(jnp.asarray(logits)))
    drafted = cand[:, :-1].astype(np.int32).copy()
    drafted[:, -1] = np.random.default_rng(seed).integers(0, V,
                                                          drafted.shape[0])
    return drafted


class TestVerify:
    @pytest.mark.parametrize("temperature", [0.0, 0.8])
    def test_chain_verdicts_match_reference(self, ref_mode, temperature):
        b, k1 = 3, 5
        logits = _logits(b, k1, seed=1)
        drafted = _chain_drafts(logits, seed=2)
        # row 1 ties indices 3 and 7: draft 1 is 3 (accepted) except in
        # batch row 2, which drafts the tie's higher index (rejected)
        drafted[2, 1] = 7
        key = jax.random.PRNGKey(3)
        kw = dict(temperature=temperature, top_k=50)
        want = jverify(jnp.asarray(logits), jnp.asarray(drafted), key, **kw)
        noise = {}
        if temperature:
            u_acc, u_gum = _jax_noise(key, b, k1)
            noise = dict(u_acc=_t(u_acc), u_gum=_t(u_gum))
        got = vmod.fused_verify(_t(logits), _t(drafted), **kw, **noise)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if not temperature:
            assert (got[0] >= 1).any(), "some round must accept a draft"

    @pytest.mark.parametrize("temperature", [0.0, 0.8])
    def test_tree_verdicts_match_reference(self, ref_mode, temperature):
        b, topo = 3, draft_tree(2, 4)
        n1 = topo.n1
        logits = _logits(b, n1, seed=4)
        cand = np.asarray(jv.row_argmax(jnp.asarray(logits)))
        parents, anc = topo.operands(b)
        tokens = np.take_along_axis(cand, parents, axis=1).astype(np.int32)
        tokens[:, 2] = (tokens[:, 2] + 1) % V      # a wrong node mid-branch
        tokens[0, 5] = (tokens[0, 5] + 3) % V      # branch 1 rejected early
        tokens[:, -1] = np.random.default_rng(5).integers(0, V, b)
        key = jax.random.PRNGKey(6)
        kw = dict(temperature=temperature, top_k=50)
        want = jverify_tree(jnp.asarray(logits), jnp.asarray(tokens),
                            jnp.asarray(parents), jnp.asarray(anc), key,
                            **kw)
        noise = {}
        if temperature:
            u_acc, u_gum = _jax_noise(key, b, n1)
            noise = dict(u_acc=_t(u_acc), u_gum=_t(u_gum))
        got = vmod.fused_verify_tree(_t(logits), _t(tokens), _t(parents),
                                     _t(anc), **kw, **noise)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_helpers_match_reference(self):
        rng = np.random.default_rng(0)
        s = rng.integers(0, 4, (6, 9, 32)).astype(np.float32)  # many ties
        np.testing.assert_array_equal(vmod.row_argmax(_t(s)).numpy(),
                                      np.asarray(jv.row_argmax(
                                          jnp.asarray(s))))
        anc = draft_tree(3, 3).operands(6)[1]
        for _ in range(5):
            acc = rng.random((6, 10)) < 0.6
            got = vmod.tree_accepted_path(_t(acc), _t(anc))
            want = jv.tree_accepted_path(jnp.asarray(acc), jnp.asarray(anc))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        topo, jtopo = draft_tree(2, 4), jdraft_tree(2, 4)
        np.testing.assert_array_equal(topo.parents, jtopo.parents)
        np.testing.assert_array_equal(topo.anc, jtopo.anc)
        assert topo.path_tokens(list(range(10, 18)), 2, 6, 99) \
            == jtopo.path_tokens(list(range(10, 18)), 2, 6, 99)

    def test_generator_noise_and_bad_inputs(self):
        logits = _t(_logits(1, 5, seed=8))
        drafted = _t(_chain_drafts(_logits(1, 5, seed=8), seed=9))
        a1 = vmod.fused_verify(logits, drafted,
                               torch.Generator().manual_seed(1), **SAMPLED)
        a2 = vmod.fused_verify(logits, drafted,
                               torch.Generator().manual_seed(1), **SAMPLED)
        assert all(torch.equal(x, y) for x, y in zip(a1, a2))
        with pytest.raises(ValueError, match="requires a generator"):
            vmod.fused_verify(logits, drafted, **SAMPLED)
        with pytest.raises(ValueError, match="drafted must be"):
            vmod.fused_verify(logits, drafted[:, :2])
        with pytest.raises(ValueError, match="k >= 1"):
            vmod.fused_verify(logits[:, :1], drafted[:, :0])
        with pytest.raises(ValueError, match="CUDA"):
            vmod.fused_verify_cuda(logits, torch.zeros((1, 5),
                                                       dtype=torch.int32),
                                   None, None, temperature=0.0, top_k=0)


def _repeat_prompt(seed, block=32, reps=4):
    """A block repeated: n-gram drafters find matches."""
    blk = np.random.default_rng(seed).integers(0, V, block)
    return np.tile(blk, reps)[None].astype(np.int32)


def _drafters(kind, jm, jp, tm, tp):
    if kind == "ngram":
        return JNGramDrafter(4), NGramDrafter(4)
    if kind == "model":
        return (JModelDrafter(jm, jp, k=4),
                ModelDrafter(tm, tp, k=4, device="cpu"))
    return JNGramTreeDrafter(4, 2), NGramTreeDrafter(4, 2)


class TestSpecGenerate:
    @pytest.mark.parametrize("kind", ["ngram", "tree"])
    def test_greedy_spec_token_identical_mha(self, ref_mode, kind, mha,
                                             jengines):
        self._check(jengines(mha[0], ref_mode), mha, kind, n_new=24)

    def test_model_drafter_spec_token_identical(self, monkeypatch, mha,
                                                jengines):
        """The reference's XLA path only: its drafter teacher-forces the
        128-token prompt through one decode step per token, which under
        interpret-mode kernels costs several times the other cases; the
        chain round under interpret mode is the n-gram cases'."""
        monkeypatch.setenv("APEX_TPU_PALLAS", "0")
        self._check(jengines(mha[0], "0"), mha, "model", n_new=24)

    @pytest.mark.parametrize("kind", ["ngram", "tree"])
    def test_greedy_spec_token_identical_gqa(self, ref_mode, kind, gqa,
                                             jengines):
        self._check(jengines(gqa[0], ref_mode), gqa, kind, n_new=16)

    @staticmethod
    def _check(jeng, models_, kind, n_new):
        jm, jp, tm, tp = models_
        toks = _repeat_prompt(seed=1)
        jdraft, draft = _drafters(kind, jm, jp, tm, tp)
        with jax.default_matmul_precision("highest"):
            want = jeng.generate(jp, jnp.asarray(toks), n_new, draft=jdraft)
        eng = DecodeEngine(tm, device="cpu")
        plain = eng.generate(tp, torch.from_numpy(toks), n_new)
        got = eng.generate(tp, torch.from_numpy(toks), n_new, draft=draft)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        st, jst = eng.last_spec_stats, jeng.last_spec_stats
        assert (st.rounds, st.drafted, st.accepted, st.nodes) == \
            (jst.rounds, jst.drafted, jst.accepted, jst.nodes)
        assert st.rounds < n_new - 1, "speculation saved no round"

    def test_sampled_spec_runs_on_a_generator(self, mha):
        _, _, tm, tp = mha
        toks = torch.from_numpy(_repeat_prompt(seed=2))
        eng = DecodeEngine(tm, device="cpu", **SAMPLED)
        outs = [eng.generate(tp, toks, 12,
                             generator=torch.Generator().manual_seed(5),
                             draft=d)
                for d in (NGramDrafter(4), NGramDrafter(4),
                          NGramTreeDrafter(4, 2))]
        assert torch.equal(outs[0], outs[1])
        for out in outs:
            assert out.shape == (1, 12)
            assert ((out >= 0) & (out < V)).all()


class TestValidation:
    def test_errors_match_reference(self, mha):
        jm, jp, tm, tp = mha
        eng, jeng = DecodeEngine(tm, device="cpu"), JDecodeEngine(jm)
        two = np.zeros((2, 128), np.int32)
        for jd, d in ((JNGramDrafter(4), NGramDrafter(4)),
                      (JNGramTreeDrafter(4, 2), NGramTreeDrafter(4, 2))):
            with pytest.raises(ValueError, match="batch 1"):
                jeng.generate(jp, jnp.asarray(two), 4, draft=jd)
            with pytest.raises(ValueError, match="batch 1"):
                eng.generate(tp, torch.from_numpy(two), 4, draft=d)
        # k draft rows past the cache: 128 + 126 + 4 - 1 > 256
        one = np.zeros((1, 128), np.int32)
        with pytest.raises(ValueError, match="exceeds the cache"):
            jeng.generate(jp, jnp.asarray(one), 126, draft=JNGramDrafter(4))
        with pytest.raises(ValueError, match="exceeds the cache"):
            eng.generate(tp, torch.from_numpy(one), 126,
                         draft=NGramDrafter(4))
        for cls in (NGramDrafter, ModelDrafter):
            with pytest.raises(ValueError, match="k must be in"):
                (cls(MAX_DRAFT_K + 1) if cls is NGramDrafter else
                 cls(tm, tp, k=MAX_DRAFT_K + 1, device="cpu"))
        with pytest.raises(ValueError, match="MAX_DRAFT_K"):
            NGramTreeDrafter(depth=8, branching=5)

        class Other(NGramDrafter):
            vocab_size = 512
        with pytest.raises(ValueError, match="vocab_size"):
            validate_drafter(Other(4), tm.config, needed_rows=200)
