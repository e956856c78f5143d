"""Port parity: apex_tpu_torch's DecodeEngine path against apex_tpu's, on the
same weights (through the bridge) and the same inputs.

The reference runs with ``APEX_TPU_PALLAS=interpret`` (its Pallas flash,
decode and verify kernels in interpret mode) and with ``=0`` (its XLA
compositions); the port runs its plain versions (CPU tensors). fp32
throughout, matmuls in full fp32 on both sides. The model is small but
kernel-eligible for the reference: head_dim 128 (2 heads of 128 over hidden
256, and a GQA case of 4 heads over 2 kv heads at hidden 512), a
128-multiple cache and prompts, so its prefill and decode take the kernels
under ``interpret``.

Tolerances: attention outputs and the prefill cache within 1e-5 (fp32 sums
in another order); logits within 1e-4 (two layers of such sums); greedy
tokens identical; sampled tokens identical on shared noise (JAX's own
uniforms fed to the port, after checking that Gumbel-argmax on them
reproduces ``jax.random.categorical``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference.engine import DecodeEngine as JDecodeEngine
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.ops.attention import flash_attention as jflash
from apex_tpu.ops.decode_attention import decode_attention as jdecode
from apex_tpu_torch.inference import DecodeEngine
from apex_tpu_torch.inference.sampling import sample_logits
from apex_tpu_torch.models.convert import params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.ops import attention as amod
from apex_tpu_torch.ops import decode_attention as dmod

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MODES = ["interpret", "0"]
MHA = dict(vocab_size=256, max_seq_len=256, hidden_size=256, num_layers=2,
           num_heads=2)
GQA = dict(MHA, hidden_size=512, num_heads=4, num_kv_heads=2)
SAMPLED = dict(temperature=0.8, top_k=50)


def models(cfg, seed=0):
    """(JAX model, JAX params, port model, port params) on one seeded
    weight tree; biases and LN affines perturbed so every leaf matters."""
    jm = JGPTModel(JGPTConfig(**cfg, tp_size=1, remat=False,
                              attention_impl="flash"))
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    np_tree = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
        .astype(np.float32), jp)
    tm = GPTModel(GPTConfig(**cfg, attention_impl="flash"))
    return (jm, jax.tree.map(jnp.asarray, np_tree), tm,
            params_from_jax(np_tree, tm.config, device="cpu"))


def prompt(b, s, vocab=256, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(params=MODES)
def ref_mode(request, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", request.param)
    return request.param


@pytest.fixture(scope="module")
def jengines():
    """One reference engine per (model, reference mode, knobs) for the
    module: its jitted programs compile once, not once per test. The mode
    is in the key because it is read while the programs trace."""
    cache = {}

    def get(jm, mode, **kw):
        key = (id(jm), mode, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = JDecodeEngine(jm, **kw)
        return cache[key]
    return get


@pytest.fixture(scope="module")
def mha():
    return models(MHA)


@pytest.fixture(scope="module")
def gqa():
    return models(GQA, seed=3)


class TestKernelsPlainVersions:
    @pytest.mark.parametrize("b,sq,sk,h,h_kv", [
        pytest.param(2, 128, 128, 2, 2, id="mha"),
        pytest.param(2, 128, 128, 4, 2, id="gqa"),
        pytest.param(1, 128, 256, 4, 1, id="sq<sk"),
    ])
    def test_flash_bshd_matches_reference(self, ref_mode, b, sq, sk, h,
                                          h_kv):
        rng = np.random.default_rng(sq + sk + h_kv)
        d = 128
        q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
        k = rng.standard_normal((b, sk, h_kv, d)).astype(np.float32)
        v = rng.standard_normal((b, sk, h_kv, d)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, layout="bshd")
        got = amod.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   layout="bshd")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATTN_TOL)

    @pytest.mark.parametrize("h,h_kv,lengths", [
        pytest.param(4, 4, [0, 1, 128, 255], id="mha"),
        pytest.param(8, 2, [77, 0, 256, 130], id="gqa"),
    ])
    def test_contiguous_decode_matches_reference(self, h, h_kv, lengths):
        rng = np.random.default_rng(h_kv)
        b, max_s, d = len(lengths), 256, 128
        q = rng.standard_normal((b, h, d)).astype(np.float32)
        k = rng.standard_normal((b, h_kv, max_s, d)).astype(np.float32)
        v = rng.standard_normal((b, h_kv, max_s, d)).astype(np.float32)
        lens = np.asarray(lengths, np.int32)
        got = dmod.decode_attention(*(torch.from_numpy(a)
                                      for a in (q, k, v, lens))).numpy()
        for impl in ("xla", "pallas"):  # pallas: interpret mode off-TPU
            want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lens), impl=impl)
            np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
        assert not got[lens == 0].any(), "length-0 rows must be zeros"

    def test_flash_attention_later_options_raise(self):
        x = torch.zeros((1, 8, 2, 64))
        # the bh-flat layout is the default (as in the reference) and runs
        assert amod.flash_attention(x, x, x).shape == x.shape
        # per-batch kv_lens, an array bias and dropout run on the bshd
        # layout now; the bucketed bias there is a later slice
        assert amod.flash_attention(x, x, x, layout="bshd",
                                    kv_lens=torch.ones(1)).shape == x.shape
        assert amod.flash_attention(x, x, x, layout="bshd", dropout_rate=0.1,
                                    dropout_seed=3).shape == x.shape
        with pytest.raises(NotImplementedError, match="later slice"):
            amod.flash_attention(x, x, x, layout="bshd",
                                 bias=amod.BucketedBias(torch.zeros(32, 2)))
        with pytest.raises(ValueError, match="bias must be"):
            amod.flash_attention(x, x, x, layout="bshd", bias=x)
        with pytest.raises(ValueError, match="sq <= sk"):
            amod.flash_attention(x, x[:, :4], x[:, :4], causal=True,
                                 layout="bshd")
        # the backward runs (flash_bwd_bshd's plain version here)
        q = torch.zeros((1, 8, 2, 64), requires_grad=True)
        amod.flash_attention(q, x, x, layout="bshd").sum().backward()
        assert q.grad.shape == q.shape


class TestEngine:
    @pytest.mark.parametrize("which", ["mha", "gqa"])
    def test_prefill_cache_matches_reference(self, ref_mode, which,
                                             request, jengines):
        jm, jp, tm, tp = request.getfixturevalue(which)
        toks = prompt(2, 128)
        jeng = jengines(jm, ref_mode)
        with jax.default_matmul_precision("highest"):
            jcache, jtok, jlog = jeng.prefill(jp, jnp.asarray(toks),
                                              jax.random.PRNGKey(0))
        eng = DecodeEngine(tm, device="cpu")
        cache, tok, logits = eng.prefill(tp, torch.from_numpy(toks))
        for name in ("k", "v"):
            assert cache[name].shape == jcache[name].shape
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), **ATTN_TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))

    @pytest.mark.parametrize("which", ["mha", "gqa"])
    def test_greedy_generate_token_identical(self, ref_mode, which,
                                             request, jengines):
        jm, jp, tm, tp = request.getfixturevalue(which)
        toks = prompt(2, 128, seed=7)
        with jax.default_matmul_precision("highest"):
            want = jengines(jm, ref_mode).generate(jp, jnp.asarray(toks),
                                                   24)
        got = DecodeEngine(tm, device="cpu").generate(
            tp, torch.from_numpy(toks), 24)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_gumbel_argmax_reproduces_jax_categorical(self):
        """The premise of the sampled parity test: on the installed jax,
        ``categorical(key, s)`` is the argmax of ``s - log(-log(u))`` for
        ``u = uniform(key, minval=tiny, maxval=1)``."""
        s = jnp.asarray(np.random.default_rng(0).standard_normal((4, 256))
                        .astype(np.float32) * 3)
        tiny = jnp.finfo(jnp.float32).tiny
        for i in range(8):
            key = jax.random.PRNGKey(i)
            u = jax.random.uniform(key, s.shape, jnp.float32, minval=tiny,
                                   maxval=1.0)
            got = sample_logits(torch.tensor(np.asarray(s)),
                                temperature=1.0,
                                u=torch.tensor(np.asarray(u)))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax.random.categorical(key, s)))

    def test_sampled_generate_token_identical_on_shared_noise(
            self, monkeypatch, mha, jengines):
        """JAX's generate draws step t from ``fold_in(key, t)``; the port's
        steps take those uniforms, and its own generate draws the same
        steps from a generator. The reference's sampled tail has no Pallas
        kernel, so its XLA path suffices here; the kernels under the
        sampled steps are the greedy tests'."""
        ref_mode = "0"
        monkeypatch.setenv("APEX_TPU_PALLAS", ref_mode)
        jm, jp, tm, tp = mha
        toks = prompt(2, 128, seed=9)
        key, n_new, V = jax.random.PRNGKey(4), 16, MHA["vocab_size"]
        with jax.default_matmul_precision("highest"):
            want = jengines(jm, ref_mode, **SAMPLED).generate(
                jp, jnp.asarray(toks), n_new, key)
        tiny = jnp.finfo(jnp.float32).tiny
        noise = [torch.tensor(np.asarray(jax.random.uniform(
            jax.random.fold_in(key, t), (2, V), jnp.float32, minval=tiny,
            maxval=1.0))) for t in range(n_new)]
        eng = DecodeEngine(tm, device="cpu", **SAMPLED)
        cache, tok, _ = eng.prefill(tp, torch.from_numpy(toks), u=noise[0])
        out = [tok]
        for t in range(1, n_new):
            cache, tok, _ = eng.decode_step(tp, cache, tok, 128 + t - 1,
                                            u=noise[t])
            out.append(tok)
        got = torch.stack(out, dim=1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        greedy = jengines(jm, ref_mode).generate(jp, jnp.asarray(toks),
                                                 n_new)
        assert (np.asarray(want) != np.asarray(greedy)).any()

        # generate(generator=g) is the same loop on g's draws, in order
        g = torch.Generator().manual_seed(11)
        drawn = torch.Generator().manual_seed(11)
        mine = eng.generate(tp, torch.from_numpy(toks), 6, generator=g)
        cache, tok, _ = eng.prefill(tp, torch.from_numpy(toks),
                                    generator=drawn)
        out = [tok]
        for t in range(1, 6):
            cache, tok, _ = eng.decode_step(tp, cache, tok, 128 + t - 1,
                                            generator=drawn)
            out.append(tok)
        assert torch.equal(mine, torch.stack(out, dim=1))

    def test_cache_is_written_in_place(self, mha):
        _, _, tm, tp = mha
        eng = DecodeEngine(tm, device="cpu")
        cache = eng.init_cache(2)
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        toks = torch.from_numpy(prompt(2, 128))
        out, tok, _ = eng.prefill(tp, toks, cache=cache)
        assert out is cache
        for t in range(3):
            out, tok, _ = eng.decode_step(tp, cache, tok, 128 + t)
        assert {k: v.data_ptr() for k, v in out.items()} == ptrs
        assert cache["k"][:, :, :, 131:].abs().sum() == 0
        assert cache["k"][:, :, :, 130].abs().sum() > 0
        assert eng.cache_bytes(2) == sum(v.numel() * 4 for v in
                                         cache.values())

    def test_cpu_tensors_never_reach_the_kernels(self, mha):
        _, _, tm, tp = mha
        before = (amod.flash_fwd_bshd_cuda.launches,
                  dmod.decode_attn_cuda.launches)
        DecodeEngine(tm, device="cpu").generate(
            tp, torch.from_numpy(prompt(1, 128)), 3)
        assert (amod.flash_fwd_bshd_cuda.launches,
                dmod.decode_attn_cuda.launches) == before


class TestValidation:
    def test_errors_match_reference(self, mha):
        jm, jp, tm, tp = mha
        for bad in (200, 384):
            with pytest.raises(ValueError) as jerr:
                JDecodeEngine(jm, max_seq_len=bad)
            with pytest.raises(ValueError) as terr:
                DecodeEngine(tm, max_seq_len=bad, device="cpu")
            assert str(terr.value).split(" (")[0] \
                == str(jerr.value).split(" (")[0]
        eng = DecodeEngine(tm, device="cpu")
        jeng = JDecodeEngine(jm)
        toks = prompt(1, 200)
        for n_new, match in ((57, "exceeds the cache"),
                             (0, "max_new_tokens must be")):
            with pytest.raises(ValueError, match=match):
                jeng.generate(jp, jnp.asarray(toks), n_new)
            with pytest.raises(ValueError, match=match):
                eng.generate(tp, torch.from_numpy(toks), n_new)
        with pytest.raises(ValueError, match="requires a generator"):
            DecodeEngine(tm, device="cpu", **SAMPLED).generate(
                tp, torch.from_numpy(toks), 2)

    def test_later_slice_knobs_are_not_in_the_signatures(self, mha):
        _, _, tm, tp = mha
        with pytest.raises(TypeError):
            DecodeEngine(tm, device="cpu", plan=object())
        # adaptive= is ported with the tree path; without a drafter it
        # is refused as the reference refuses it
        with pytest.raises(ValueError, match="requires draft"):
            DecodeEngine(tm, device="cpu").generate(
                tp, torch.from_numpy(prompt(1, 128)), 2, adaptive=object())

    def test_entry_point_defaults_to_the_card(self, mha, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecodeEngine(mha[2])
