"""Port parity for the models' materialised-scores attention routes — the
reference's default ``attention_impl`` of all three models: GPT's
``"softmax"`` (the fused causal softmax) and ``"naive"`` (the plain fp32
composition), BERT's ``"softmax"`` with a pad mask that has interior
holes (which the flash route refuses), and T5's ``"softmax"`` in both
position modes (learned: every attention call through the fused masked
softmax; relative: the self-attention calls through the fp32 composition
with the materialised bias, the cross-attention through the kernel's
op).

Each compares the loss and every gradient leaf of the port (plain
versions, CPU tensors) against apex_tpu on the same weights (the
reference's own init, perturbed, through the weight bridge) and the same
seeded batch, with the reference's Pallas kernels in interpret mode
(``APEX_TPU_PALLAS=interpret``: layer norm and softmax at hidden and sk
multiples of 128; sk 114 takes its XLA path) and on its XLA paths
(``=0``). fp32, full-precision matmuls on both sides. Tolerances: the
loss to 1e-5 relative; every gradient leaf to 2e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.bert import BertConfig as JBertConfig
from apex_tpu.models.bert import BertModel as JBertModel
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.models.t5 import EncoderDecoderModel as JT5Model
from apex_tpu.models.t5 import T5Config as JT5Config
from apex_tpu_torch.models import convert
from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, param_leaves
from apex_tpu_torch.models.t5 import EncoderDecoderModel, T5Config

torch.backends.cuda.matmul.allow_tf32 = False

LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


def _perturbed(jp, seed):
    """The reference's init plus small noise: non-unit LN affines and
    nonzero biases, so every leaf's gradient path matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)


def _grads(params):
    def walk(x):
        if isinstance(x, torch.Tensor):
            return torch.zeros_like(x) if x.grad is None else x.grad
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return [walk(v) for v in x]
    return walk(params)


def _assert_trees_close(got, want, what="grad"):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(
            flat_g[path], w, rtol=0, atol=GRAD_RTOL * scale,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _reference(loss_fn, tree):
    jp = jax.tree.map(jnp.asarray, tree)
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    return float(loss), grads


def _leaves_require_grad(params):
    for t in param_leaves(params):
        t.requires_grad_()
    return params


# --- GPT -----------------------------------------------------------------------

GPT_SMALL = dict(vocab_size=512, max_seq_len=128, hidden_size=256,
                 num_layers=2, num_heads=2)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
@pytest.mark.parametrize("route,kv_heads", [("softmax", None),
                                            ("naive", None),
                                            ("softmax", 1)])
def test_gpt_routes_match_reference(pallas, route, kv_heads, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    cfg_kw = dict(GPT_SMALL, num_kv_heads=kv_heads, attention_impl=route,
                  remat=False)
    jm = JGPTModel(JGPTConfig(**cfg_kw, tp_size=1))
    tree = _perturbed(jm.init(jax.random.PRNGKey(0)), 1)
    rng = np.random.default_rng(2)
    V, S = GPT_SMALL["vocab_size"], GPT_SMALL["max_seq_len"]
    tokens = rng.integers(0, V, (2, S)).astype(np.int32)
    targets = rng.integers(0, V, (2, S)).astype(np.int32)
    loss_j, grads_j = _reference(lambda p: jm.loss_fn(
        p, jnp.asarray(tokens), jnp.asarray(targets)), tree)
    cfg = GPTConfig(**cfg_kw)
    params = _leaves_require_grad(convert.params_from_jax(tree, cfg,
                                                          device="cpu"))
    loss = GPTModel(cfg).loss_fn(params, torch.tensor(tokens),
                                 torch.tensor(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=LOSS_RTOL)
    _assert_trees_close(convert.params_to_jax(_grads(params), cfg), grads_j)


def test_gpt_routes_agree_and_the_default_is_softmax():
    """The three routes compute one function (the causal fills differ
    only where exp underflows to 0 either way); GPTConfig's default is the
    reference's "softmax"."""
    assert GPTConfig().attention_impl == JGPTConfig().attention_impl
    jm = JGPTModel(JGPTConfig(**GPT_SMALL, tp_size=1))
    tree = _perturbed(jm.init(jax.random.PRNGKey(3)), 4)
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, GPT_SMALL["vocab_size"], (2, 64)))
    losses = {}
    for route in ("softmax", "flash", "naive"):
        cfg = GPTConfig(**GPT_SMALL, attention_impl=route)
        params = convert.params_from_jax(tree, cfg, device="cpu")
        losses[route] = GPTModel(cfg).loss_fn(params, tokens,
                                              tokens.roll(1, 1)).item()
    assert losses["flash"] == pytest.approx(losses["softmax"], rel=1e-6)
    assert losses["naive"] == pytest.approx(losses["softmax"], rel=1e-6)


# --- BERT ----------------------------------------------------------------------

BERT_SMALL = dict(vocab_size=512, max_seq_len=128, num_layers=2,
                  hidden_size=256, num_heads=4)


def _bert_batch(seed=2):
    """tokens, targets, loss mask, token types, and a pad mask (True =
    padding) with interior holes: row 0 a suffix pad and two holes inside,
    row 1 holes only."""
    rng = np.random.default_rng(seed)
    b, s, V = 2, BERT_SMALL["max_seq_len"], BERT_SMALL["vocab_size"]
    pad = np.zeros((b, s), bool)
    pad[0, 90:] = True
    pad[0, [5, 40]] = True
    pad[1, 17:23] = True
    pad[1, 100] = True
    valid = ~pad
    return (rng.integers(0, V, (b, s)).astype(np.int32),
            rng.integers(0, V, (b, s)).astype(np.int32),
            ((rng.random((b, s)) < 0.3) & valid).astype(np.float32),
            ((np.arange(s)[None, :] >= 50) & valid).astype(np.int32),
            pad)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_bert_softmax_route_with_interior_mask_matches_reference(
        pallas, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    jm = JBertModel(JBertConfig(**BERT_SMALL, attention_impl="softmax"))
    tree = _perturbed(jm.init(jax.random.PRNGKey(0)), 1)
    batch = _bert_batch()
    loss_j, grads_j = _reference(lambda p: jm.mlm_loss(
        p, *map(jnp.asarray, batch)), tree)
    cfg = BertConfig(**BERT_SMALL)  # the default route, remat on
    assert cfg.attention_impl == "softmax" and cfg.remat
    params = _leaves_require_grad(convert.bert_params_from_jax(
        tree, cfg, device="cpu"))
    model = BertModel(cfg)
    loss = model.mlm_loss(params, *map(torch.tensor, batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=LOSS_RTOL)
    _assert_trees_close(convert.bert_params_to_jax(_grads(params), cfg),
                        grads_j)
    flash = BertModel(BertConfig(**BERT_SMALL, attention_impl="flash"))
    with pytest.raises(ValueError, match="attention_impl='softmax'"):
        flash.mlm_loss(params, *map(torch.tensor, batch))


# --- T5 ------------------------------------------------------------------------

T5_SMALL = dict(vocab_size=256, max_seq_len=128, hidden_size=128,
                num_encoder_layers=1, num_decoder_layers=1, num_heads=2,
                relative_num_buckets=32, relative_max_distance=64)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
@pytest.mark.parametrize("pe,s_dec,pad", [
    pytest.param("learned", 128, [100, 128], id="learned-padded"),
    pytest.param("relative", 128, [128, 77], id="relative-padded"),
    pytest.param("learned", 114, None, id="learned-dec114"),
])
def test_t5_softmax_route_matches_reference(pallas, pe, s_dec, pad,
                                            monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    jm = JT5Model(JT5Config(**T5_SMALL, attention_impl="softmax",
                            remat=False, position_encoding=pe))
    tree = _perturbed(jm.init(jax.random.PRNGKey(0)), 1)
    rng = np.random.default_rng(2)
    V = T5_SMALL["vocab_size"]
    enc = rng.integers(0, V, (2, 128)).astype(np.int32)
    dec = rng.integers(0, V, (2, s_dec)).astype(np.int32)
    tgt = rng.integers(0, V, (2, s_dec)).astype(np.int32)
    lens = None if pad is None else np.asarray(pad, np.int32)
    loss_j, grads_j = _reference(lambda p: jm.loss_fn(
        p, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(tgt),
        enc_pad_lens=None if lens is None else jnp.asarray(lens)), tree)
    cfg = T5Config(**T5_SMALL, position_encoding=pe, remat=False)
    assert cfg.attention_impl == "softmax"
    params = _leaves_require_grad(convert.t5_params_from_jax(
        tree, cfg, device="cpu"))
    loss = EncoderDecoderModel(cfg).loss_fn(
        params, *map(torch.tensor, (enc, dec, tgt)),
        enc_pad_lens=None if lens is None else torch.tensor(lens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=LOSS_RTOL)
    _assert_trees_close(convert.t5_params_to_jax(_grads(params), cfg),
                        grads_j)


def test_t5_softmax_route_materialises_the_bias():
    """The softmax route adds the materialised (1, h, sq, sk) bias
    whatever ``relative_bias_impl`` says, as the reference does."""
    cfg = T5Config(**T5_SMALL, position_encoding="relative")
    model = EncoderDecoderModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bias = model.enc_bias(params, 128, 128)
    assert torch.is_tensor(bias) and bias.shape == (1, 2, 128, 128)
