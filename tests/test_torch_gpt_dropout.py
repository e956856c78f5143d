"""Port parity for GPT's train step with dropout and its remat policies:
apex_tpu_torch's ``GPTModel.loss_fn(..., dropout_seeds=)`` and its
gradients against apex_tpu's ``loss_fn(..., key)`` on the same weights,
tokens and masks, on the three attention routes.

The seeds carry the key across: the reference folds its key per layer i
and per slot s (``gpt.py:806``/``:826``, then ``:366``, ``:508``/``:516``,
``:630``, ``:643``) and draws each seed with ``seed_from_key`` (at tp=1 no
tp fold); the port is handed ``seeds[i, s] = seed_from_key(fold_in(
fold_in(key, i), s))``. The reference runs its Pallas kernels in
interpret mode and its XLA paths (the naive route has no kernel); the
port its plain versions (CPU tensors). fp32, full-precision matmuls.
Tolerances: the loss within 1e-5 relative, every gradient leaf within
2e-4 of its largest entry (fp32 sums in another order through attention,
layer norm and the tied head; the masks themselves are exact). The remat
policies recompute the same operations, masks included, and a run
without seeds is the dropout-free model: their losses and gradients equal
the counterpart's within 1e-6 of each leaf's largest entry (the CPU's
parallel sums, such as the embedding's backward, may add in another
order from run to run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.ops.attention import seed_from_key
from apex_tpu_torch.inference.engine import DecodeEngine
from apex_tpu_torch.models.convert import params_from_jax, params_to_jax
from apex_tpu_torch.models.gpt import (REMAT_POLICIES, GPTConfig, GPTModel,
                                       param_leaves)
from apex_tpu_torch.serving.engine import ServingEngine
from apex_tpu_torch.serving.scheduler import Request

torch.backends.cuda.matmul.allow_tf32 = False

SMALL = dict(vocab_size=512, max_seq_len=128, hidden_size=256, num_layers=2,
             num_heads=2)
B = 2
RATE = 0.1
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    jm = JGPTModel(JGPTConfig(**SMALL, tp_size=1, remat=False,
                              attention_impl="flash"))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, SMALL["vocab_size"], (B, SMALL["max_seq_len"]))
    targets = rng.integers(0, SMALL["vocab_size"], (B, SMALL["max_seq_len"]))
    return tree, tokens.astype(np.int32), targets.astype(np.int32)


def reference_seeds(key, num_layers):
    """(num_layers, 3) int32: the seeds the reference draws from ``key``."""
    return torch.tensor([[int(seed_from_key(jax.random.fold_in(
        jax.random.fold_in(key, i), s))) for s in range(3)]
        for i in range(num_layers)], dtype=torch.int32)


def _port(tree, **kw):
    cfg = GPTConfig(**SMALL, **kw)
    params = params_from_jax(tree, cfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_()
    return GPTModel(cfg), cfg, params


def _grads(params):
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.grad
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return [walk(v) for v in x]
    return walk(params)


def _assert_trees_close(got, want, rel, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(
            flat_g[path], w, rtol=0, atol=rel * scale,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _port_loss_and_grads(tree, tokens, targets, seeds, **kw):
    model, cfg, params = _port(tree, **kw)
    loss = model.loss_fn(params, torch.tensor(tokens), torch.tensor(targets),
                         dropout_seeds=seeds)
    loss.backward()
    return loss.item(), params_to_jax(_grads(params), cfg)


@pytest.mark.parametrize("route,pallas", [
    ("flash", "interpret"), ("flash", "0"), ("softmax", "interpret"),
    ("softmax", "0"), ("naive", "0")])
def test_loss_and_gradients_with_dropout_match_reference(setup, route, pallas,
                                                         monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    tree, tokens, targets = setup
    jm = JGPTModel(JGPTConfig(**SMALL, tp_size=1, remat=False,
                              attention_impl=route, dropout=RATE))
    key = jax.random.PRNGKey(11)
    jp = jax.tree.map(jnp.asarray, tree)
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(p, jnp.asarray(tokens), jnp.asarray(targets),
                                 key)))(jp)
    seeds = reference_seeds(key, SMALL["num_layers"])
    loss, grads = _port_loss_and_grads(tree, tokens, targets, seeds,
                                       remat=False, attention_impl=route,
                                       dropout=RATE)
    np.testing.assert_allclose(loss, float(loss_j), rtol=LOSS_RTOL)
    _assert_trees_close(grads, grads_j, GRAD_RTOL, f"{route} grad")
    # the reference without a key drops nothing: neither do None seeds
    loss0, _ = _port_loss_and_grads(tree, tokens, targets, None,
                                    remat=False, attention_impl=route,
                                    dropout=RATE)
    assert abs(loss0 - loss) > 1e-4


@pytest.mark.parametrize("route", ["flash", "softmax"])
def test_no_seeds_equals_the_dropout_free_model(setup, route):
    """``dropout_seeds=None`` is the reference's ``key=None``; seeds with
    a dropout-0 config drop nothing either."""
    tree, tokens, targets = setup
    seeds = GPTModel(GPTConfig(**SMALL)).dropout_seeds(
        torch.Generator().manual_seed(3))
    loss0, g0 = _port_loss_and_grads(tree, tokens, targets, None,
                                     remat=False, attention_impl=route)
    for kw, s in ((dict(dropout=RATE), None), (dict(dropout=0.0), seeds)):
        loss, g = _port_loss_and_grads(tree, tokens, targets, s,
                                       remat=False, attention_impl=route,
                                       **kw)
        assert loss == loss0
        _assert_trees_close(g, g0, 1e-6, f"{kw} grad")


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("route", ["flash", "softmax"])
def test_every_remat_policy_equals_remat_off(setup, policy, route):
    """Each policy recomputes (part of) the block in the backward, the
    dropout masks rebuilt from the same seeds: the loss and every
    gradient equal remat off's."""
    tree, tokens, targets = setup
    seeds = GPTModel(GPTConfig(**SMALL)).dropout_seeds(
        torch.Generator().manual_seed(5))
    kw = dict(attention_impl=route, dropout=RATE)
    loss0, g0 = _port_loss_and_grads(tree, tokens, targets, seeds,
                                     remat=False, **kw)
    loss, g = _port_loss_and_grads(tree, tokens, targets, seeds, remat=True,
                                   remat_policy=policy, **kw)
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    _assert_trees_close(g, g0, 1e-6, f"{policy} grad")


def test_dropout_seeds_and_config_checks(setup):
    tree, tokens, _ = setup
    model = GPTModel(GPTConfig(**SMALL, dropout=RATE))
    s1 = model.dropout_seeds(torch.Generator().manual_seed(0))
    s2 = model.dropout_seeds(torch.Generator().manual_seed(0))
    assert s1.shape == (SMALL["num_layers"], 3) and s1.dtype == torch.int32
    assert s1.device.type == "cpu" and torch.equal(s1, s2)
    assert not torch.equal(s1, model.dropout_seeds(
        torch.Generator().manual_seed(1)))
    params = params_from_jax(tree, model.config, device="cpu")
    with pytest.raises(ValueError, match="dropout_seeds"):
        model.hidden_states(params, torch.tensor(tokens),
                            dropout_seeds=s1[:1])
    with pytest.raises(ValueError, match="remat_policy"):
        GPTConfig(**SMALL, remat_policy="offload")
    with pytest.raises(ValueError, match="dropout"):
        GPTConfig(**SMALL, dropout=1.0)


def test_serve_and_decode_ignore_dropout(setup):
    """The engines never drop (the reference's decode branch takes no
    key): a dropout=0.1 config serves and decodes the same tokens as the
    same weights at 0."""
    small = dict(vocab_size=256, max_seq_len=128, hidden_size=64,
                 num_layers=2, num_heads=4, attention_impl="flash")
    jm = JGPTModel(JGPTConfig(**small, tp_size=1, remat=False))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 30, 17)]
    tokens = {}
    for rate in (0.0, RATE):
        cfg = GPTConfig(**small, dropout=rate)
        model = GPTModel(cfg)
        params = params_from_jax(tree, cfg, device="cpu")
        eng = ServingEngine(model, device="cpu", num_slots=2, block_size=16,
                            prefill_chunk=32, num_blocks=9)
        done = eng.serve(params, [Request(rid=i, prompt=p, max_new_tokens=6)
                                  for i, p in enumerate(prompts)])
        dec = DecodeEngine(model, device="cpu").generate(
            params, torch.tensor(np.stack([prompts[0], prompts[0]])), 5)
        tokens[rate] = ([r.tokens for r in sorted(done, key=lambda r: r.rid)],
                        dec.tolist())
    assert tokens[0.0] == tokens[RATE]
