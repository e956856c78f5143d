"""Port parity for the whole train step: apex_tpu_torch's GPT ``loss_fn``,
its gradients and three FusedAdam steps against apex_tpu's, on the same
weights (the reference's own init, through the weight bridge) and the
same seeded tokens.

The reference runs once with its Pallas kernels in interpret mode
(``APEX_TPU_PALLAS=interpret``: packed flash forward/backward, xent
statistics, the Pallas layer norm) and once on its XLA paths
(``APEX_TPU_PALLAS=0``); the port runs its plain versions (CPU tensors).
fp32, full-precision matmuls on both sides (TF32 off here,
``jax.default_matmul_precision("highest")`` there). Tolerances: the loss
to 1e-5 relative; every gradient leaf to 2e-4 relative of its largest
entry (fp32 sums in another order through attention, layer norm and the
tied head); after 3 Adam steps m/v to 1e-4 relative of the leaf's largest
entry, and params to 1e-6 of it in all but 1 entry in 10^4 of each leaf,
those within 3·lr. Adam divides by sqrt(v): where a gradient entry is
near zero, an fp32 difference in it moves that entry's lr-sized update by
a visible fraction (3 mlp_down entries of 524288 moved by up to 3.5e-6 at
lr 1e-4); 3·lr is the most three steps can move an entry apart. The k
window of the qkv bias gets only that bound: its exact gradient is 0 (it
adds one constant to every score of a row, which the softmax ignores), so
both sides step on fp32 rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.ops.layer_norm import fused_layer_norm as j_layer_norm
from apex_tpu.optimizers import fused_adam
from apex_tpu_torch.models.convert import params_from_jax, params_to_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, param_leaves
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.optimizers import FusedAdam

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = dict(vocab_size=512, max_seq_len=128, hidden_size=256, num_layers=2,
             num_heads=2)
B = 2
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    jm = JGPTModel(JGPTConfig(**SMALL, tp_size=1, remat=False,
                              attention_impl="flash"))
    jp = jm.init(jax.random.PRNGKey(0))
    # non-zero biases and LN affines, so every leaf's gradient path matters
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, SMALL["vocab_size"], (B, SMALL["max_seq_len"]))
    targets = rng.integers(0, SMALL["vocab_size"], (B, SMALL["max_seq_len"]))
    return jm, tree, tokens.astype(np.int32), targets.astype(np.int32)


def _port(tree, **cfg_kw):
    cfg = GPTConfig(**SMALL, attention_impl="flash", **cfg_kw)
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
        g = flat_g[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * scale,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _reference_value_and_grad(jm, tree, tokens, targets, loss_mask=None):
    jp = jax.tree.map(jnp.asarray, tree)
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(
            lambda p: jm.loss_fn(p, jnp.asarray(tokens), jnp.asarray(targets),
                                 loss_mask=loss_mask))(jp)
    return float(loss), grads


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_loss_and_every_gradient_match_reference(setup, pallas, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    jm, tree, tokens, targets = setup
    loss_j, grads_j = _reference_value_and_grad(jm, tree, tokens, targets)
    model, cfg, params = _port(tree, remat=False)
    loss = model.loss_fn(params, torch.tensor(tokens), torch.tensor(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=LOSS_RTOL)
    _assert_trees_close(params_to_jax(_grads(params), cfg), grads_j,
                        GRAD_RTOL, "grad")


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_layer_norm_gradient_matches_reference(pallas, monkeypatch):
    """The port's LayerNorm has no kernel: autograd through its fp32
    composition against the reference's hand-written VJP, on the Pallas
    ln_fwd/ln_bwd route (interpret) and the XLA composition (0)."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    rng = np.random.default_rng(4)
    x, dy = (rng.standard_normal((64, 256)).astype(np.float32)
             for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    y_j, vjp = jax.vjp(j_layer_norm, *map(jnp.asarray, (x, w, b)))
    g_j = vjp(jnp.asarray(dy))
    args = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    y = fused_layer_norm(*args)
    y.backward(torch.tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    for name, a, e in zip(("dx", "dw", "db"), args, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_loss_mask_matches_reference(setup, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", "0")
    jm, tree, tokens, targets = setup
    mask = (np.random.default_rng(3).random(tokens.shape) < 0.6).astype(
        np.float32)
    loss_j, grads_j = _reference_value_and_grad(jm, tree, tokens, targets,
                                                jnp.asarray(mask))
    model, cfg, params = _port(tree, remat=False)
    loss = model.loss_fn(params, torch.tensor(tokens), torch.tensor(targets),
                         loss_mask=torch.tensor(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=LOSS_RTOL)
    _assert_trees_close(params_to_jax(_grads(params), cfg), grads_j,
                        GRAD_RTOL, "grad")


def test_remat_gives_the_same_loss_and_gradients(setup):
    _, tree, tokens, targets = setup
    out = []
    for remat in (False, True):
        model, cfg, params = _port(tree, remat=remat)
        loss = model.loss_fn(params, torch.tensor(tokens),
                             torch.tensor(targets))
        loss.backward()
        out.append((loss.detach(), param_leaves(_grads(params))))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_three_train_steps_match_reference(setup, pallas, monkeypatch):
    """bench.py's train step, rebuilt: value_and_grad(loss_fn), one
    fused_adam(1e-4) update, optax.apply_updates — three times, with the
    reference's Pallas kernels in interpret mode and on its XLA paths."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    jm, tree, tokens, targets = setup
    opt = fused_adam(learning_rate=1e-4)

    @jax.jit
    def train_step(params, opt_state, tokens, targets):
        loss, grads = jax.value_and_grad(jm.loss_fn)(params, tokens, targets)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    pj = jax.tree.map(jnp.asarray, tree)
    state = opt.init(pj)
    model, cfg, params = _port(tree, remat=False)
    topt = FusedAdam(param_leaves(params), lr=1e-4)
    tok_t, tgt_t = torch.tensor(tokens), torch.tensor(targets)
    with jax.default_matmul_precision("highest"):
        for step in range(3):
            pj, state, loss_j = train_step(pj, state, jnp.asarray(tokens),
                                           jnp.asarray(targets))
            loss = model.loss_fn(params, tok_t, tgt_t)
            loss.backward()
            topt.step()
            topt.zero_grad()
            np.testing.assert_allclose(loss.item(), float(loss_j),
                                       rtol=LOSS_RTOL, err_msg=f"step {step}")
    assert int(state.count) == 3
    flat_w = jax.tree_util.tree_flatten_with_path(pj)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        params_to_jax(params, cfg))[0])
    h, d = SMALL["num_heads"], SMALL["hidden_size"] // SMALL["num_heads"]
    for path, w in flat_w:
        w = np.asarray(w, np.float32)
        diff = np.abs(flat_g[path] - w)
        loose = diff > 1e-6 * np.abs(w).max()
        if jax.tree_util.keystr(path) == "['layers']['qkv']['bias']":
            loose[:, h * d:2 * h * d] = False  # the k window (MHA)
        where = f"param {jax.tree_util.keystr(path)}"
        assert loose.sum() <= max(1, w.size // 10_000), where
        assert (diff <= 3 * 1e-4).all(), where
    for name, key in (("m", "exp_avg"), ("v", "exp_avg_sq")):
        moments = {id(t): topt.state[t][key] for t in param_leaves(params)}

        def swap(x):
            if isinstance(x, torch.Tensor):
                return moments[id(x)]
            if isinstance(x, dict):
                return {k: swap(v) for k, v in x.items()}
            return [swap(v) for v in x]
        _assert_trees_close(params_to_jax(swap(params), cfg),
                            state.buffers[name], 1e-4, name)


def test_training_knobs_of_later_slices_raise(setup):
    """A dropout rate outside [0, 1) and seeds of the wrong shape raise;
    the reference's knobs that the port does not run yet are not config
    fields at all; ``attention_impl`` (softmax | flash | naive) and
    ``remat_policy`` are, validated as the reference validates them."""
    _, tree, tokens, _ = setup
    cfg = GPTConfig(**SMALL, dropout=0.1)
    params = params_from_jax(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="dropout_seeds"):
        GPTModel(cfg).hidden_states(params, torch.tensor(tokens),
                                    dropout_seeds=torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="dropout"):
        GPTConfig(**SMALL, dropout=1.5)
    with pytest.raises(ValueError, match="attention_impl"):
        GPTConfig(**SMALL, attention_impl="ring")
    with pytest.raises(ValueError, match="remat_policy"):
        GPTConfig(**SMALL, remat_policy="nothing")
    for kw in (dict(scan_layers=False), dict(tp_size=2),
               dict(sequence_parallel=True), dict(cp_axis="cp"),
               dict(moe_num_experts=4)):
        with pytest.raises(TypeError, match=next(iter(kw))):
            GPTConfig(**SMALL, **kw)
