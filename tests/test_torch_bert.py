"""Port parity for BERT's padded MLM train step: apex_tpu_torch's
``BertModel`` (hidden states, ``mlm_loss``, every gradient, three
FusedAdam steps) against apex_tpu's ``BertModel(attention_impl="flash")``
on the same weights (the reference's own init, through the weight bridge)
and the same seeded batch: suffix padding, token types, a loss mask.

Two widths: hidden 256 as 2 heads of 128, where the reference's flash
route takes its seq-major (bshd) kernels, and 4 heads of 64, where it
takes its bh-flat route (a TPU lane rule); the port takes the seq-major
route at both. The reference runs once with its Pallas kernels in
interpret mode (``APEX_TPU_PALLAS=interpret``) and once on its XLA paths
(``=0``); the port runs its plain versions (CPU tensors). fp32,
full-precision matmuls on both sides. Tolerances: hidden states within
1e-5 (relative and absolute), the loss to 1e-5 relative; every gradient
leaf to 2e-4 relative of its largest entry; after 3 Adam steps (lr 1e-4,
the chip's BERT step's) m and v to 1e-4 of the leaf's largest entry and
params to 1e-6 of it, except where the reference's gradient entry was
below 1e-3 of its leaf's largest in some step, and those within 3·lr
(test_torch_t5.py states the cause: Adam divides by sqrt(v), so a
near-zero gradient takes an lr-sized step whose size fp32 noise decides;
measured here, every such entry's gradient was below 2e-5 of its leaf's
largest). The k window of the qkv bias gets only the 3·lr bound: its
exact gradient is 0 (one constant added to every score of a row), so
both sides step on fp32 rounding noise (test_torch_train.py). The pooler
takes no part in the MLM loss: its reference gradient is zero, the port
leaves it None.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.models.bert import BertConfig as JConfig
from apex_tpu.models.bert import BertModel as JModel
from apex_tpu.optimizers import fused_adam
from apex_tpu_torch.models.bert import BertConfig, BertModel, param_leaves
from apex_tpu_torch.models.convert import (bert_params_from_jax,
                                           bert_params_to_jax)
from apex_tpu_torch.optimizers import FusedAdam

torch.backends.cuda.matmul.allow_tf32 = False

WIDTHS = {"bshd": dict(hidden_size=256, num_heads=2),
          "flat": dict(hidden_size=256, num_heads=4)}
SMALL = dict(vocab_size=512, max_seq_len=128, num_layers=2)
B, S = 2, 128
LENS = (128, 77)
H_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


def _tree(width, seed=0, **kw):
    jm = JModel(JConfig(**SMALL, **WIDTHS[width], attention_impl="flash",
                        **kw))
    jp = jm.init(jax.random.PRNGKey(seed))
    # non-unit LN affines and nonzero biases so every leaf's path matters
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    return jm, tree


def _batch(seed=2):
    """tokens, targets, loss mask (30% of the valid positions), token
    types (A then B, split inside each row; padding type 0) and the
    suffix pad mask (True = padding)."""
    rng = np.random.default_rng(seed)
    V = SMALL["vocab_size"]
    pos = np.arange(S)[None, :]
    lens = np.asarray(LENS)[:, None]
    valid = pos < lens
    split = np.asarray([40, 30])[:, None]
    return (rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, V, (B, S)).astype(np.int32),
            ((rng.random((B, S)) < 0.3) & valid).astype(np.float32),
            ((pos >= split) & valid).astype(np.int32),
            ~valid)


def _port(tree, width, remat=True):
    cfg = BertConfig(**SMALL, **WIDTHS[width], remat=remat,
                     attention_impl="flash")
    params = bert_params_from_jax(tree, cfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_()
    return BertModel(cfg), cfg, params


def _grads(params):
    def walk(x):
        if isinstance(x, torch.Tensor):
            return torch.zeros_like(x) if x.grad is None else x.grad
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


def _torch(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("pallas", ["interpret", "0"])
@pytest.mark.parametrize("width", ["bshd", "flat"])
def test_hidden_states_loss_and_every_gradient_match_reference(
        pallas, width, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    jm, tree = _tree(width)
    tok, tgt, lmask, types, pad = _batch()
    jp = jax.tree.map(jnp.asarray, tree)
    jargs = [jnp.asarray(a) for a in (tok, tgt, lmask, types, pad)]
    with jax.default_matmul_precision("highest"):
        hid_j = jm.hidden_states(jp, jargs[0], jargs[3], jargs[4])
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p: jm.mlm_loss(p, *jargs)))(jp)
    model, cfg, params = _port(tree, width)
    targs = _torch(tok, tgt, lmask, types, pad)
    with torch.no_grad():
        hid = model.hidden_states(params, targs[0], targs[3], targs[4])
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j), **H_TOL)
    loss = model.mlm_loss(params, *targs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    _assert_trees_close(bert_params_to_jax(_grads(params), cfg), grads_j,
                        GRAD_RTOL, "grad")
    assert params["pooler_w"].grad is None  # not on the MLM loss's path


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_flash_route_matches_reference_softmax_route(pallas, monkeypatch):
    """The reference's materialised-scores route (``attention_impl=
    "softmax"``, the fused scaled-masked softmax) on the valid positions:
    suffix padding masks the same keys either way."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    _, tree = _tree("bshd")
    jm = JModel(JConfig(**SMALL, **WIDTHS["bshd"], attention_impl="softmax"))
    tok, tgt, lmask, types, pad = _batch()
    jp = jax.tree.map(jnp.asarray, tree)
    jargs = [jnp.asarray(a) for a in (tok, tgt, lmask, types, pad)]
    with jax.default_matmul_precision("highest"):
        hid_j = np.asarray(jm.hidden_states(jp, jargs[0], jargs[3],
                                            jargs[4]))
        loss_j = float(jm.mlm_loss(jp, *jargs))
    model, _, params = _port(tree, "bshd")
    targs = _torch(tok, tgt, lmask, types, pad)
    with torch.no_grad():
        hid = model.hidden_states(params, targs[0], targs[3],
                                  targs[4]).numpy()
        loss = model.mlm_loss(params, *targs).item()
    valid = ~pad
    np.testing.assert_allclose(hid[valid], hid_j[valid], **H_TOL)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_RTOL)


def test_remat_and_pooler_match_reference():
    """Per-block recompute gives the same loss, and gradients within 1e-6
    of each leaf's largest entry (the recomputed graph accumulates some
    sums in another order); the pooler equals the reference's on the same
    hidden states."""
    jm, tree = _tree("bshd")
    tok, tgt, lmask, types, pad = _batch()
    targs = _torch(tok, tgt, lmask, types, pad)
    out = []
    for remat in (False, True):
        model, _, params = _port(tree, "bshd", remat=remat)
        loss = model.mlm_loss(params, *targs)
        loss.backward()
        out.append((loss.detach(), [t.grad for t in param_leaves(params)
                                    if t.grad is not None]))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * b.abs().max().item())
    with torch.no_grad():
        hid = model.hidden_states(params, targs[0], targs[3], targs[4])
        pooled = model.pooled(params, hid)
    want = jm.pooled(jax.tree.map(jnp.asarray, tree), jnp.asarray(hid))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want), **H_TOL)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_three_train_steps_match_reference(pallas, monkeypatch):
    """value_and_grad(mlm_loss), one fused_adam(1e-4) update and
    optax.apply_updates, three times, against mlm_loss, backward() and
    FusedAdam.step()."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    jm, tree = _tree("bshd")
    tok, tgt, lmask, types, pad = _batch()
    jargs = [jnp.asarray(a) for a in (tok, tgt, lmask, types, pad)]
    lr = 1e-4
    opt = fused_adam(learning_rate=lr)

    @jax.jit
    def train_step(params, opt_state):
        loss, grads = jax.value_and_grad(jm.mlm_loss)(params, *jargs)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    def rel_size(g):  # |g| over the leaf's largest |g|
        g = np.abs(np.asarray(g, np.float32))
        return g / max(float(g.max()), 1e-30)

    pj = jax.tree.map(jnp.asarray, tree)
    state = opt.init(pj)
    model, cfg, params = _port(tree, "bshd")
    topt = FusedAdam(param_leaves(params), lr=lr)
    targs = _torch(tok, tgt, lmask, types, pad)
    with jax.default_matmul_precision("highest"):
        for step in range(3):
            pj, state, loss_j, grads_j = train_step(pj, state)
            sizes = jax.tree.map(rel_size, grads_j)
            small = sizes if step == 0 else jax.tree.map(
                np.minimum, small, sizes)
            loss = model.mlm_loss(params, *targs)
            loss.backward()
            topt.step()
            topt.zero_grad()
            np.testing.assert_allclose(loss.item(), float(loss_j),
                                       rtol=LOSS_RTOL, err_msg=f"step {step}")
    assert int(state.count) == 3
    flat_w = jax.tree_util.tree_flatten_with_path(pj)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        bert_params_to_jax(params, cfg))[0])
    flat_small = dict(jax.tree_util.tree_flatten_with_path(small)[0])
    H = WIDTHS["bshd"]["hidden_size"]
    for path, w in flat_w:
        w = np.asarray(w, np.float32)
        diff = np.abs(flat_g[path] - w)
        where = f"param {jax.tree_util.keystr(path)}"
        loose = diff > 1e-6 * np.abs(w).max()
        if jax.tree_util.keystr(path) == "['layers']['qkv']['bias']":
            loose[:, H:2 * H] = False  # the k window
        assert (flat_small[path][loose] < 1e-3).all(), where
        assert (diff <= 3 * lr).all(), where
    for name, key in (("m", "exp_avg"), ("v", "exp_avg_sq")):
        # the pooler never gets a gradient: no state, the reference's zeros
        moments = {id(t): topt.state[t][key] if t in topt.state else
                   torch.zeros_like(t) for t in param_leaves(params)}

        def swap(x):
            if isinstance(x, torch.Tensor):
                return moments[id(x)]
            if isinstance(x, dict):
                return {k: swap(v) for k, v in x.items()}
            return [swap(v) for v in x]
        _assert_trees_close(bert_params_to_jax(swap(params), cfg),
                            state.buffers[name], 1e-4, name)


def test_interior_mask_raises_and_lengths_cut_at_the_first_pad():
    jm, tree = _tree("bshd")
    model, _, params = _port(tree, "bshd")
    tok, _, _, _, pad = _batch()
    bad = pad.copy()
    bad[0, 5] = True  # a masked position followed by valid ones
    with pytest.raises(ValueError, match="suffix padding"):
        model.hidden_states(params, torch.tensor(tok),
                            pad_mask=torch.tensor(bad))
    with pytest.raises(ValueError, match="suffix padding"):
        jm.hidden_states(jax.tree.map(jnp.asarray, tree), jnp.asarray(tok),
                         pad_mask=jnp.asarray(bad))
    lens = model.pad_lengths(torch.tensor(pad).float())
    assert lens.dtype == torch.int32 and lens.tolist() == list(LENS)


def test_weight_bridge_round_trip_and_shape_checks():
    _, tree = _tree("flat")
    cfg = BertConfig(**SMALL, **WIDTHS["flat"])
    params = bert_params_from_jax(tree, cfg, device="cpu")
    assert len(params["layers"]) == SMALL["num_layers"]
    back = dict(jax.tree_util.tree_flatten_with_path(
        bert_params_to_jax(params, cfg))[0])
    for path, w in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(back[path], w)
    with pytest.raises(ValueError, match="embedding.weight"):
        bert_params_from_jax(tree, BertConfig(**dict(SMALL, vocab_size=256),
                                              **WIDTHS["flat"]),
                             device="cpu")
    with pytest.raises(ValueError, match="layers"):
        bert_params_from_jax(tree, BertConfig(**dict(SMALL, num_layers=3),
                                              **WIDTHS["flat"]),
                             device="cpu")
    model = BertModel(cfg)
    own = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(t.shape) for t in param_leaves(own)] == [
        tuple(t.shape) for t in param_leaves(params)]


def test_knobs_of_later_slices_raise():
    """The reference's knobs with one working value in the port are not
    config fields; ``attention_impl`` is one (softmax | flash), validated
    as the reference validates it."""
    for kw in (dict(tp_size=1), dict(tp_axis=None)):
        with pytest.raises(TypeError, match=next(iter(kw))):
            BertConfig(**SMALL, **kw)
    with pytest.raises(ValueError, match="attention_impl"):
        BertConfig(**SMALL, attention_impl="naive")
    with pytest.raises(ValueError, match="divisible"):
        BertConfig(**SMALL, hidden_size=100, num_heads=3)
