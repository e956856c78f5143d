"""The slice as a whole: three steps of apex_tpu_torch's BERT ``mlm_loss``
+ ``backward()`` + ``FusedLAMB.step()`` against apex_tpu's ``mlm_loss``
gradients + ``fused_lamb`` + ``optax.apply_updates`` on a tiny BERT (2
layers, hidden 64 as 2 heads of 32, seq 32 with suffix padding), the same
weights (the reference's init through the weight bridge) and batch.

The reference's LAMB runs on the per-layer tree (the port's layout, which
``bert_params_to_jax``'s inverse makes): its models stack their layers,
and on the stacked tree its trust ratios span all layers of a leaf
(test_torch_lamb.py shows the divergence). Each step the reference's
gradients come from its model on the stacked params and are unstacked
for the optimizer. The reference runs on its XLA paths
(``APEX_TPU_PALLAS=0``), the port on its plain versions (CPU tensors);
fp32, full-precision matmuls.

Tolerances: the loss to 1e-5 relative each step (test_torch_bert.py's);
m within 2e-4 of the leaf's largest entry (the gradients' tolerance there:
m is linear in them) and v within 4e-4 (quadratic); params within 1e-6 of
the leaf's largest entry, except where the reference's gradient entry was
below 1e-3 of its leaf's largest in some step (and the k window of the
qkv bias, whose exact gradient is 0): LAMB's ``m_hat / sqrt(v_hat)`` is
±1 for any gradient well above eps, so fp32 noise in a near-zero gradient
decides the direction of that entry's step; those entries within twice
the sum over the steps of the port's largest move on the leaf. The pooler
takes no part in the MLM loss: the reference steps it on a zero gradient
(LAMB's weight decay still moves it), so the port's test gives it a zero
gradient too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from apex_tpu.models.bert import BertConfig as JConfig
from apex_tpu.models.bert import BertModel as JModel
from apex_tpu.optimizers import fused_lamb
from apex_tpu_torch.models.bert import BertConfig, BertModel, param_leaves
from apex_tpu_torch.models.convert import (bert_params_from_jax,
                                           bert_params_to_jax)
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.utils.pytree import tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False

SMALL = dict(vocab_size=128, max_seq_len=32, hidden_size=64, num_layers=2,
             num_heads=2)
B, S = 2, 32
LENS = (32, 19)
LR = 1e-3
LOSS_RTOL, M_TOL, V_TOL, P_TOL, SMALL_GRAD = 1e-5, 2e-4, 4e-4, 1e-6, 1e-3


def _batch(seed=2):
    rng = np.random.default_rng(seed)
    V = SMALL["vocab_size"]
    pos = np.arange(S)[None, :]
    valid = pos < np.asarray(LENS)[:, None]
    split = np.asarray([12, 9])[:, None]
    return (rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, V, (B, S)).astype(np.int32),
            ((rng.random((B, S)) < 0.3) & valid).astype(np.float32),
            ((pos >= split) & valid).astype(np.int32),
            ~valid)


def test_three_bert_lamb_steps_match_reference(monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", "0")
    jm = JModel(JConfig(**SMALL, attention_impl="flash"))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jm.init(jax.random.PRNGKey(0)))
    cfg = BertConfig(**SMALL, attention_impl="flash", remat=True)

    def per_layer(stacked):  # the port's layout, numpy leaves
        return jax.tree.map(lambda t: t.numpy(), bert_params_from_jax(
            jax.tree.map(np.asarray, stacked), cfg, device="cpu"))

    def stack(tree_pl):
        return bert_params_to_jax(jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)), tree_pl), cfg)

    batch = _batch()
    jargs = [jnp.asarray(a) for a in batch]
    grad_fn = jax.jit(jax.value_and_grad(lambda p: jm.mlm_loss(p, *jargs)))
    opt = fused_lamb(learning_rate=LR)
    pl = jax.tree.map(jnp.asarray, per_layer(tree))
    state = opt.init(pl)

    model = BertModel(cfg)
    params = bert_params_from_jax(tree, cfg, device="cpu")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    topt = FusedLAMB(leaves, lr=LR)
    targs = [torch.tensor(a) for a in batch]
    small = [np.zeros(t.shape, bool) for t in leaves]
    moved = [0.0] * len(leaves)
    for step in range(3):
        with jax.default_matmul_precision("highest"):
            loss_j, g_stacked = grad_fn(jax.tree.map(jnp.asarray, stack(pl)))
        g_pl = jax.tree.map(jnp.asarray, per_layer(g_stacked))
        upd, state = opt.update(g_pl, state, pl)
        pl = optax.apply_updates(pl, upd)

        before = [t.detach().clone() for t in leaves]
        loss = model.mlm_loss(params, *targs)
        loss.backward()
        for t in leaves:  # the pooler: the reference's zero gradient
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        topt.step()
        topt.zero_grad()
        np.testing.assert_allclose(loss.item(), float(loss_j),
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
        for i, (g, t, b) in enumerate(zip(jax.tree.leaves(g_pl), leaves,
                                          before)):
            g = np.abs(np.asarray(g))
            small[i] |= g < SMALL_GRAD * max(float(g.max()), 1e-30)
            moved[i] += float((t.detach() - b).abs().max())
    assert int(state.count) == 3
    H = SMALL["hidden_size"]
    k_bias = {id(lay["qkv"]["bias"]) for lay in params["layers"]}
    for i, (t, w) in enumerate(zip(leaves, jax.tree.leaves(pl))):
        got, w = t.detach().numpy(), np.asarray(w)
        diff = np.abs(got - w)
        loose = diff > P_TOL * np.abs(w).max()
        exempt = small[i].copy()
        if id(t) in k_bias:
            exempt[H:2 * H] = True
        assert not (loose & ~exempt).any(), f"param leaf {i}"
        assert (diff <= 2 * moved[i]).all(), f"param leaf {i}"
    for name, key, tol in (("exp_avg", "m", M_TOL),
                           ("exp_avg_sq", "v", V_TOL)):
        for i, (t, w) in enumerate(zip(leaves, jax.tree.leaves(
                state.buffers[key]))):
            w = np.asarray(w)
            np.testing.assert_allclose(
                topt.state[t][name].numpy(), w, rtol=0,
                atol=tol * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{name} leaf {i}")
    assert len(tree_leaves(params)) == len(jax.tree.leaves(pl))
