"""Port parity: apex_tpu_torch's FusedLAMB and FusedMixedPrecisionLamb
against apex_tpu's ``fused_lamb`` and ``fused_mixed_precision_lamb`` plus
``optax.apply_updates``, over 3 steps on the same seeded gradients
(``torch_opt_harness``: a tree with per-layer leaves).

fp32: params, m and v to 1e-6 relative (atol 1e-9; v 1e-12), counts
equal — FusedAdam's tolerance in test_torch_optimizers.py — or, where
larger, 1e-6 of the leaf's largest entry: the two sides sum a tensor's
squares in their own orders (the trust ratio's norms, the global clip's),
which moves the last bit of a norm, and a moment entry where ``b1 * m``
and the clipped gradient nearly cancel carries that bit at 1e-5 relative
(measured: 3.7e-9 absolute in entries of 5e-4, without grad averaging).
bf16 params: at most 1 element in 1000 one bf16 ulp off.

MP-LAMB: the reference keeps the chunked layout at chunk 1024 and sums
each tensor's squares chunk by chunk, then over chunks; the port sums per
tensor. Masters, m and v to 1e-6 relative; the bf16 model params by the
bf16 rule.

Also: LAMB's two param groups (weights at wd 0.01, the 1-D tensors at 0)
against two reference runs on the whole tree, one at each decay, each
restricted to its group's leaves (the moments and the global clip do not
depend on wd, so the composition is exact); resuming from
``optimizer_state_from_jax``; the reference's stacked leaves giving
other trust ratios (the recorded divergence); ``adam_w_mode`` and
``layout=`` refused with ``TypeError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_opt_harness as H
from apex_tpu.optimizers import fused_lamb, fused_mixed_precision_lamb
from apex_tpu_torch.models.convert import optimizer_state_from_jax
from apex_tpu_torch.optimizers import FusedLAMB, FusedMixedPrecisionLamb
from apex_tpu_torch.optimizers import multi_tensor as mt
from apex_tpu_torch.utils.pytree import tree_leaves

RTOL, ATOL, V_ATOL = 1e-6, 1e-9, 1e-12
OF_LARGEST = 1e-6  # the norms' summation order (see above)


def _close(got, want, atol=ATOL, what=""):
    H.assert_close_leaves(got, want, RTOL, atol, what, OF_LARGEST)

CASES = {
    "default": dict(lr=1e-3),
    "nvlamb_no_decay": dict(lr=1e-3, weight_decay=0.0, use_nvlamb=True),
    "no_decay": dict(lr=1e-3, weight_decay=0.0),
    "no_bias_correction": dict(lr=2e-3, bias_correction=False),
    "schedule": dict(lr=lambda c: 1e-3 * 0.5 ** c, betas=(0.8, 0.99),
                     eps=1e-8, weight_decay=0.1),
    "no_grad_averaging": dict(lr=1e-3, grad_averaging=False),
    "no_clip": dict(lr=1e-3, max_grad_norm=1e4),
}


def _lamb_run(kw, dtype_j=jnp.float32, dtype_t=torch.float32, steps=3):
    return H.run(fused_lamb(**H.ref_kw(kw)),
                 lambda leaves: FusedLAMB(leaves, **kw), dtype_j, dtype_t,
                 steps)


def _check_state(state, pt, topt):
    leaves = tree_leaves(pt)
    assert int(state.count) == 3
    assert all(topt.state[t]["step"] == 3 for t in leaves)
    _close(H.port_state(topt, leaves, "exp_avg"),
           jax.tree.leaves(state.buffers["m"]), what="m")
    _close(H.port_state(topt, leaves, "exp_avg_sq"),
           jax.tree.leaves(state.buffers["v"]), V_ATOL, "v")


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_lamb_fp32_matches_reference(name):
    pj, state, pt, topt = _lamb_run(CASES[name])
    _close(tree_leaves(pt), jax.tree.leaves(pj), what="p")
    _check_state(state, pt, topt)


@pytest.mark.parametrize("name", ["default", "nvlamb_no_decay"])
def test_fused_lamb_bf16_params_match_reference(name):
    pj, state, pt, topt = _lamb_run(CASES[name], jnp.bfloat16,
                                    torch.bfloat16)
    H.assert_bf16_leaves(tree_leaves(pt), jax.tree.leaves(pj), "p")
    _check_state(state, pt, topt)


def test_fused_lamb_clip_spans_every_group():
    """The gradient norm of the clip is taken over both groups: stepping
    the groups by separate optimizers (each clipping by its own norm)
    gives other moments."""
    p0 = H.init_params()
    pt = H.to_torch(p0, torch.float32, grad=True)
    leaves = tree_leaves(pt)
    big = [t for t in leaves if t.ndim >= 2]
    small = [t for t in leaves if t.ndim < 2]
    opt = FusedLAMB([{"params": big}, {"params": small}], lr=1e-3)
    pt2 = H.to_torch(p0, torch.float32, grad=True)
    leaves2 = tree_leaves(pt2)
    split = [FusedLAMB([t for t in leaves2 if t.ndim >= 2], lr=1e-3),
             FusedLAMB([t for t in leaves2 if t.ndim < 2], lr=1e-3)]
    g = jax.tree.leaves(H.grads(0))
    for ts in (leaves, leaves2):
        for t, a in zip(ts, g):
            t.grad = torch.tensor(a)
    opt.step()
    for o in split:
        o.step()
    m1 = [opt.state[t]["exp_avg"] for t in small]
    m2 = [split[1].state[t]["exp_avg"] for t in leaves2 if t.ndim < 2]
    assert not all(torch.equal(a, b) for a, b in zip(m1, m2))


def test_fused_lamb_two_groups_match_two_reference_runs():
    """NVIDIA's BERT recipe: the weights at weight decay 0.01, the biases
    and norm parameters (1-D) at 0."""
    kw = dict(lr=1e-3)
    ref = {wd: H.run(fused_lamb(**H.ref_kw(kw), weight_decay=wd),
                     lambda leaves: FusedLAMB(leaves, **kw))[:2]
           for wd in (0.01, 0.0)}

    def make(leaves):
        return FusedLAMB(
            [{"params": [t for t in leaves if t.ndim >= 2],
              "weight_decay": 0.01},
             {"params": [t for t in leaves if t.ndim < 2],
              "weight_decay": 0.0}], **kw)

    _, _, pt, topt = H.run(fused_lamb(**H.ref_kw(kw)), make)
    leaves = tree_leaves(pt)
    for i, t in enumerate(leaves):
        pj, state = ref[0.01 if t.ndim >= 2 else 0.0]
        for got, want, atol in (
                (t, jax.tree.leaves(pj)[i], ATOL),
                (topt.state[t]["exp_avg"],
                 jax.tree.leaves(state.buffers["m"])[i], ATOL),
                (topt.state[t]["exp_avg_sq"],
                 jax.tree.leaves(state.buffers["v"])[i], V_ATOL)):
            _close([got], [want], atol, f"leaf {i}")


def test_fused_lamb_stacked_leaves_give_other_trust_ratios():
    """The recorded divergence: the reference's models stack their layers,
    so its LAMB, given a model's own tree, takes one norm over all layers
    of a leaf. On the stacked tree the per-layer leaves step by other
    trust ratios than on the per-layer tree (which the port's models keep
    and the port steps); the other leaves agree."""
    kw = dict(lr=1e-3)
    opt = fused_lamb(**H.ref_kw(kw))
    p0 = H.init_params()
    stacked0 = {k: v for k, v in p0.items() if k != "layers"}
    stacked0["layers"] = {k: np.stack([lay[k] for lay in p0["layers"]])
                          for k in p0["layers"][0]}
    pj, _, pt, _ = H.run(opt, lambda leaves: FusedLAMB(leaves, **kw))
    ps = jax.tree.map(jnp.asarray, stacked0)
    st = opt.init(ps)
    for i in range(3):
        g = H.grads(i)
        gs = {k: v for k, v in g.items() if k != "layers"}
        gs["layers"] = {k: np.stack([lay[k] for lay in g["layers"]])
                        for k in g["layers"][0]}
        upd, st = opt.update(jax.tree.map(jnp.asarray, gs), st, ps)
        ps = optax.apply_updates(ps, upd)
    # the port equals the reference on the per-layer tree ...
    _close(tree_leaves(pt), jax.tree.leaves(pj))
    # ... and the stacked run differs on the per-layer leaves only
    for k in ("w", "b"):
        _close([ps[k]], [pj[k]])
    for k in ("k", "ln"):
        for i, lay in enumerate(pt["layers"]):
            got = H.np32(lay[k])
            want = H.np32(ps["layers"][k][i])
            assert np.abs(got - want).max() > 1e-3 * np.abs(
                got - H.np32(H.init_params()["layers"][i][k])).max(), k


def _mp_run(kw, steps=3):
    return H.run(fused_mixed_precision_lamb(**H.ref_kw(kw)),
                 lambda leaves: FusedMixedPrecisionLamb(leaves, **kw),
                 jnp.bfloat16, torch.bfloat16, steps)


@pytest.mark.parametrize("name", ["default", "nvlamb_no_decay", "schedule"])
def test_mixed_precision_lamb_matches_reference_chunked_state(name):
    pj, state, pt, topt = _mp_run(CASES[name])
    leaves = tree_leaves(pt)
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    H.assert_bf16_leaves(leaves, jax.tree.leaves(pj), "model")
    assert int(state.count) == 3
    layout = mt.make_layout(H.to_torch(H.init_params(), torch.float32))
    assert layout.chunk_size == state.layout.chunk_size == 1024
    for port_name, ref_name, atol in (("master", "master", ATOL),
                                      ("exp_avg", "m", ATOL),
                                      ("exp_avg_sq", "v", V_ATOL)):
        want = tree_leaves(mt.unflatten_from_chunks(
            torch.tensor(np.asarray(getattr(state, ref_name))), layout))
        _close(H.port_state(topt, leaves, port_name), want, atol, port_name)


@pytest.mark.parametrize("mp", [False, True], ids=["lamb", "mp_lamb"])
def test_lamb_resumes_from_reference_state(mp):
    """Two reference steps, the state carried across by
    ``optimizer_state_from_jax``, then a third step on both sides."""
    kw = dict(lr=1e-3)
    dt_j, dt_t = (jnp.bfloat16, torch.bfloat16) if mp else (jnp.float32,
                                                            torch.float32)
    ref = (fused_mixed_precision_lamb if mp else fused_lamb)(**H.ref_kw(kw))
    cls = FusedMixedPrecisionLamb if mp else FusedLAMB
    p0 = H.init_params()
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(dt_j), p0)
    state = ref.init(pj)
    for i in range(2):
        upd, state = ref.update(jax.tree.map(
            lambda a: jnp.asarray(a).astype(dt_j), H.grads(i)), state, pj)
        pj = optax.apply_updates(pj, upd)
    pt = H.to_torch(jax.tree.map(H.np32, pj), dt_t, grad=True)
    leaves = tree_leaves(pt)
    topt = cls(leaves, **kw)
    topt.state.update(optimizer_state_from_jax(
        jax.tree.map(np.asarray, state), topt, pt,
        jax.tree.map(H.np32, pj)))
    g = H.grads(2)
    upd, state = ref.update(jax.tree.map(
        lambda a: jnp.asarray(a).astype(dt_j), g), state, pj)
    pj = optax.apply_updates(pj, upd)
    for t, a in zip(leaves, jax.tree.leaves(g)):
        t.grad = torch.tensor(a).to(dt_t)
    topt.step()
    assert all(topt.state[t]["step"] == 3 for t in leaves)
    if mp:
        H.assert_bf16_leaves(leaves, jax.tree.leaves(pj))
        m = tree_leaves(mt.unflatten_from_chunks(
            torch.tensor(np.asarray(state.m)), mt.make_layout(pt)))
    else:
        _close(leaves, jax.tree.leaves(pj))
        m = jax.tree.leaves(state.buffers["m"])
    _close(H.port_state(topt, leaves, "exp_avg"), m, what="m")


@pytest.mark.parametrize("cls", [FusedLAMB, FusedMixedPrecisionLamb])
@pytest.mark.parametrize("knob", [dict(adam_w_mode=True),
                                  dict(adam_w_mode=False),
                                  dict(layout="chunked"),
                                  dict(chunk_size=1024)],
                         ids=["adam_w_mode", "adam_w_mode_false", "layout",
                              "chunk_size"])
def test_lamb_refuses_reference_only_knobs(cls, knob):
    """``adam_w_mode`` is accepted by the reference and never read (its
    LAMB always decays decoupled); ``layout``/``chunk_size`` select the
    reference's chunked state. None is an argument here."""
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(TypeError, match=next(iter(knob))):
        cls([p], **knob)
