"""Port parity: apex_tpu_torch's FusedSGD, FusedNovoGrad and FusedAdagrad
against apex_tpu's ``fused_sgd``, ``fused_novograd`` and
``fused_adagrad`` plus ``optax.apply_updates`` over 3 steps on the same
seeded gradients (``torch_opt_harness``), the multi-tensor functions
against ``apex_tpu.optimizers.multi_tensor``, and resuming every
per-tensor optimizer from ``optimizer_state_from_jax``.

Tolerances, fp32: params and state to 1e-6 relative (atol 1e-9; squared
moments and sums 1e-12), FusedAdam's in test_torch_optimizers.py. NovoGrad
divides by a per-tensor gradient norm, which the two sides sum in their
own orders: its params and moments also pass within 1e-6 of the leaf's
largest entry, and its norms ``v`` to 1e-6 relative. bf16 params: at most
1 element in 1000 one bf16 ulp off. The multi-tensor functions: the
layout, flatten/unflatten and the max norm exact; sums of squares to 1e-6
relative (their orders differ).

The ``gpu`` cases step each optimizer on the card against the same
optimizer on the CPU, to the CPU parity tests' tolerance (the norms on the
card are ``torch._foreach_norm``'s sums). This file imports JAX only
inside its CPU tests, so the ``gpu`` cases run where JAX is absent::

    python -m pytest --noconftest -m gpu tests/test_torch_optimizers_more.py
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.optimizers import (FusedAdagrad, FusedAdam, FusedLAMB,
                                       FusedMixedPrecisionLamb,
                                       FusedNovoGrad, FusedSGD)
from apex_tpu_torch.parallel import LARC
from apex_tpu_torch.utils.pytree import tree_leaves

RTOL, ATOL, SQ_ATOL = 1e-6, 1e-9, 1e-12
OF_LARGEST = 1e-6  # NovoGrad's norms' summation order (see above)

SGD_CASES = {
    "plain": dict(lr=0.1),
    "momentum": dict(lr=0.1, momentum=0.9),
    "dampening": dict(lr=0.05, momentum=0.9, dampening=0.1,
                      weight_decay=1e-2),
    "nesterov": dict(lr=0.1, momentum=0.9, nesterov=True),
    "grad_scale": dict(lr=0.1, momentum=0.9, grad_scale=128.0),
    "schedule": dict(lr=lambda c: 0.1 * 0.5 ** c, momentum=0.8),
}
NOVO_CASES = {
    "default": dict(lr=1e-2),
    "bias_correction": dict(lr=1e-2, bias_correction=True),
    "init_zero": dict(lr=1e-2, init_zero=True, bias_correction=True),
    "reg_inside_moment": dict(lr=1e-2, reg_inside_moment=True,
                              weight_decay=0.01),
    "decay_outside": dict(lr=1e-2, weight_decay=0.01),
    "norm_type_0": dict(lr=1e-2, norm_type=0),
    "no_grad_averaging": dict(lr=1e-2, grad_averaging=False),
    "schedule": dict(lr=lambda c: 1e-2 * 0.5 ** c, betas=(0.9, 0.99)),
}
ADAGRAD_CASES = {
    "default": dict(),
    "l2": dict(weight_decay=0.1),
    "w_mode": dict(weight_decay=0.1, adagrad_w_mode=True),
    "schedule": dict(lr=lambda c: 1e-2 * 0.5 ** c, eps=1e-8),
}
KINDS = {"sgd": (FusedSGD, "fused_sgd", SGD_CASES),
         "novograd": (FusedNovoGrad, "fused_novograd", NOVO_CASES),
         "adagrad": (FusedAdagrad, "fused_adagrad", ADAGRAD_CASES)}
# port state name -> (reference state field, buffer name, atol)
STATE = {"sgd": {"momentum_buffer": ("buffers", "momentum", ATOL)},
         "novograd": {"exp_avg": ("buffers", "m", ATOL),
                      "exp_avg_sq": ("scalars", "v", ATOL)},
         "adagrad": {"sum": ("buffers", "h", SQ_ATOL)},
         "adam": {"exp_avg": ("buffers", "m", ATOL),
                  "exp_avg_sq": ("buffers", "v", SQ_ATOL)}}


@pytest.fixture
def H():
    import torch_opt_harness

    return torch_opt_harness


def _ref(name):
    import apex_tpu.optimizers as ref

    return getattr(ref, name)


def _check(H, kind, pj, state, pt, topt, of_largest):
    leaves = tree_leaves(pt)
    H.assert_close_leaves(leaves, H.jax.tree.leaves(pj), RTOL, ATOL, "p",
                          of_largest)
    assert all(topt.state[t]["step"] == int(state.count) for t in leaves)
    for name, (field, key, atol) in STATE[kind].items():
        tree = getattr(state, field).get(key)
        if tree is None:  # no momentum: no buffer on either side
            assert all(name not in topt.state[t] for t in leaves)
            continue
        H.assert_close_leaves(H.port_state(topt, leaves, name),
                              H.jax.tree.leaves(tree), RTOL, atol, name,
                              of_largest)


@pytest.mark.parametrize("kind,case", [(k, c) for k, (_, _, cases)
                                       in KINDS.items() for c in cases])
def test_optimizer_fp32_matches_reference(H, kind, case):
    cls, ref, cases = KINDS[kind]
    kw = cases[case]
    pj, state, pt, topt = H.run(_ref(ref)(**H.ref_kw(kw)),
                                lambda leaves: cls(leaves, **kw))
    assert int(state.count) == 3
    _check(H, kind, pj, state, pt, topt,
           OF_LARGEST if kind == "novograd" else 0.0)


@pytest.mark.parametrize("kind,case", [("sgd", "momentum"),
                                       ("sgd", "nesterov"),
                                       ("novograd", "default"),
                                       ("adagrad", "w_mode")])
def test_optimizer_bf16_params_match_reference(H, kind, case):
    cls, ref, cases = KINDS[kind]
    kw = cases[case]
    pj, state, pt, topt = H.run(_ref(ref)(**H.ref_kw(kw)),
                                lambda leaves: cls(leaves, **kw),
                                H.jnp.bfloat16, torch.bfloat16)
    H.assert_bf16_leaves(tree_leaves(pt), H.jax.tree.leaves(pj), "p")


RESUME = {"adam": (FusedAdam, "fused_adam", dict(lr=1e-3,
                                                  weight_decay=0.01)),
          "sgd": (FusedSGD, "fused_sgd", dict(lr=0.1, momentum=0.9)),
          "novograd": (FusedNovoGrad, "fused_novograd",
                       dict(lr=1e-2, bias_correction=True)),
          "adagrad": (FusedAdagrad, "fused_adagrad", dict())}


def _ref_steps(H, opt, tree, steps, stack=False):
    """``steps`` reference steps from ``tree`` on the harness's
    gradients (stacked like the tree where ``stack``)."""
    jax, jnp = H.jax, H.jnp
    pj = jax.tree.map(jnp.asarray, tree)
    state = opt.init(pj)
    for i in range(steps):
        g = H.grads(i)
        if stack:
            g = _stacked(g)
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = H.optax.apply_updates(pj, upd)
    return pj, state


def _stacked(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: np.stack([lay[k] for lay in tree["layers"]])
                     for k in tree["layers"][0]}
    return out


@pytest.mark.parametrize("kind", sorted(RESUME))
def test_resume_from_reference_state(H, kind):
    """Two reference steps, the state carried across by
    ``optimizer_state_from_jax``, a third step on both sides."""
    from apex_tpu_torch.models.convert import optimizer_state_from_jax

    jax = H.jax
    cls, ref, kw = RESUME[kind]
    opt = _ref(ref)(**H.ref_kw(kw))
    pj, state = _ref_steps(H, opt, H.init_params(), 2)
    pt = H.to_torch(jax.tree.map(H.np32, pj), torch.float32, grad=True)
    leaves = tree_leaves(pt)
    topt = cls(leaves, **kw)
    topt.state.update(optimizer_state_from_jax(
        jax.tree.map(np.asarray, state), topt, pt,
        jax.tree.map(H.np32, pj)))
    g = H.grads(2)
    upd, state = opt.update(jax.tree.map(H.jnp.asarray, g), state, pj)
    pj = H.optax.apply_updates(pj, upd)
    for t, a in zip(leaves, jax.tree.leaves(g)):
        t.grad = torch.tensor(a)
    topt.step()
    _check(H, kind, pj, state, pt, topt,
           OF_LARGEST if kind == "novograd" else 0.0)


def test_resume_from_stacked_reference_state(H):
    """The reference's models stack their layers: from a state over the
    stacked tree, each of the port's layers takes its slice of an
    elementwise buffer (Adam's m and v), and a per-tensor scalar —
    NovoGrad's ``v``, one norm over all layers — is refused."""
    from apex_tpu_torch.models.convert import optimizer_state_from_jax

    jax = H.jax
    p0 = H.init_params()
    opt = _ref("fused_adam")(learning_rate=1e-3)
    pj, state = _ref_steps(H, opt, _stacked(p0), 2, stack=True)
    per_layer = {k: v for k, v in p0.items() if k != "layers"}
    pt = H.to_torch(per_layer, torch.float32, grad=True)
    pt["layers"] = [H.to_torch({k: v[i] for k, v in
                                jax.tree.map(H.np32, pj["layers"]).items()},
                               torch.float32, grad=True) for i in range(2)]
    topt = FusedAdam(tree_leaves(pt), lr=1e-3)
    st = optimizer_state_from_jax(jax.tree.map(np.asarray, state), topt, pt,
                                  jax.tree.map(H.np32, pj))
    for i, lay in enumerate(pt["layers"]):
        for k, t in lay.items():
            np.testing.assert_array_equal(
                st[t]["exp_avg"].numpy(),
                np.asarray(state.buffers["m"]["layers"][k][i]))
            assert st[t]["step"] == 2
    nopt = _ref("fused_novograd")(learning_rate=1e-2)
    _, nstate = _ref_steps(H, nopt, _stacked(p0), 1, stack=True)
    with pytest.raises(ValueError, match="per-tensor scalar"):
        optimizer_state_from_jax(jax.tree.map(np.asarray, nstate),
                                 FusedNovoGrad(tree_leaves(pt)), pt,
                                 _stacked(p0))


# --- the multi-tensor functions ----------------------------------------------

MT_SHAPES = {"a": (5, 7), "b": (0,), "c": [(2048,), (3, 1025)], "d": (1,)}


def _mt_tree(seed=3):
    rng = np.random.default_rng(seed)

    def build(s):
        if isinstance(s, list):
            return [build(x) for x in s]
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return build(MT_SHAPES)


def test_multi_tensor_layout_and_round_trip(H):
    """A zero-size tensor still owns one chunk; flatten/unflatten round
    trips, ``like`` casts each leaf; ``chunk_to_tensor`` is the
    reference's."""
    from apex_tpu_torch.optimizers import multi_tensor as mt

    jmt = _ref("multi_tensor")
    tree = _mt_tree()
    tt = H.to_torch(tree, torch.float32)
    layout = mt.make_layout(tt)
    jlayout = jmt.make_layout(H.jax.tree.map(H.jnp.asarray, tree))
    np.testing.assert_array_equal(layout.chunk_to_tensor.numpy(),
                                  np.asarray(jlayout.chunk_to_tensor))
    assert layout.chunk_to_tensor.device == tt["a"].device
    assert layout.sizes == jlayout.sizes
    # b (0 elements) owns one chunk
    assert int((layout.chunk_to_tensor == 1).sum()) == 1
    buf, _ = mt.flatten_to_chunks(tt, layout)
    jbuf, _ = jmt.flatten_to_chunks(H.jax.tree.map(H.jnp.asarray, tree),
                                    jlayout)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    like = H.to_torch(tree, torch.bfloat16)
    back = mt.unflatten_from_chunks(buf, layout, like=like)
    for got, want in zip(tree_leaves(back), tree_leaves(tt)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)
    assert isinstance(back["c"], list) and back["b"].shape == (0,)


def test_multi_tensor_reductions_match_reference(H):
    from apex_tpu_torch.optimizers import multi_tensor as mt

    jmt = _ref("multi_tensor")
    tree = _mt_tree()
    jtree = H.jax.tree.map(H.jnp.asarray, tree)
    buf, layout = mt.flatten_to_chunks(H.to_torch(tree, torch.float32))
    jbuf, jlayout = jmt.flatten_to_chunks(jtree)
    np.testing.assert_allclose(mt.per_tensor_sqnorm(buf, layout).numpy(),
                               np.asarray(jmt.per_tensor_sqnorm(jbuf,
                                                                jlayout)),
                               rtol=RTOL)
    np.testing.assert_array_equal(
        mt.per_tensor_maxnorm(buf, layout).numpy(),
        np.asarray(jmt.per_tensor_maxnorm(jbuf, jlayout)))
    vals = torch.arange(layout.n_tensors, dtype=torch.float32)
    np.testing.assert_array_equal(
        mt.broadcast_per_tensor(vals, layout).numpy(),
        np.asarray(jmt.broadcast_per_tensor(H.jnp.asarray(vals.numpy()),
                                            jlayout)))
    np.testing.assert_allclose(float(mt.global_norm(buf)),
                               float(jmt.global_norm(jbuf)), rtol=RTOL)
    total, per = mt.multi_tensor_l2norm(H.to_torch(tree, torch.float32),
                                        per_tensor=True)
    jtotal, jper = jmt.multi_tensor_l2norm(jtree, per_tensor=True)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=RTOL)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=RTOL)
    assert float(per[1]) == 0.0  # the zero-size leaf


@pytest.mark.parametrize("poison", [False, True])
def test_multi_tensor_scale_and_axpby_match_reference(H, poison):
    from apex_tpu_torch.optimizers import multi_tensor as mt

    jmt = _ref("multi_tensor")
    x, y = _mt_tree(3), _mt_tree(4)
    if poison:
        x["c"][1][1, 7] = np.inf
    tx, ty = H.to_torch(x, torch.bfloat16), H.to_torch(y, torch.float32)
    jx = H.jax.tree.map(lambda a: H.jnp.asarray(a).astype(H.jnp.bfloat16), x)
    jy = H.jax.tree.map(H.jnp.asarray, y)
    got, fin = mt.multi_tensor_scale(tx, 0.5)
    want, jfin = jmt.multi_tensor_scale(jx, 0.5)
    assert bool(fin) == bool(jfin) == (not poison)
    H.assert_close_leaves(tree_leaves(got), H.jax.tree.leaves(want), 0, 0)
    got, fin = mt.multi_tensor_axpby(tx, ty, 2.0, -0.5)
    want, jfin = jmt.multi_tensor_axpby(jx, jy, 2.0, -0.5)
    assert bool(fin) == bool(jfin) == (not poison)
    H.assert_close_leaves(tree_leaves(got), H.jax.tree.leaves(want), 0, 0)


# --- refused knobs -----------------------------------------------------------

@pytest.mark.parametrize("cls", [FusedAdam, FusedSGD, FusedNovoGrad,
                                 FusedAdagrad, FusedLAMB,
                                 FusedMixedPrecisionLamb])
@pytest.mark.parametrize("knob", ["layout", "chunk_size"])
def test_every_optimizer_refuses_the_chunked_layout(cls, knob):
    """The reference's ``layout``/``chunk_size`` select its chunked state;
    every port optimizer keeps its state per tensor."""
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(TypeError, match=knob):
        cls([p], **{knob: "chunked" if knob == "layout" else 1024})


@pytest.mark.parametrize("kw", [dict(nesterov=True),
                                dict(nesterov=True, momentum=0.9,
                                     dampening=0.1)],
                         ids=["no_momentum", "dampening"])
def test_sgd_nesterov_needs_momentum_and_no_dampening(kw):
    with pytest.raises(ValueError, match="nesterov"):
        FusedSGD([torch.zeros(3, requires_grad=True)], lr=0.1, **kw)


def test_novograd_norm_type_is_0_or_2():
    with pytest.raises(ValueError, match="norm_type"):
        FusedNovoGrad([torch.zeros(3, requires_grad=True)], norm_type=1)


@pytest.mark.parametrize("cls", [FusedAdam, FusedLAMB, FusedSGD])
def test_fp32_gradient_copies_live_one_group_at_a_time(cls, monkeypatch):
    """The base reads every group's gradients once for ``_global_stats``
    (LAMB's clip), then makes each group's fp32 copies only as that group
    steps: two groups' copies are never alive together."""
    from apex_tpu_torch.optimizers import _fused

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(_fused, "fp32_copies",
                        spy("copy", _fused.fp32_copies))
    monkeypatch.setattr(cls, "_global_stats",
                        spy("stats", cls._global_stats))
    monkeypatch.setattr(cls, "_update", spy("update", cls._update))
    groups = [[torch.ones(4, requires_grad=True)] for _ in range(2)]
    for (p,) in groups:
        p.grad = torch.full((4,), 0.5)
    kw = dict(momentum=0.9, lr=0.1) if cls is FusedSGD else {}
    cls([{"params": ps} for ps in groups], **kw).step()
    assert calls == ["stats", "copy", "update", "copy", "update"]


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: steps the optimizers on the card")
    return torch.device("cuda")


def _larc_sgd(ps, **kw):
    return LARC(FusedSGD(ps, lr=0.1, momentum=0.9, weight_decay=1e-3),
                trust_coefficient=0.02, clip=True)


ON_CARD = {
    "adam": (lambda ps: FusedAdam(ps, lr=1e-3, weight_decay=0.01), 0.0),
    "lamb": (lambda ps: FusedLAMB(ps, lr=1e-3), OF_LARGEST),
    "lamb_two_groups": (lambda ps: FusedLAMB(
        [{"params": [p for p in ps if p.ndim >= 2]},
         {"params": [p for p in ps if p.ndim < 2], "weight_decay": 0.0}],
        lr=1e-3), OF_LARGEST),
    "mp_lamb": (lambda ps: FusedMixedPrecisionLamb(ps, lr=1e-3),
                OF_LARGEST),
    "sgd_momentum": (lambda ps: FusedSGD(ps, lr=0.1, momentum=0.9), 0.0),
    "sgd_nesterov": (lambda ps: FusedSGD(ps, lr=0.1, momentum=0.9,
                                         nesterov=True), 0.0),
    "novograd_l2": (lambda ps: FusedNovoGrad(ps, lr=1e-2,
                                             bias_correction=True),
                    OF_LARGEST),
    "novograd_inf": (lambda ps: FusedNovoGrad(ps, lr=1e-2, norm_type=0),
                     OF_LARGEST),
    "adagrad": (lambda ps: FusedAdagrad(ps, weight_decay=0.1), 0.0),
    "larc_sgd": (_larc_sgd, OF_LARGEST),
}


def _card_tree(dev, dtype):
    rng = np.random.default_rng(5)
    shapes = [(96, 80), (80,), (48, 32), (32,), (48, 32), (32,), (0,)]
    return [torch.tensor((rng.standard_normal(s) * 0.05).astype(np.float32)
                         ).to(device=dev, dtype=dtype).requires_grad_()
            for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(ON_CARD))
def test_optimizer_on_card_matches_cpu(cuda, name, dtype):
    make, of_largest = ON_CARD[name]
    if name == "mp_lamb" and dtype == torch.float32:
        dtype = torch.bfloat16
    sides = {}
    for dev in ("cpu", cuda):
        ps = _card_tree(dev, dtype)
        opt = make(ps)
        rng = np.random.default_rng(0)
        for _ in range(3):
            for p in ps:
                p.grad = torch.tensor(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32)).to(dev, dtype)
            opt.step()
        inner = getattr(opt, "optim", opt)
        sides[str(dev)] = (ps, inner)
    (pc, oc), (pg, og) = sides["cpu"], sides[str(cuda)]
    for a, b in zip(pg, pc):
        a, b = a.detach().float().cpu().numpy(), b.detach().float().numpy()
        if dtype == torch.bfloat16:  # the bf16 rule
            diff = a != b
            assert diff.sum() <= max(1, a.size // 1000)
            assert (np.abs(a - b)[diff] <= np.abs(b[diff]) * 2.0 ** -7).all()
        else:
            big = float(np.abs(b).max()) if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=RTOL,
                                       atol=max(ATOL, of_largest * big))
    for a, b in zip(pg, pc):
        sa, sb = og.state[a], oc.state[b]
        assert sa.keys() == sb.keys() and sa["step"] == sb["step"] == 3
        for k in sa:
            if isinstance(sa[k], torch.Tensor):
                x, y = sa[k].float().cpu().numpy(), sb[k].float().numpy()
                big = float(np.abs(y).max()) if y.size else 0.0
                np.testing.assert_allclose(
                    x, y, rtol=RTOL, atol=max(ATOL, of_largest * big),
                    err_msg=k)
