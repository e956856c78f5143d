"""Port parity for the fused dense ops: apex_tpu_torch's
``matmul_bias_act``, ``fused_dense``, ``fused_dense_gelu_dense`` and the
``FusedDense`` / ``FusedDenseGeluDense`` modules against apex_tpu's on the
same seeded inputs.

The reference runs its Pallas ``matmul_bias_act`` in interpret mode
(directly with ``interpret=True``, and through ``impl="pallas"``, which
takes 128-multiple widths), and its XLA route (``impl="xla"``) at
unaligned widths; the port runs its plain versions (CPU tensors). Module
params come from the reference's ``init`` through
``models/convert.py``. fp32 on both sides. Tolerances: outputs within
1e-5 relative and absolute (a bf16 ``out_dtype``: one bf16 rounding,
2^-8 of the largest entry); gradients within 2e-4 of the leaf's largest
entry (fp32 sums in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import matmul as jmm
from apex_tpu_torch.models.convert import (dense_from_jax,
                                           dense_gelu_dense_from_jax)
from apex_tpu_torch.ops import matmul as tmm
from apex_tpu_torch.ops.fused_dense import (FusedDense, FusedDenseGeluDense,
                                            fused_dense,
                                            fused_dense_gelu_dense)

# apex_tpu.ops re-exports the functions under their modules' names
jfd = importlib.import_module("apex_tpu.ops.fused_dense")

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4


def _close_grad(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_RTOL * scale, err_msg=what)


def _jax_vjp(fn, args, dy):
    """The reference's output and cotangents, jitted (interpret-mode
    Pallas runs faster traced once than op by op)."""
    def run(*a):
        y, vjp = jax.vjp(fn, *a)
        return y, vjp(jnp.asarray(dy))
    return jax.jit(run)(*jax.tree_util.tree_map(jnp.asarray, args))


def _port_grads(fn, args, dy):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y = fn(*ts)
    y.backward(torch.tensor(dy))
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(y, grads, y_j, g_j, names):
    np.testing.assert_allclose(y, np.asarray(y_j), **OUT_TOL)
    for name, g, gj in zip(names, grads, g_j):
        _close_grad(g, gj, name)


@pytest.mark.parametrize("activation", ["none", "gelu", "relu", "sigmoid"])
@pytest.mark.parametrize("bias", [True, False])
def test_matmul_bias_act_matches_pallas_kernel(activation, bias):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((20, 100)).astype(np.float32) / 10
    w = rng.standard_normal((100, 130)).astype(np.float32)
    b = rng.standard_normal(130).astype(np.float32) if bias else None
    want = jmm.matmul_bias_act(jnp.asarray(x), jnp.asarray(w),
                               None if b is None else jnp.asarray(b),
                               activation=activation, interpret=True)
    got = tmm.matmul_bias_act(torch.tensor(x), torch.tensor(w),
                              None if b is None else torch.tensor(b),
                              activation=activation)
    assert got.shape == (20, 130) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("activation", ["gelu", "sigmoid"])
def test_matmul_bias_act_out_dtype_matches_pallas_kernel(activation):
    """fp32 operands with a bf16 output: one cast of the fp32 epilogue."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((16, 64)).astype(np.float32) / 8
    w = rng.standard_normal((64, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    want = jmm.matmul_bias_act(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), activation=activation,
                               out_dtype=jnp.bfloat16, interpret=True)
    got = tmm.matmul_bias_act(torch.tensor(x), torch.tensor(w),
                              torch.tensor(b), activation=activation,
                              out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


def _dense_args(rng, lead, din, dout, bias):
    x = rng.standard_normal((*lead, din)).astype(np.float32)
    w = (rng.standard_normal((dout, din)) / np.sqrt(din)).astype(np.float32)
    args = [x, w]
    if bias:
        args.append((0.1 * rng.standard_normal(dout)).astype(np.float32))
    return args


@pytest.mark.parametrize("impl,lead,din,dout,bias", [
    pytest.param("pallas", (2, 8), 128, 256, True, id="pallas-bias"),
    pytest.param("pallas", (16,), 128, 128, False, id="pallas-no-bias"),
    pytest.param("xla", (3, 5), 100, 130, True, id="xla-unaligned"),
])
def test_fused_dense_matches_reference(impl, lead, din, dout, bias):
    rng = np.random.default_rng(din + dout)
    args = _dense_args(rng, lead, din, dout, bias)
    dy = rng.standard_normal((*lead, dout)).astype(np.float32)
    y_j, g_j = _jax_vjp(
        lambda x, w, *b: jfd.fused_dense(x, w, *b, impl=impl), args, dy)
    y, grads = _port_grads(lambda x, w, *b: fused_dense(x, w, *b), args, dy)
    assert y.shape == (*lead, dout)
    _check(y, grads, y_j, g_j, ("dx", "dweight", "dbias"))


@pytest.mark.parametrize("impl,lead,dims", [
    pytest.param("pallas", (16,), (128, 256, 128), id="pallas"),
    pytest.param("xla", (2, 7), (60, 200, 72), id="xla-unaligned"),
])
def test_fused_dense_gelu_dense_matches_reference(impl, lead, dims):
    din, dmid, dout = dims
    rng = np.random.default_rng(dmid)
    x, w1, b1 = _dense_args(rng, lead, din, dmid, True)
    _, w2, b2 = _dense_args(rng, lead, dmid, dout, True)
    dy = rng.standard_normal((*lead, dout)).astype(np.float32)
    args = [x, w1, b1, w2, b2]
    y_j, g_j = _jax_vjp(
        lambda *a: jfd.fused_dense_gelu_dense(*a, impl=impl), args, dy)
    y, grads = _port_grads(fused_dense_gelu_dense, args, dy)
    _check(y, grads, y_j, g_j, ("dx", "dw1", "db1", "dw2", "db2"))


@pytest.mark.parametrize("kind", ["dense", "dense-no-bias", "dgd"])
def test_modules_match_reference_through_the_weight_bridge(kind):
    """The reference module's ``init`` params (biases made nonzero) loaded
    with ``dense_from_jax`` / ``dense_gelu_dense_from_jax``; forward and
    every parameter's gradient under the reference's ``impl="pallas"``."""
    rng = np.random.default_rng(3)
    if kind == "dgd":
        jmod = jfd.FusedDenseGeluDense(128, 256, 128, impl="pallas")
        tmod = FusedDenseGeluDense(128, 256, 128, device="cpu")
        load = dense_gelu_dense_from_jax
    else:
        bias = kind == "dense"
        jmod = jfd.FusedDense(128, 256, bias=bias, impl="pallas")
        tmod = FusedDense(128, 256, bias=bias, device="cpu")
        load = dense_from_jax
    tree = {k: np.asarray(v) for k, v in
            jmod.init(jax.random.PRNGKey(0)).items()}
    for k in tree:
        if k.startswith("bias"):
            tree[k] = (0.1 * rng.standard_normal(tree[k].shape)
                       ).astype(np.float32)
    load(tree, tmod)
    names = sorted(tree)
    x = rng.standard_normal((2, 6, 128)).astype(np.float32)
    dy = rng.standard_normal((2, 6, tmod.weight2.shape[0] if kind == "dgd"
                              else 256)).astype(np.float32)
    y_j, g_j = _jax_vjp(lambda p, xx: jmod(p, xx),
                        [{k: tree[k] for k in names}, x], dy)
    xt = torch.tensor(x, requires_grad=True)
    y = tmod(xt)
    y.backward(torch.tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL)
    _close_grad(xt.grad.numpy(), g_j[1], "dx")
    for k in names:
        _close_grad(getattr(tmod, k).grad.numpy(), g_j[0][k], k)


def test_modules_init_like_the_reference():
    """Shapes, names and the uniform bounds of the reference's ``init``;
    the same numbers from one seed on any device."""
    g = torch.Generator().manual_seed(0)
    m = FusedDenseGeluDense(64, 96, 32, device="cpu", generator=g)
    assert dict((k, tuple(v.shape)) for k, v in m.named_parameters()) == {
        "weight1": (96, 64), "bias1": (96,), "weight2": (32, 96),
        "bias2": (32,)}
    assert m.weight1.abs().max() <= 64 ** -0.5
    assert m.weight2.abs().max() <= 96 ** -0.5
    assert not m.bias1.any() and not m.bias2.any()
    d = FusedDense(64, 8, bias=False, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    d2 = FusedDense(64, 8, bias=False, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    assert d.bias is None and torch.equal(d.weight, d2.weight)
    assert d.weight.std() > 0.5 * 64 ** -0.5 / 3 ** 0.5


def test_errors_match_the_reference():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="unknown activation"):
        tmm.matmul_bias_act(x, x.t(), activation="tanh")
    with pytest.raises(ValueError, match="unknown activation"):
        jmm.matmul_bias_act(jnp.zeros((4, 8)), jnp.zeros((8, 4)),
                            activation="tanh", interpret=True)
    # the reference's TPU tiling knobs are not the port's
    for knob in ({"bm": 128}, {"bk": 256}, {"interpret": True}):
        with pytest.raises(TypeError):
            tmm.matmul_bias_act(x, x.t(), **knob)
    with pytest.raises(ValueError, match="impl"):
        fused_dense(x, x, impl="pallas")
    with pytest.raises(ValueError, match="leaves"):
        dense_from_jax({"weight": np.zeros((8, 8), np.float32)},
                       FusedDense(8, 8, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        dense_from_jax({"weight": np.zeros((8, 4), np.float32),
                        "bias": np.zeros(8, np.float32)},
                       FusedDense(8, 8, device="cpu"))
