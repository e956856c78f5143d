"""Port parity for the fused MLP: apex_tpu_torch's ``mlp`` and ``MLP``
against apex_tpu's on the same seeded inputs, on both routes — with
autograd recording (the reference's ``_mlp_fwd``/``_mlp_bwd``) and
without (its ``_mlp_core`` primal, the activation in the kernel's
epilogue).

The reference runs with ``impl="pallas"`` (its ``matmul_bias_act`` in
interpret mode; 128-multiple widths) and, at DLRM's top-MLP widths scaled
down by 8 (480-1024-1024-512-256-1 → 60-128-128-64-32-1, unaligned), with
``impl="xla"``; the port runs its plain versions (CPU tensors). Module
params come from the reference's ``init`` (biases made nonzero) through
``models/convert.py::mlp_from_jax``. fp32 on both sides. Tolerances:
outputs within 1e-5 relative and absolute; gradients within 2e-4 of the
leaf's largest entry (fp32 sums in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.models.convert import mlp_from_jax
from apex_tpu_torch.ops.mlp import MLP, mlp

# apex_tpu.ops re-exports the function under its module's name
jmlp = importlib.import_module("apex_tpu.ops.mlp")

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4
DLRM_SCALED = (60, 128, 128, 64, 32, 1)


def _close_grad(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_RTOL * scale, err_msg=what)


def _params(rng, sizes):
    """The reference MLP's ``init`` tree, biases made nonzero (numpy)."""
    tree = {k: np.asarray(v) for k, v in jmlp.MLP(sizes).init(
        jax.random.PRNGKey(len(sizes))).items()}
    for k in tree:
        if k.startswith("bias"):
            tree[k] = (0.1 * rng.standard_normal(tree[k].shape)
                       ).astype(np.float32)
    return tree


def _reference(sizes, activation, impl, tree, x, dy):
    """The reference's output on the no-grad route (jitted primal), and
    its output and cotangents (x, then the params) on the grad route."""
    jm = jmlp.MLP(sizes, activation=activation, impl=impl)
    p = {k: jnp.asarray(v) for k, v in tree.items()}
    y_nograd = jax.jit(jm)(p, jnp.asarray(x))

    def run(pp, xx):
        y, vjp = jax.vjp(jm, pp, xx)
        return y, vjp(jnp.asarray(dy))

    y, (g_p, g_x) = jax.jit(run)(p, jnp.asarray(x))
    return np.asarray(y_nograd), np.asarray(y), g_x, g_p


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("api", ["function", "module"])
def test_mlp_matches_reference_on_both_routes(activation, api):
    sizes = (128, 256, 128)
    rng = np.random.default_rng(11)
    tree = _params(rng, sizes)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    dy = rng.standard_normal((2, 8, 128)).astype(np.float32)
    y_ng, y_j, gx_j, gp_j = _reference(sizes, activation, "pallas", tree,
                                       x, dy)
    n = len(sizes) - 1
    if api == "module":
        m = mlp_from_jax(tree, MLP(sizes, activation=activation,
                                   device="cpu"))
        leaves = {k: getattr(m, k) for k in tree}
        fn = m
    else:
        leaves = {k: torch.tensor(v, requires_grad=True)
                  for k, v in tree.items()}
        fn = lambda xx: mlp(  # noqa: E731
            xx, [leaves[f"weight_{i}"] for i in range(n)],
            [leaves[f"bias_{i}"] for i in range(n)], activation)
    xt = torch.tensor(x, requires_grad=True)
    with torch.no_grad():
        np.testing.assert_allclose(fn(xt).numpy(), y_ng, **OUT_TOL)
    y = fn(xt)
    y.backward(torch.tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), y_j, **OUT_TOL)
    _close_grad(xt.grad.numpy(), gx_j, "dx")
    for k, t in leaves.items():
        _close_grad(t.grad.numpy(), gp_j[k], k)


@pytest.mark.parametrize("activation", ["relu", "sigmoid"])
def test_mlp_dlrm_widths_scaled_down_match_reference_xla(activation):
    """Unaligned widths (60 in, 1 out) on the reference's XLA route."""
    rng = np.random.default_rng(12)
    tree = _params(rng, DLRM_SCALED)
    x = rng.standard_normal((64, 60)).astype(np.float32)
    dy = rng.standard_normal((64, 1)).astype(np.float32)
    y_ng, y_j, gx_j, gp_j = _reference(DLRM_SCALED, activation, "xla",
                                       tree, x, dy)
    m = mlp_from_jax(tree, MLP(DLRM_SCALED, activation=activation,
                               device="cpu"))
    xt = torch.tensor(x, requires_grad=True)
    with torch.no_grad():
        np.testing.assert_allclose(m(xt).numpy(), y_ng, **OUT_TOL)
    y = m(xt)
    y.backward(torch.tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), y_j, **OUT_TOL)
    _close_grad(xt.grad.numpy(), gx_j, "dx")
    for k in tree:
        _close_grad(getattr(m, k).grad.numpy(), gp_j[k], k)


def test_mlp_module_layout_and_init():
    m = MLP(DLRM_SCALED, device="cpu",
            generator=torch.Generator().manual_seed(0))
    names = [f"{k}_{i}" for i in range(5) for k in ("weight", "bias")]
    assert sorted(dict(m.named_parameters())) == sorted(names)
    for i, (din, dout) in enumerate(zip(DLRM_SCALED[:-1], DLRM_SCALED[1:])):
        w = getattr(m, f"weight_{i}")
        assert w.shape == (dout, din) and w.abs().max() <= din ** -0.5
        assert not getattr(m, f"bias_{i}").any()
    assert m.num_layers == 5 and m.activation == "relu"


def test_errors_match_the_reference():
    with pytest.raises(NotImplementedError):
        jmlp.MLP((8, 4), bias=False)
    with pytest.raises(NotImplementedError):
        MLP((8, 4), bias=False, device="cpu")
    with pytest.raises(ValueError):
        jmlp.MLP((8,))
    with pytest.raises(ValueError):
        MLP((8,), device="cpu")
    x = np.ones((2, 8), np.float32)
    w, b = np.ones((4, 8), np.float32), np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="none|relu|sigmoid"):
        jax.grad(lambda xx: jmlp.mlp(xx, [w], [b], "tanh").sum())(x)
    with pytest.raises(ValueError, match="none|relu|sigmoid"):
        mlp(torch.tensor(x), [torch.tensor(w)], [torch.tensor(b)], "tanh")
    with pytest.raises(ValueError, match="impl"):
        mlp(torch.tensor(x), [torch.tensor(w)], [torch.tensor(b)],
            impl="pallas")
    with pytest.raises(ValueError, match="leaves"):
        mlp_from_jax({"weight_0": w}, MLP((8, 4), device="cpu"))
