"""Port parity for the loss ops of ``ops/xentropy.py``:
apex_tpu_torch's ``softmax_cross_entropy_loss``, ``SoftmaxCrossEntropyLoss``
and ``binary_cross_entropy`` against apex_tpu's (its ``custom_vjp`` of
XLA ops; no Pallas kernel) on seeded numpy inputs, the port on its plain
versions (CPU tensors: the forward over ``_torch_xent_stats``, the formula
the card runs over the ``xent_stats`` kernel).

Tolerances: fp32 losses within 1e-5 relative, gradients within 2e-4 of the
leaf's largest entry (sums in another order); a bf16 loss within one bf16
ulp (2^-8 relative: both round an fp32 loss that differs in its last bits);
NaN positions, dtypes and refusals exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as japp
from apex_tpu.ops import xentropy as jx
from apex_tpu_torch import amp
from apex_tpu_torch.contrib import xentropy as contrib_x
from apex_tpu_torch.ops import xentropy as X

LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


def _case(n, V, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((n, V))).astype(dtype)
    lab = rng.integers(0, V, n).astype(np.int32)
    cot = rng.standard_normal(n).astype(np.float32)
    return x, lab, cot


def _ref(x, lab, cot, eps, h2f, jdt=jnp.float32):
    def f(x):
        return jx.softmax_cross_entropy_loss(x, jnp.asarray(lab), eps, h2f)
    loss, vjp = jax.vjp(f, jnp.asarray(x, jdt))
    (g,) = vjp(jnp.asarray(cot, loss.dtype))
    return np.asarray(loss.astype(jnp.float32)), np.asarray(
        g.astype(jnp.float32)), loss.dtype


def _port(x, lab, cot, eps, h2f, dt=torch.float32, fn=None):
    xt = torch.tensor(x).to(dt).requires_grad_()
    fn = fn or X.softmax_cross_entropy_loss
    loss = fn(xt, torch.tensor(lab), eps, h2f)
    loss.backward(torch.tensor(cot).to(loss.dtype))
    return loss.detach().float().numpy(), xt.grad.float().numpy(), loss.dtype


def _grad_close(g, want):
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(7, 48), (2, 3, 40)])
def test_fp32_loss_and_grad_match_reference(eps, shape):
    V = shape[-1]
    x, lab, cot = _case(int(np.prod(shape[:-1])), V, seed=V + int(10 * eps))
    x, lab, cot = (x.reshape(shape), lab.reshape(shape[:-1]),
                   cot.reshape(shape[:-1]))
    loss, g, dt = _port(x, lab, cot, eps, False)
    want, gw, jdt = _ref(x, lab, cot, eps, False)
    assert dt == torch.float32 and jdt == jnp.float32
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)
    _grad_close(g, gw)


@pytest.mark.parametrize("h2f", [False, True])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_half_to_float(h2f, eps):
    """bf16 logits: the loss is fp32 with half_to_float, else bf16; the
    gradient is bf16 either way."""
    x, lab, cot = _case(6, 64, seed=3)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    loss, g, dt = _port(xb, lab, cot, eps, h2f, dt=torch.bfloat16)
    want, gw, jdt = _ref(xb, lab, cot, eps, h2f, jdt=jnp.bfloat16)
    assert dt == (torch.float32 if h2f else torch.bfloat16)
    assert str(jdt) == ("float32" if h2f else "bfloat16")
    np.testing.assert_allclose(loss, want,
                               rtol=LOSS_RTOL if h2f else 2.0 ** -8)
    np.testing.assert_allclose(g, gw, rtol=0,
                               atol=2.0 ** -8 * np.abs(gw).max())


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_out_of_range_labels_match_reference(eps):
    """A label >= V or < -V gives a NaN loss, one in [-V, 0) wraps to V +
    label in the forward; the backward's one-hot is zero for all three
    (the reference's forward/backward mismatch at negative labels, kept:
    ROADMAP queue 3)."""
    V = 16
    x, _, cot = _case(5, V, seed=11)
    lab = np.asarray([V, -1, -V - 1, 3, -V], np.int32)
    loss, g, _ = _port(x, lab, cot, eps, False)
    want, gw, _ = _ref(x, lab, cot, eps, False)
    np.testing.assert_array_equal(np.isnan(loss), np.isnan(want))
    assert np.isnan(loss).tolist() == [True, False, True, False, False]
    ok = ~np.isnan(want)
    np.testing.assert_allclose(loss[ok], want[ok], rtol=LOSS_RTOL)
    _grad_close(g, gw)
    # the wrapped forward is column V - 1's NLL; its gradient has no -1
    lse = np.log(np.exp(x[1].astype(np.float64)).sum())
    nll = lse - x[1, V - 1]
    assert np.isclose(loss[1], (1 - eps) * nll + eps * (lse - x[1].mean()),
                      rtol=1e-5)
    assert (g[1] * np.sign(cot[1]) >= -eps / V * abs(cot[1]) - 1e-7).all()


def test_class_surface_ignores_padding_idx():
    """SoftmaxCrossEntropyLoss.apply (and the contrib re-export) takes
    padding_idx and ignores it, as the reference."""
    x, lab, cot = _case(8, 32, seed=5)
    lab[:3] = 0
    want, gw, _ = _ref(x, lab, cot, 0.1, False)
    for pad in (0, 3):
        def fn(x, lab, eps, h2f, pad=pad):
            return contrib_x.SoftmaxCrossEntropyLoss.apply(
                x, lab, eps, pad, h2f)
        loss, g, _ = _port(x, lab, cot, 0.1, False, fn=fn)
        np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)
        _grad_close(g, gw)
    j = jx.SoftmaxCrossEntropyLoss.apply(jnp.asarray(x), jnp.asarray(lab),
                                         0.1, 3, False)
    np.testing.assert_allclose(np.asarray(j), want, rtol=0)
    assert contrib_x.softmax_cross_entropy_loss is X.softmax_cross_entropy_loss


def test_loss_refusals_and_o1_cast():
    """Labels must match the leading dims and be integers; under O1 the
    logits run in fp32 (FLOAT-class), so bf16 logits give an fp32 loss."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="leading dims"):
        X.softmax_cross_entropy_loss(x, torch.zeros(3, dtype=torch.long))
    with pytest.raises(TypeError, match="integers"):
        X.softmax_cross_entropy_loss(x, torch.zeros(4))
    xb = torch.zeros(4, 8, dtype=torch.bfloat16)
    lab = torch.zeros(4, dtype=torch.long)
    with amp.with_policy(amp.O1):
        assert X.softmax_cross_entropy_loss(xb, lab).dtype == torch.float32
    with japp.with_policy(japp.O1):
        assert jx.softmax_cross_entropy_loss(
            jnp.zeros((4, 8), jnp.bfloat16), jnp.zeros(4, jnp.int32)
        ).dtype == jnp.float32


def test_binary_cross_entropy_matches_reference_and_its_o1_ban():
    """BCE on probabilities in fp32 (values and gradient, the clip's edge
    included); under O1 a half input raises on both sides, fp32 does
    not."""
    rng = np.random.default_rng(7)
    p = rng.uniform(0, 1, (5, 9)).astype(np.float32)
    p[0, :3] = (0.0, 1.0, 1e-13)
    t = (rng.uniform(0, 1, (5, 9)) > 0.5).astype(np.float32)
    cot = rng.standard_normal((5, 9)).astype(np.float32)
    out, vjp = jax.vjp(jx.binary_cross_entropy, jnp.asarray(p),
                       jnp.asarray(t))
    gp, gt = vjp(jnp.asarray(cot))
    pt, tt = (torch.tensor(a, requires_grad=True) for a in (p, t))
    y = X.binary_cross_entropy(pt, tt)
    y.backward(torch.tensor(cot))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               rtol=LOSS_RTOL)
    _grad_close(pt.grad.numpy(), np.asarray(gp))
    _grad_close(tt.grad.numpy(), np.asarray(gt))
    half = torch.full((2, 2), 0.5, dtype=torch.bfloat16)
    with amp.with_policy(amp.O1):
        with pytest.raises(RuntimeError, match="binary_cross_entropy"):
            X.binary_cross_entropy(half, half)
        assert X.binary_cross_entropy(half.float(),
                                      half.float()).dtype == torch.float32
    with japp.with_policy(japp.O1):
        with pytest.raises(RuntimeError, match="binary_cross_entropy"):
            jx.binary_cross_entropy(jnp.full((2, 2), 0.5, jnp.bfloat16),
                                    jnp.full((2, 2), 0.5, jnp.bfloat16))
    # outside O1 a half input is legal
    assert X.binary_cross_entropy(half, half).dtype == torch.bfloat16
