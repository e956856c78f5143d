"""Port parity for ``ops/focal_loss.py``: apex_tpu_torch's ``focal_loss``
(and the contrib re-export) against apex_tpu's ``custom_vjp`` of XLA ops
on seeded numpy inputs, forward and backward.

Tolerances: the fp32 loss within 1e-5 relative, the gradient within 2e-4
of its largest entry (sums in another order); the saved partial gradient
scaled by the cotangent, dtypes and refusals exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as japp
from apex_tpu.contrib.focal_loss import focal_loss as jfocal
from apex_tpu_torch import amp
from apex_tpu_torch.contrib import focal_loss as contrib_fl
from apex_tpu_torch.ops import focal_loss as FL


def _case(anchors, C, seed):
    rng = np.random.default_rng(seed)
    x = (2 * rng.standard_normal((2, anchors, C))).astype(np.float32)
    # background, every class, a negative target, one past the classes
    tg = rng.integers(-1, C + 2, (2, anchors)).astype(np.int32)
    return x, tg


@pytest.mark.parametrize("alpha,gamma,smooth", [(0.25, 2.0, 0.0),
                                                (0.5, 1.5, 0.1),
                                                (0.25, 0.0, 0.05)])
def test_focal_loss_matches_reference(alpha, gamma, smooth):
    C = 10
    x, tg = _case(37, C, seed=int(gamma * 10))
    cot = 0.7
    loss, vjp = jax.vjp(lambda l: jfocal(l, jnp.asarray(tg), C,
                                                  alpha, gamma, smooth),
                        jnp.asarray(x))
    (gw,) = vjp(jnp.float32(cot))
    xt = torch.tensor(x, requires_grad=True)
    got = contrib_fl.focal_loss(xt, torch.tensor(tg), C, alpha, gamma,
                                smooth)
    got.backward(torch.tensor(cot))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    gw = np.asarray(gw)
    np.testing.assert_allclose(xt.grad.numpy(), gw, rtol=0,
                               atol=2e-4 * np.abs(gw).max())


def test_backward_is_one_scale_of_the_saved_partial_gradient():
    """The only residual is the whole partial gradient in the logits'
    dtype; the backward multiplies it by the cotangent (two cotangents,
    gradients in proportion); bf16 logits give a bf16 gradient and an
    fp32 loss, and under O1 the logits are cast to fp32."""
    x, tg = _case(16, 6, seed=2)
    xt = torch.tensor(x).bfloat16().requires_grad_()
    loss = FL.focal_loss(xt, torch.tensor(tg), 6)
    assert loss.dtype == torch.float32
    (g1,) = torch.autograd.grad(loss, xt, torch.tensor(1.0),
                                retain_graph=True)
    (g3,) = torch.autograd.grad(loss, xt, torch.tensor(3.0))
    assert g1.dtype == torch.bfloat16
    torch.testing.assert_close(g3.float(), (3.0 * g1.float()).bfloat16()
                               .float(), rtol=0, atol=0)
    with amp.with_policy(amp.O1):
        x32 = torch.tensor(x).bfloat16().requires_grad_()
        FL.focal_loss(x32, torch.tensor(tg), 6).backward()
    assert x32.grad.dtype == torch.bfloat16  # cast back through the O1 cast
    with japp.with_policy(japp.O1):
        assert jfocal(jnp.asarray(x, jnp.bfloat16), jnp.asarray(tg),
                              6).dtype == jnp.float32


def test_focal_loss_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="num_classes|leading"):
        FL.focal_loss(torch.zeros(4, 5), torch.zeros(4, dtype=torch.long), 6)
    with pytest.raises(ValueError, match="leading"):
        FL.focal_loss(torch.zeros(4, 6), torch.zeros(3, dtype=torch.long), 6)
