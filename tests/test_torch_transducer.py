"""Port parity for contrib's transducer: ``apex_tpu_torch.contrib.
transducer`` against ``apex_tpu.contrib.transducer`` on the same seeded
numpy inputs, fp32.

* the joint (broadcast add, ReLU, the length masking) within 1e-6;
* the RNN-T loss within 1e-5 relative and its gradient (the port's
  occupancy backward against the reference's autodiff through its scan)
  within 2e-4 of the largest entry, at ragged lengths (an element of one
  frame, one of no label, full lengths, the blank among the labels);
* a lattice small enough to enumerate: the loss is minus the log of the
  sum over every alignment path;
* dropout: a shared generator gives the same mask twice, zeros where
  dropped and h / (1 - p) where kept;
* the packing knobs: only their default False.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import transducer as jtr
from apex_tpu_torch.contrib import transducer as ttr

LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


def _joint_inputs(B, T, U, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H)).astype(np.float32),
            rng.standard_normal((B, U, H)).astype(np.float32))


@pytest.mark.parametrize("relu", [False, True])
def test_joint_matches_reference_with_ragged_lengths(relu):
    f, g = _joint_inputs(3, 6, 4, 8, seed=int(relu))
    f_len = np.array([6, 3, 1], np.int32)
    g_len = np.array([4, 0, 2], np.int32)
    want = jtr.transducer_joint(jnp.asarray(f), jnp.asarray(g),
                                jnp.asarray(f_len), jnp.asarray(g_len),
                                relu=relu)
    got = ttr.transducer_joint(torch.tensor(f), torch.tensor(g),
                               torch.tensor(f_len), torch.tensor(g_len),
                               relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    mod = ttr.TransducerJoint(relu=relu)
    assert torch.equal(mod(torch.tensor(f), torch.tensor(g),
                           torch.tensor(f_len), torch.tensor(g_len)), got)


LOSS_CASES = [
    # (B, T, U, V, f_len, y_len, blank)
    pytest.param(3, 7, 4, 6, [7, 5, 1], [4, 2, 0], 0, id="ragged"),
    pytest.param(2, 9, 3, 5, [9, 9], [3, 3], 0, id="full"),
    pytest.param(2, 4, 6, 7, [2, 4], [6, 1], 0, id="u-longer-than-t"),
    pytest.param(4, 12, 5, 9, [12, 8, 3, 10], [5, 3, 5, 0], 4,
                 id="blank-4"),
]


def _loss_inputs(B, T, U, V, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, U)).astype(np.int32)
    dloss = rng.standard_normal(B).astype(np.float32)
    return x, labels, dloss


@pytest.mark.parametrize("B,T,U,V,f_len,y_len,blank", LOSS_CASES)
def test_loss_and_gradient_match_reference(B, T, U, V, f_len, y_len,
                                           blank):
    x, labels, dloss = _loss_inputs(B, T, U, V, seed=B * T + U)
    f_len = np.array(f_len, np.int32)
    y_len = np.array(y_len, np.int32)
    want, vjp = jax.vjp(lambda xx: jtr.transducer_loss(
        xx, jnp.asarray(labels), jnp.asarray(f_len), jnp.asarray(y_len),
        blank), jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(dloss))
    tx = torch.tensor(x, requires_grad=True)
    got = ttr.TransducerLoss()(tx, torch.tensor(labels),
                               torch.tensor(f_len), torch.tensor(y_len),
                               blank)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOSS_RTOL)
    got.backward(torch.tensor(dloss))
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(tx.grad.numpy(), g_want, rtol=0,
                               atol=GRAD_RTOL * np.abs(g_want).max())


def test_loss_is_the_sum_over_every_alignment():
    """T 3, U 2, V 3: every monotone path from (0, 0) of T - 1 blanks and
    U labels in any order, then the final blank at (T - 1, U)."""
    T, U, V = 3, 2, 3
    x, labels, _ = _loss_inputs(1, T, U, V, seed=9)
    lp = torch.log_softmax(torch.tensor(x, dtype=torch.float64), -1)[0]
    total = []
    for blanks in itertools.combinations(range(T - 1 + U), T - 1):
        t = u = 0
        s = 0.0
        for step in range(T - 1 + U):
            if step in blanks:
                s += lp[t, u, 0].item()
                t += 1
            else:
                s += lp[t, u, labels[0, u]].item()
                u += 1
        total.append(s + lp[T - 1, U, 0].item())
    want = -np.log(np.sum(np.exp(total)))
    got = ttr.transducer_loss(torch.tensor(x), torch.tensor(labels),
                              torch.tensor([T]), torch.tensor([U]))
    np.testing.assert_allclose(got.numpy(), [want], rtol=1e-6)
    ref = jtr.transducer_loss(jnp.asarray(x), jnp.asarray(labels),
                              jnp.asarray([T]), jnp.asarray([U]))
    np.testing.assert_allclose(np.asarray(ref), [want], rtol=1e-5)


def test_dropout_scale_zeros_and_shared_generator():
    f, g = _joint_inputs(2, 16, 8, 32, seed=3)
    f, g = torch.tensor(f), torch.tensor(g)
    rate = 0.3
    plain = ttr.transducer_joint(f, g, relu=True)
    mod = ttr.TransducerJoint(relu=True, dropout=True, dropout_prob=rate)
    a = mod(f, g, key=torch.Generator().manual_seed(5))
    b = ttr.transducer_joint(f, g, relu=True, dropout_rate=rate,
                             key=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], plain[kept] / (1 - rate),
                               rtol=1e-6, atol=0)
    live = plain != 0
    share = (kept & live).sum().item() / live.sum().item()
    assert abs(share - (1 - rate)) < 0.02
    c = mod(f, g, key=torch.Generator().manual_seed(6))
    assert not torch.equal(a, c)
    # no generator: no dropout, as in the reference
    assert torch.equal(mod(f, g), plain)


def test_packing_knobs_take_only_their_default():
    with pytest.raises(TypeError, match="masked"):
        ttr.TransducerJoint(pack_output=True)
    with pytest.raises(TypeError, match="masked"):
        ttr.TransducerLoss(packed_input=True)
    ttr.TransducerJoint(pack_output=False)
    ttr.TransducerLoss(packed_input=False)
