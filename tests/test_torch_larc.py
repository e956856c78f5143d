"""Port parity: apex_tpu_torch's ``LARC(FusedSGD(...))`` against apex_tpu's
``optax.chain(larc(...), fused_sgd(...))`` plus ``optax.apply_updates``
over 3 steps on the same seeded gradients (``torch_opt_harness``).

The port's LARC, as upstream apex's, takes each group's ``lr`` and
``weight_decay`` and steps the wrapped optimizer at decay 0; the
reference's takes them as its own arguments, with the chained SGD at
decay 0. Clip and scale modes, a schedule (LARC evaluates it at its own
0-based count, the SGD at ``count - 1``: the same value), weight decay,
a zero-norm parameter and a zero gradient (both pass untouched, weight
decay included), and bf16 params.

Tolerance: params and momentum buffers to 1e-6 relative (atol 1e-9), or
1e-6 of the leaf's largest entry where larger: the trust ratio divides by
norms that the two sides sum in their own orders. bf16 params: at most 1
element in 1000 one bf16 ulp off.
"""

import copy

import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_opt_harness as H
from apex_tpu.optimizers import fused_sgd
from apex_tpu.parallel import larc
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import LARC
from apex_tpu_torch.utils.pytree import tree_leaves

RTOL, ATOL, OF_LARGEST = 1e-6, 1e-9, 1e-6

CASES = {
    "clip": dict(clip=True),
    "scale": dict(clip=False, trust_coefficient=0.001),
    "clip_decay": dict(clip=True, weight_decay=1e-3),
    "scale_decay": dict(clip=False, weight_decay=1e-3),
    "clip_schedule": dict(clip=True, lr=lambda c: 0.1 * 0.5 ** c),
}


def _pair(kw):
    lr = kw.get("lr", 0.1)
    wd = kw.get("weight_decay", 0.0)
    tc = kw.get("trust_coefficient", 0.02)
    ref = optax.chain(
        larc(learning_rate=lr, trust_coefficient=tc, clip=kw["clip"],
             weight_decay=wd),
        fused_sgd(learning_rate=lr, momentum=0.9))

    def port(leaves):
        return LARC(FusedSGD(leaves, lr=lr, momentum=0.9, weight_decay=wd),
                    trust_coefficient=tc, clip=kw["clip"])
    return ref, port


def _zero_grad_fn(i, shapes=H.SHAPES):
    g = H.grads(i, shapes=shapes)
    g["b"] = g["b"] * 0.0  # a zero gradient
    return g


def _check(state, pj, pt, opt, fp32=True):
    leaves = tree_leaves(pt)
    if fp32:
        H.assert_close_leaves(leaves, jax.tree.leaves(pj), RTOL, ATOL, "p",
                              OF_LARGEST)
    else:
        H.assert_bf16_leaves(leaves, jax.tree.leaves(pj), "p")
    sgd_state = state[1]
    H.assert_close_leaves(H.port_state(opt.optim, leaves, "momentum_buffer"),
                          jax.tree.leaves(sgd_state.buffers["momentum"]),
                          RTOL, ATOL, "momentum", OF_LARGEST)
    assert opt.count == 3


@pytest.mark.parametrize("name", sorted(CASES))
def test_larc_sgd_matches_reference(name):
    kw = CASES[name]
    ref, port = _pair(kw)
    p0 = H.init_params()
    p0["layers"][1]["ln"] = p0["layers"][1]["ln"] * 0.0  # a zero-norm param
    pj, state, pt, opt = H.run(ref, port, p0=p0, grads_fn=_zero_grad_fn)
    _check(state, pj, pt, opt)
    # the group's weight decay is back after the step
    assert opt.param_groups[0]["weight_decay"] == kw.get("weight_decay", 0.0)


def test_larc_leaves_zero_norms_untouched():
    """Where a parameter's or a gradient's norm is 0 the gradient reaches
    the wrapped optimizer as it was, weight decay included."""
    p = torch.zeros(4, requires_grad=True)
    q = torch.ones(3, requires_grad=True)
    opt = LARC(FusedSGD([p, q], lr=0.1, weight_decay=0.5))
    p.grad = torch.arange(4.0)
    q.grad = torch.zeros(3)
    opt.optim.step = lambda: None  # read the gradients LARC hands over
    opt.step()
    torch.testing.assert_close(p.grad, torch.arange(4.0), rtol=0, atol=0)
    torch.testing.assert_close(q.grad, torch.zeros(3), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["clip", "scale_decay"])
def test_larc_sgd_bf16_params_match_reference(name):
    ref, port = _pair(CASES[name])
    pj, state, pt, opt = H.run(ref, port, jnp.bfloat16, torch.bfloat16)
    _check(state, pj, pt, opt, fp32=False)


def test_larc_state_dict_round_trip():
    ref, port = _pair(CASES["clip"])
    _, _, pt, opt = H.run(ref, port, steps=2)
    leaves = tree_leaves(pt)
    sd = copy.deepcopy(opt.state_dict())  # as torch.save would
    clone = [t.detach().clone().requires_grad_() for t in leaves]
    opt2 = port(clone)
    opt2.load_state_dict(sd)
    assert opt2.count == 2
    g = jax.tree.leaves(H.grads(2))
    for ts, o in ((leaves, opt), (clone, opt2)):
        for t, a in zip(ts, g):
            t.grad = torch.tensor(a)
        o.step()
    for a, b in zip(leaves, clone):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
