"""Shared harness of the optimizer parity tests (test_torch_lamb.py,
test_torch_optimizers_more.py, test_torch_larc.py): one seeded parameter
tree and seeded gradients, stepped by a reference optax transformation
(``opt.update`` then ``optax.apply_updates``) and by a port optimizer
over the same tree's tensors, and the comparisons.

The tree holds a list of per-layer dicts, as the port's models do; JAX
flattens a dict by sorted key and a list by index, as
``apex_tpu_torch.utils.pytree.tree_leaves`` does, so the two leaf orders
agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from apex_tpu_torch.utils.pytree import tree_leaves

SHAPES = {"w": (48, 40), "b": (40,),
          "layers": [{"k": (24, 16), "ln": (16,)},
                     {"k": (24, 16), "ln": (16,)}]}


def build(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: build(fn, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [build(fn, v) for v in shapes]
    return fn(shapes)


def init_params(seed=5, scale=0.05, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return build(lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32), shapes)


def grads(step, seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed + 100 * step)
    return build(lambda s: rng.standard_normal(s).astype(np.float32), shapes)


def ref_kw(kw):
    """The port's keyword names as the reference's: ``lr`` →
    ``learning_rate``, ``betas`` → ``b1``, ``b2``."""
    out = {("learning_rate" if k == "lr" else k): v for k, v in kw.items()
           if k != "betas"}
    if "betas" in kw:
        out["b1"], out["b2"] = kw["betas"]
    return out


def to_torch(tree, dtype, grad=False):
    def leaf(a):
        return torch.tensor(np.asarray(a, np.float32)).to(dtype) \
            .requires_grad_(grad)
    return jax.tree.map(leaf, tree)


def run(ref_opt, make_port, dtype_j=jnp.float32, dtype_t=torch.float32,
        steps=3, p0=None, grads_fn=grads, shapes=SHAPES):
    """``steps`` steps of both on the same gradients. ``make_port(leaves)``
    builds the port optimizer over the tree's tensors. Returns (reference
    params, reference state, port tree, port optimizer)."""
    p0 = init_params(shapes=shapes) if p0 is None else p0
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype_j), p0)
    state = ref_opt.init(pj)
    pt = to_torch(p0, dtype_t, grad=True)
    leaves = tree_leaves(pt)
    topt = make_port(leaves)
    for i in range(steps):
        g = grads_fn(i, shapes=shapes)
        gj = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype_j), g)
        upd, state = ref_opt.update(gj, state, pj)
        pj = optax.apply_updates(pj, upd)
        for t, a in zip(leaves, jax.tree.leaves(g)):
            t.grad = torch.tensor(a).to(dtype_t)
        topt.step()
    return pj, state, pt, topt


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close_leaves(got, want, rtol, atol, what="", of_largest=0.0):
    """Each leaf within ``rtol`` relative plus ``atol``, or plus
    ``of_largest`` times the leaf's largest entry where that is larger
    (for an entry near a cancellation, e.g. a moment whose gradient was
    divided by a norm that the two sides sum in their own orders)."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np32(w)
        big = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(np32(g), w, rtol=rtol,
                                   atol=max(atol, of_largest * big),
                                   err_msg=f"{what} leaf {i}")


def assert_bf16_leaves(got, want, what="", mantissa_bits=7):
    """bf16 params: the update rounded to bf16 and added in bf16 as the
    reference does; where the two frameworks' fp32 arithmetic differs in
    the last bit, a rounding may flip, so at most 1 element in 1000 may
    differ, by at most one ulp (``mantissa_bits`` 10 for fp16)."""
    total = differ = 0
    for i, (g, w) in enumerate(zip(list(got), list(want))):
        a, e = np32(g), np32(w)
        total += a.size
        diff = a != e
        differ += int(diff.sum())
        if diff.any():
            ulp = np.abs(e[diff]) * 2.0 ** -mantissa_bits
            assert (np.abs(a[diff] - e[diff]) <= ulp).all(), f"{what} {i}"
    assert differ <= total // 1000, f"{what}: {differ} of {total} differ"


def port_state(topt, leaves, name):
    return [topt.state[t][name] for t in leaves]
