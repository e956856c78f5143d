"""Port parity for weight norm: ``apex_tpu_torch.reparameterization``
against ``apex_tpu.reparameterization`` on the same seeded numpy weights,
fp32: (g, v) and the recomposed weight within 1e-6 of the largest entry
along every ``dim``, the gradients through the composition within 2e-4,
and ``apply_weight_norm``/``remove_weight_norm`` over a nested tree with
the reference's path names (default selection, a custom one, rank-1
leaves untouched, lists by index)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import reparameterization as jwn
from apex_tpu_torch import reparameterization as twn


def _close(got, want, tol=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dim", [0, 1, -1])
@pytest.mark.parametrize("shape", [(6, 4), (5, 3, 2, 2)])
def test_decompose_compose_and_gradients(shape, dim):
    rng = np.random.default_rng(len(shape) + dim)
    w = rng.standard_normal(shape).astype(np.float32)
    g_r, v_r = jwn.weight_norm_decompose(jnp.asarray(w), dim % len(shape))
    g, v = twn.weight_norm_decompose(torch.tensor(w), dim)
    _close(g, g_r)
    _close(v, v_r)
    g2 = (np.asarray(g_r) * rng.uniform(0.5, 2, np.asarray(g_r).shape)
          ).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)

    def ref(g, v):
        return jnp.sum(jwn.weight_norm_compose(g, v, dim % len(shape)) * dy)

    gr = jax.grad(ref, argnums=(0, 1))(jnp.asarray(g2), jnp.asarray(w))
    tg = torch.tensor(g2, requires_grad=True)
    tv = torch.tensor(w, requires_grad=True)
    out = twn.weight_norm_compose(tg, tv, dim)
    _close(out.detach(), jwn.weight_norm_compose(
        jnp.asarray(g2), jnp.asarray(w), dim % len(shape)))
    (out * torch.tensor(dy)).sum().backward()
    _close(tg.grad, gr[0], 2e-4)
    _close(tv.grad, gr[1], 2e-4)
    # compose(decompose(w)) is w
    _close(twn.weight_norm_compose(*twn.weight_norm_decompose(
        torch.tensor(w), dim), dim), w, 1e-6)


def _tree(rng):
    a = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"enc": {"weight": a(4, 3), "bias": a(4)},
            "layers": [{"proj": {"weight": a(3, 5)}, "scale": a(3, 3)},
                       {"proj": {"weight": a(2, 2, 3)}, "ln_weight": a(3)}]}


@pytest.mark.parametrize("select", [None, "layers/0"], ids=["default",
                                                            "custom"])
def test_apply_and_remove_over_a_tree(select):
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    sel = None if select is None else (lambda name: name.startswith(select))
    ref = jwn.apply_weight_norm(jax.tree.map(jnp.asarray, tree), sel)
    got = twn.apply_weight_norm(jax.tree.map(torch.tensor, tree), sel)
    flat_r = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(
                  got, is_leaf=lambda a: isinstance(a, torch.Tensor))[0]}
    assert flat_r.keys() == flat_t.keys()
    for k in flat_r:
        _close(flat_t[k], flat_r[k])
    if select is None:
        assert set(got["enc"]["weight"]) == {"g", "v"}
        assert set(got["layers"][1]["proj"]["weight"]) == {"g", "v"}
        assert isinstance(got["layers"][1]["ln_weight"], torch.Tensor)
        assert isinstance(got["layers"][0]["scale"], torch.Tensor)
    else:
        assert set(got["layers"][0]["scale"]) == {"g", "v"}
        assert isinstance(got["enc"]["weight"], torch.Tensor)
    back_r = jwn.remove_weight_norm(ref)
    back = twn.remove_weight_norm(got)
    for (k1, a), (k2, b), (k3, w) in zip(
            jax.tree_util.tree_flatten_with_path(
                back, is_leaf=lambda a: isinstance(a, torch.Tensor))[0],
            jax.tree_util.tree_flatten_with_path(back_r)[0],
            jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert k1 == k2 == k3
        _close(a, b)
        _close(a, w)  # the round trip gives the weights back
