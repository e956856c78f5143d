"""Port parity for contrib's convolution blocks: ``conv_bias_relu``,
``bottleneck`` and ``groupbn`` of ``apex_tpu_torch.contrib`` against
``apex_tpu.contrib``'s on the same seeded numpy inputs, fp32.

* the ``conv_bias_relu`` family within 1e-5 of the largest entry, with
  XLA's "SAME" (at stride 2 on even and odd inputs: (0, 1) and (1, 1)
  padding), "VALID" and explicit pads, and their gradients within 2e-4;
* ``Bottleneck`` with and without the projection: output and new states
  within 1e-5, every parameter's gradient within 2e-4 of its largest;
* ``BatchNorm2d_NHWC`` is checked beside ``SyncBatchNorm`` in
  ``test_torch_sync_batchnorm.py``; here its fused add + ReLU on a
  convolution's output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import bottleneck as jbneck
from apex_tpu.contrib import conv_bias_relu as jcbr
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JSyncBN
from apex_tpu_torch.contrib import bottleneck as tbneck
from apex_tpu_torch.contrib import conv_bias_relu as tcbr
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.models.convert import bn_state_from_jax

OUT_TOL = 1e-5
GRAD_TOL = 2e-4


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _oihw(w_hwio):
    return torch.tensor(np.ascontiguousarray(np.transpose(w_hwio,
                                                          (3, 2, 0, 1))))


def _conv_case(hw, k, cin=4, cout=6, seed=0):
    rng = np.random.default_rng(seed + hw + k)
    return (rng.standard_normal((2, hw, hw, cin)).astype(np.float32),
            (rng.standard_normal((k, k, cin, cout)) * 0.3).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32))


PADS = [
    pytest.param(8, 3, 2, "SAME", id="same-stride2-even"),
    pytest.param(9, 3, 2, "SAME", id="same-stride2-odd"),
    pytest.param(8, 3, 1, "SAME", id="same-stride1"),
    pytest.param(8, 1, 2, "SAME", id="same-1x1-stride2"),
    pytest.param(9, 3, 2, "VALID", id="valid"),
    pytest.param(8, 3, 2, ((1, 1), (1, 1)), id="explicit-symmetric"),
    pytest.param(8, 3, 1, ((2, 0), (0, 1)), id="explicit-asymmetric"),
]


@pytest.mark.parametrize("hw,k,stride,padding", PADS)
@pytest.mark.parametrize("op", ["conv_bias", "conv_bias_relu",
                                "conv_bias_mask_relu",
                                "conv_frozen_scale_bias_relu"])
def test_conv_family_matches_reference(op, hw, k, stride, padding):
    x, w, b = _conv_case(hw, k)
    rng = np.random.default_rng(hw * 7 + k)
    extra = {"conv_bias_mask_relu": lambda shape: (rng.random(shape) > 0.3)
             .astype(np.float32),
             "conv_frozen_scale_bias_relu": lambda shape: rng.uniform(
                 0.5, 1.5, shape[-1:]).astype(np.float32)}
    jfn, tfn = getattr(jcbr, op), getattr(tcbr, op)
    out_r = jcbr.conv_bias(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           stride, padding)
    args = ([extra[op](out_r.shape)] if op in extra else [])

    def ref(x, w, b):
        if op == "conv_frozen_scale_bias_relu":
            y = jfn(x, w, jnp.asarray(args[0]), b, stride, padding)
        else:
            y = jfn(x, w, b, *map(jnp.asarray, args), stride, padding)
        return jnp.sum(y * dy), y

    dy = np.random.default_rng(5).standard_normal(out_r.shape).astype(
        np.float32)
    (_, y_r), g_r = jax.value_and_grad(ref, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx = torch.tensor(x, requires_grad=True)
    tw = _oihw(w).requires_grad_()
    tb = torch.tensor(b, requires_grad=True)
    if op == "conv_frozen_scale_bias_relu":
        y = tfn(tx, tw, torch.tensor(args[0]), tb, stride, padding)
    else:
        y = tfn(tx, tw, tb, *map(torch.tensor, args), stride, padding)
    (y * torch.tensor(dy)).sum().backward()
    _close(y.detach(), y_r, OUT_TOL, "y")
    _close(tx.grad, g_r[0], GRAD_TOL, "dx")
    _close(tw.grad.permute(2, 3, 1, 0), g_r[1], GRAD_TOL, "dw")
    _close(tb.grad, g_r[2], GRAD_TOL, "db")


def test_xla_same_padding_is_asymmetric_at_stride_2():
    assert tcbr.conv_pads((8, 8), (3, 3), 2, "SAME") == ((0, 1), (0, 1))
    assert tcbr.conv_pads((9, 9), (3, 3), 2, "SAME") == ((1, 1), (1, 1))
    assert tcbr.conv_pads((8, 8), (3, 3), 1, "same") == ((1, 1), (1, 1))
    assert tcbr.conv_pads((8, 8), (3, 3), 2, "VALID") == ((0, 0), (0, 0))
    with pytest.raises(ValueError, match="SAME"):
        tcbr.conv_pads((8, 8), (3, 3), 2, "FULL")


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("cin,ch,cout,stride", [
    pytest.param(16, 4, 16, 1, id="identity"),
    pytest.param(8, 4, 16, 2, id="projection-stride2"),
    pytest.param(8, 4, 16, 1, id="projection")])
def test_bottleneck_matches_reference(cin, ch, cout, stride):
    jb = jbneck.Bottleneck(cin, ch, cout, stride)
    jp, js = jb.init(jax.random.PRNGKey(cin + stride))
    # non-trivial affines, so their gradients are checked on real values
    jp = jax.tree.map(lambda a: a, jp)
    rng = np.random.default_rng(cout)
    for k in jp:
        if k.startswith("bn"):
            n = jp[k]["scale"].shape[0]
            jp[k] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, n),
                                          jnp.float32),
                     "bias": jnp.asarray(rng.standard_normal(n) * 0.2,
                                         jnp.float32)}
    x = rng.standard_normal((4, 12, 12, cin)).astype(np.float32)

    def ref(p, x):
        y, st = jb(p, js, x)
        return jnp.sum(y * dy), (y, st)

    y0, _ = jb(jp, js, jnp.asarray(x))
    dy = np.random.default_rng(9).standard_normal(y0.shape).astype(
        np.float32)
    (_, (y_r, st_r)), g_r = jax.value_and_grad(ref, has_aux=True)(
        jp, jnp.asarray(x))
    tb = tbneck.Bottleneck(cin, ch, cout, stride)
    params = {k: (_oihw(np.asarray(v)) if k.startswith("conv") else
                  {n: torch.tensor(np.asarray(a)) for n, a in v.items()})
              for k, v in jp.items()}
    leaves = {}
    for k, v in params.items():
        if k.startswith("conv"):
            leaves[f"['{k}']"] = v.requires_grad_()
        else:
            for n, a in v.items():
                leaves[f"['{k}']['{n}']"] = a.requires_grad_()
    y, st = tb(params, bn_state_from_jax(js, device="cpu"), torch.tensor(x))
    (y * torch.tensor(dy)).sum().backward()
    _close(y.detach(), y_r, OUT_TOL, "y")
    assert set(st) == set(st_r)
    for name in st_r:
        _close(st[name].running_var, st_r[name].running_var, OUT_TOL, name)
        _close(st[name].running_mean, st_r[name].running_mean, OUT_TOL,
               name)
    want = _flat(g_r)
    assert set(want) == set(leaves)
    for name, t in leaves.items():
        g = t.grad.permute(2, 3, 1, 0) if t.ndim == 4 else t.grad
        _close(g, want[name], GRAD_TOL, name)
    # the port's own init: the reference's shapes in PyTorch's layout
    p2, s2 = tb.init(torch.Generator().manual_seed(0), device="cpu")
    assert ("conv_proj" in p2) == ("conv_proj" in jp)
    assert tuple(p2["conv_b"].shape) == (ch, ch, 3, 3)


def test_groupbn_fused_add_relu_on_a_convolution():
    x, w, b = _conv_case(8, 3, cout=8)
    h_r = jcbr.conv_bias(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    res = np.random.default_rng(3).standard_normal(h_r.shape).astype(
        np.float32)
    jm = JSyncBN(8, axis_name=None, fuse_relu=True)
    jp, js = jm.init()
    y_r, _ = jm(jp, js, h_r, residual=jnp.asarray(res))
    h = tcbr.conv_bias(torch.tensor(x), _oihw(w), torch.tensor(b))
    mod = BatchNorm2d_NHWC(8, fuse_relu=True)
    p, s = mod.init(device="cpu")
    y, _ = mod(p, s, h, residual=torch.tensor(res))
    _close(y, y_r, OUT_TOL, "y")
    assert (y >= 0).all()
