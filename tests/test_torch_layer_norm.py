"""Port parity for the fused norms: apex_tpu_torch's ``fused_layer_norm``,
``fused_rms_norm``, their plain versions and the ``FusedLayerNorm`` /
``FusedRMSNorm`` modules against apex_tpu's on the same seeded inputs.

The reference runs with its Pallas ``ln_fwd``/``ln_bwd`` in interpret mode
(``APEX_TPU_PALLAS=interpret``; its kernel takes hidden % 128 == 0, so the
tail hidden 200 takes its XLA path there too) and on its XLA path
(``=0``); the port runs its plain versions (CPU tensors). fp32 on both
sides. Tolerances: outputs (y, mean, rstd) within 1e-5 relative and
absolute; dx, dgamma and dbeta within 2e-4 of the leaf's largest entry
(fp32 sums over rows in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jln
from apex_tpu.ops.pallas import layer_norm as jk
from apex_tpu_torch.models.convert import norm_from_jax
from apex_tpu_torch.ops import layer_norm as tln

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4


def _close_grad(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_RTOL * scale, err_msg=what)


def _inputs(shape, norm_shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(norm_shape)).astype(np.float32)
    b = (0.2 * rng.standard_normal(norm_shape)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, dy


CASES = [
    # (x shape, normalized_shape, rms, affine)
    pytest.param((3, 5, 256), (256,), False, "wb", id="ln-affine"),
    pytest.param((3, 5, 256), (256,), False, "w", id="ln-weight-only"),
    pytest.param((4, 256), (256,), False, "", id="ln-no-affine"),
    pytest.param((3, 5, 256), (256,), True, "w", id="rms-weight"),
    pytest.param((4, 256), (256,), True, "", id="rms-no-affine"),
    pytest.param((2, 3, 4, 64), (4, 64), False, "wb", id="ln-multidim"),
    pytest.param((6, 200), (200,), False, "wb", id="ln-tail-hidden"),
    pytest.param((6, 200), (200,), True, "w", id="rms-tail-hidden"),
]


@pytest.mark.parametrize("pallas", ["interpret", "0"])
@pytest.mark.parametrize("shape,norm_shape,rms,affine", CASES)
def test_norm_forward_and_gradients_match_reference(
        pallas, shape, norm_shape, rms, affine, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    x, w, b, dy = _inputs(shape, norm_shape, seed=len(shape) + int(rms))
    w = w if "w" in affine else None
    b = b if "b" in affine else None
    leaves = [a for a in (x, w, b) if a is not None]

    def jfn(*args):
        it = iter(args)
        xx = next(it)
        ww = next(it) if w is not None else None
        bb = next(it) if b is not None else None
        if rms:
            return jln.fused_rms_norm(xx, ww, norm_shape)
        return jln.fused_layer_norm(xx, ww, bb, norm_shape)

    y_j, vjp = jax.vjp(jfn, *map(jnp.asarray, leaves))
    g_j = vjp(jnp.asarray(dy))
    targs = [torch.tensor(a, requires_grad=True) for a in leaves]
    it = iter(targs)
    tx = next(it)
    tw = next(it) if w is not None else None
    tb = next(it) if b is not None else None
    if rms:
        y = tln.fused_rms_norm(tx, tw, norm_shape)
    else:
        y = tln.fused_layer_norm(tx, tw, tb, norm_shape)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL)
    y.backward(torch.tensor(dy))
    for name, t, g in zip(("dx", "dgamma", "dbeta"), targs, g_j):
        _close_grad(t.grad.numpy(), g, name)


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("hidden", [256, 384])
def test_plain_versions_match_the_pallas_kernels(rms, hidden):
    """``_torch_fwd``/``_torch_bwd`` against the Pallas ``ln_fwd``/``ln_bwd``
    run in interpret mode, and the reference's ``_xla_fwd``/``_xla_bwd``:
    y, mean, rstd, dx, and the fp32 dgamma/dbeta."""
    x, w, b, dy = _inputs((24, hidden), (hidden,), seed=hidden)
    jb = None if rms else jnp.asarray(b)
    y, mean, rstd = tln._torch_fwd(torch.tensor(x), torch.tensor(w),
                                   None if rms else torch.tensor(b), 1e-5,
                                   rms)
    dx, dw, db = tln._torch_bwd(torch.tensor(dy), torch.tensor(x), mean,
                                rstd, torch.tensor(w), rms)
    for fwd, bwd in ((lambda *a: jk.ln_fwd(*a, eps=1e-5, rms=rms,
                                           interpret=True),
                      lambda *a: jk.ln_bwd(*a, rms=rms, interpret=True)),
                     (lambda *a: jln._xla_fwd(*a, 1e-5, rms),
                      lambda *a: jln._xla_bwd(*a, rms))):
        yj, mj, rj = fwd(jnp.asarray(x), jnp.asarray(w), jb)
        for got, want in ((y, yj), (mean, mj), (rstd, rj)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **OUT_TOL)
        dxj, dwj, dbj = bwd(jnp.asarray(dy), jnp.asarray(x), mj, rj,
                            jnp.asarray(w))
        _close_grad(dx.numpy(), dxj, "dx")
        _close_grad(dw.numpy(), dwj, "dgamma")
        _close_grad(db.numpy(), dbj, "dbeta")


@pytest.mark.parametrize("cls,rms", [("FusedLayerNorm", False),
                                     ("FusedRMSNorm", True),
                                     ("MixedFusedLayerNorm", False),
                                     ("MixedFusedRMSNorm", True)])
@pytest.mark.parametrize("affine", [True, False])
def test_modules_loaded_from_the_reference_match_it(cls, rms, affine):
    """The reference module's ``init()`` dict (perturbed, so the affine
    matters) through ``norm_from_jax`` into the port's ``nn.Module``: the
    same output and, for the Parameters, the same gradients."""
    norm_shape = (4, 32)
    jmod = getattr(jln, cls)(norm_shape, eps=1e-6,
                             elementwise_affine=affine)
    rng = np.random.default_rng(7)
    tree = {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in jmod.init().items()}
    mod = getattr(tln, cls)(norm_shape, eps=1e-6,
                            elementwise_affine=affine, device="cpu")
    assert isinstance(mod, torch.nn.Module) and mod.rms == rms
    assert norm_from_jax(tree, mod) is mod
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(tree)
    x, _, _, dy = _inputs((3, 4, 32), norm_shape, seed=3)
    y_j, vjp = jax.vjp(lambda p: jmod(p, jnp.asarray(x)),
                       jax.tree.map(jnp.asarray, tree))
    g_j = vjp(jnp.asarray(dy))[0]
    y = mod(torch.tensor(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL)
    if affine:
        y.backward(torch.tensor(dy))
        for name, p in mod.named_parameters():
            _close_grad(p.grad.numpy(), g_j[name], name)


def test_bad_arguments_raise():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="bias without weight"):
        tln.fused_layer_norm(x, None, torch.zeros(8))
    with pytest.raises(ValueError, match="impl"):
        tln.fused_layer_norm(x, impl="pallas")
    mod = tln.FusedLayerNorm(8, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        norm_from_jax({"weight": np.ones(8, np.float32)}, mod)
    with pytest.raises(ValueError, match="weight"):
        norm_from_jax({"weight": np.ones(4, np.float32),
                       "bias": np.zeros(8, np.float32)}, mod)
    # the CUDA wrappers refuse CPU tensors: no silent plain version
    with pytest.raises(ValueError, match="CUDA"):
        tln.ln_fwd_cuda(x, None, None, 1e-5, False)


def test_module_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tln.FusedRMSNorm(16)


def test_bwd_strided_rows_cover_each_row_once():
    """With ``ctas = ceil(rows / per)`` CTAs, CTA c owns rows c, c + ctas,
    ... (``per`` of them): every row is owned by exactly one CTA."""
    for rows in (1, 3, 4, 5, 7, 1000, 3001, 16384, 20480, 14592):
        per = tln.bwd_rows_per_cta(rows)
        ctas = -(-rows // per)
        owned = [c + k * ctas for c in range(ctas) for k in range(per)
                 if c + k * ctas < rows]
        assert sorted(owned) == list(range(rows))


def test_bwd_row_blocks_depend_on_rows_alone():
    """The backward's dgamma/dbeta summation order: a fixed row block per
    CTA, at most BWD_MAX_CTAS blocks, covering every row."""
    for rows in (1, 3, 4, 5, 1000, 16384, 20480, 65536, 14592):
        per = tln.bwd_rows_per_cta(rows)
        ctas = -(-rows // per)
        assert 1 <= ctas <= tln.BWD_MAX_CTAS and ctas * per >= rows
        assert (ctas - 1) * per < rows
