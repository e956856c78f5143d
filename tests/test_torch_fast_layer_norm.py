"""Port parity for contrib's FastLayerNorm and the wide norm kernels' host
side.

``apex_tpu_torch.contrib.layer_norm`` (``FastLayerNorm``,
``fast_layer_norm``) and ``fused_rms_norm`` against ``apex_tpu``'s on the
same seeded inputs at the hidden sizes the wide kernels serve on the card
(5120, 8192, 65536), the reference with its Pallas ``ln_fwd``/``ln_bwd``
in interpret mode (``APEX_TPU_PALLAS=interpret``) and the port on its
plain versions (CPU tensors); fp32. Tolerances: y within 1e-5 relative
and absolute; dx, dgamma and dbeta within 2e-4 of the leaf's largest entry
(fp32 sums over rows in another order).

The wide kernels' plans (``_wide_fwd_plan``, ``_wide_bwd_plan``), which
are pure Python: at every hidden the card's ``ln_wide`` leg runs and every
dtype, the row shape covers the row, each element of it held by exactly
one thread (the kernels' element map emulated), fits a CTA's 227 KB of
shared memory and the portable cluster size, the dgamma/dbeta buffer stays
within its share, and the summation order never reads the SM count. The
dispatch: rows past 4096 reach the wide wrappers, rows up to 4096 the
register kernels.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import layer_norm as jcln
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.contrib import layer_norm as tcln
from apex_tpu_torch.models.convert import norm_from_jax
from apex_tpu_torch.ops import layer_norm as tln

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4
#: the hidden sizes of chip_smoke.py's ln_wide leg
LN_WIDE_HIDDEN = (4097, 5000, 5120, 6144, 8192, 12288, 16384, 25600, 32768,
                  49152, 65536)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
SMEM_PER_CTA = 227 * 1024


def _close_grad(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_RTOL * scale, err_msg=what)


def _inputs(rows, hidden, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, hidden)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(hidden)).astype(np.float32)
    b = (0.2 * rng.standard_normal(hidden)).astype(np.float32)
    dy = rng.standard_normal((rows, hidden)).astype(np.float32)
    return x, w, b, dy


@pytest.mark.parametrize("hidden", [5120, 8192, 65536])
@pytest.mark.parametrize("rms,affine", [(False, True), (False, False),
                                        (True, True), (True, False)],
                         ids=["ln-affine", "ln", "rms-affine", "rms"])
def test_fast_layer_norm_matches_reference(hidden, rms, affine,
                                           monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", "interpret")
    x, w, b, dy = _inputs(3, hidden, seed=hidden + 2 * rms + affine)
    w = w if affine else None
    b = b if affine and not rms else None
    leaves = [a for a in (x, w, b) if a is not None]

    def jfn(*args):
        it = iter(args)
        xx = next(it)
        ww = next(it) if w is not None else None
        bb = next(it) if b is not None else None
        if rms:
            return jln.fused_rms_norm(xx, ww, (hidden,))
        return jcln.fast_layer_norm(xx, ww, bb, (hidden,))

    y_j, vjp = jax.vjp(jfn, *map(jnp.asarray, leaves))
    g_j = vjp(jnp.asarray(dy))
    targs = [torch.tensor(a, requires_grad=True) for a in leaves]
    it = iter(targs)
    tx = next(it)
    tw = next(it) if w is not None else None
    tb = next(it) if b is not None else None
    if rms:
        y = tln.fused_rms_norm(tx, tw, (hidden,))
    else:
        y = tcln.fast_layer_norm(tx, tw, tb, (hidden,))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL)
    y.backward(torch.tensor(dy))
    for name, t, g in zip(("dx", "dgamma", "dbeta"), targs, g_j):
        _close_grad(t.grad.numpy(), g, name)


@pytest.mark.parametrize("affine", [True, False])
def test_fast_layer_norm_module_matches_reference(affine, monkeypatch):
    """The reference module's perturbed ``init()`` dict in the port's
    ``FastLayerNorm`` at hidden 8192: the same output and gradients."""
    monkeypatch.setenv("APEX_TPU_PALLAS", "interpret")
    hidden = 8192
    jmod = jcln.FastLayerNorm(hidden, elementwise_affine=affine)
    rng = np.random.default_rng(11)
    tree = {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in jmod.init().items()}
    mod = norm_from_jax(tree, tcln.FastLayerNorm(
        hidden, elementwise_affine=affine, device="cpu"))
    x, _, _, dy = _inputs(2, hidden, seed=3)
    y_j, vjp = jax.vjp(lambda p, xx: jmod(p, xx),
                       {k: jnp.asarray(v) for k, v in tree.items()},
                       jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    y = mod(tx)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL)
    y.backward(torch.tensor(dy))
    _close_grad(tx.grad.numpy(), gx_j, "dx")
    for name, g in gp_j.items():
        _close_grad(getattr(mod, name).grad.numpy(), g, name)


def _thread_elements(plan, hidden, dtype, vec):
    """The elements each thread of the row holds, as the kernels' RowLayout
    maps them: thread gj of G, chunk c, element k at (c * G + gj) * V + k
    (vec) or (c * V + k) * G + gj."""
    V = 16 // dtype.itemsize
    G = plan.ranks * plan.warps * 32
    gj = np.arange(G)[:, None, None]
    c = np.arange(plan.chunks)[None, :, None]
    k = np.arange(V)[None, None, :]
    idx = (c * G + gj) * V + k if vec else (c * V + k) * G + gj
    return idx.reshape(-1)  # thread-major: a rank's threads contiguous


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("hidden", LN_WIDE_HIDDEN)
def test_wide_plans_cover_the_row_and_fit(hidden, dtype):
    for rows in (1, 8, 16, 300, 2048, 5000):
        for sms in (132, 114, 78):
            plan = tln._wide_fwd_plan(rows, hidden, dtype, sms)
            bplan = tln._wide_bwd_plan(rows, hidden, dtype)
            for p in (plan, bplan):
                assert p.chunks * 16 == tln.WIDE_ELEMS * dtype.itemsize
                assert 1 <= p.warps <= tln.WIDE_CTA_WARPS
                assert 1 <= p.ranks <= tln.WIDE_MAX_RANKS
                assert p.ranks * p.warps * 32 * tln.WIDE_ELEMS >= hidden
                assert p.smem <= SMEM_PER_CTA
                for vec in (True, False):
                    idx = _thread_elements(p, hidden, dtype, vec)
                    held = np.sort(idx[idx < hidden])
                    assert np.array_equal(held, np.arange(hidden))
                    # every rank of the cluster holds part of the row
                    per_rank = idx.reshape(p.ranks, -1)
                    assert (per_rank.min(axis=1) < hidden).all()
            assert 1 <= plan.clusters <= rows
            # the partial rows: each sums at least WIDE_BWD_ROWS rows (or
            # all of them), so the fp32 buffer, written and read once, is
            # within a twelfth of a 16-bit call's bytes (dy, x, dx)
            assert bplan.clusters <= max(1, rows // tln.WIDE_BWD_ROWS)
            if rows >= tln.WIDE_BWD_ROWS:
                part = 2 * bplan.clusters * 2 * hidden * 4
                call = 3 * rows * hidden * dtype.itemsize
                assert part <= call / 12 * (2 / dtype.itemsize) + 1e-9
            # ranks raised past the row's need only while under the fill
            assert bplan.clusters * (bplan.ranks - 1) < tln.WIDE_FILL


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("hidden", LN_WIDE_HIDDEN)
def test_wide_sum_order_never_reads_the_card(hidden, dtype):
    """The backward's plan takes no SM count; the forward's row shape (the
    order of a row's sums) is the same for every SM count, only the number
    of clusters walking the rows follows the card."""
    assert "sms" not in inspect.signature(tln._wide_bwd_plan).parameters
    for rows in (1, 8, 2048):
        shapes = {tln._wide_fwd_plan(rows, hidden, dtype, sms)[:3]
                  for sms in (132, 114, 78, 16)}
        assert len(shapes) == 1


def test_wide_plans_at_the_legs_shapes():
    """The train leg's 2048 x 8192 in bf16: the forward a row a CTA of 16
    warps; the backward 64 partial rows of 32 rows over clusters of 2;
    65536: clusters of 8; a decode step's 16 rows spread over 8 ranks."""
    bf16 = torch.bfloat16
    assert tln._wide_fwd_plan(2048, 8192, bf16, 132)[:4] == (2, 16, 1, 132)
    assert tln._wide_bwd_plan(2048, 8192, bf16)[:4] == (2, 8, 2, 64)
    assert tln._wide_fwd_plan(2048, 65536, bf16, 132)[:3] == (2, 16, 8)
    assert tln._wide_fwd_plan(16, 8192, bf16, 132)[:3] == (2, 2, 8)
    assert tln._wide_bwd_plan(2048, 65536, torch.float32)[:3] == (4, 16, 8)


@pytest.mark.parametrize("hidden,wide", [(4096, False), (4097, True),
                                         (8192, True)])
def test_kernel_dispatch_by_width(hidden, wide, monkeypatch):
    """With the kernel route forced on CPU tensors (counting fakes over the
    plain versions in place of the four wrappers), the autograd core sends
    rows past ROW_MAX_HIDDEN to the wide wrappers and the others to the
    register kernels' wrappers."""
    calls = []

    def fake(name, plain):
        def run(*args, **kw):
            calls.append(name)
            return plain(*args[:5]) if name.endswith("fwd") else \
                plain(*args[:6])
        return run

    monkeypatch.setattr(tln, "ln_fwd_cuda", fake("fwd", tln._torch_fwd))
    monkeypatch.setattr(tln, "ln_bwd_cuda", fake("bwd", tln._torch_bwd))
    monkeypatch.setattr(tln, "ln_fwd_wide_cuda",
                        fake("wide_fwd", tln._torch_fwd))
    monkeypatch.setattr(tln, "ln_bwd_wide_cuda",
                        fake("wide_bwd", tln._torch_bwd))
    monkeypatch.setattr(tln._backend, "use_kernel",
                        lambda x, impl="auto": impl != "torch")
    x, w, b, dy = _inputs(2, hidden, seed=1)
    tx = torch.tensor(x, requires_grad=True)
    y = tln.fused_layer_norm(tx, torch.tensor(w), torch.tensor(b))
    y.backward(torch.tensor(dy))
    want = ["wide_fwd", "wide_bwd"] if wide else ["fwd", "bwd"]
    assert calls == want
    assert tln.KERNEL_MAX_HIDDEN == 65536 and tln.ROW_MAX_HIDDEN == 4096
