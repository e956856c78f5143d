"""The layer-norm forward's host-side launch plan and its arithmetic, on the
CPU: what ``apex_tpu_torch/ops/layer_norm.py`` decides before it launches
``csrc/layer_norm.cu``'s ``ln_fwd_kernel``, and the kernel's sums emulated.

* ``_fwd_plan`` at the legs' shapes (1, 8, 16 and 256 rows: the serve and
  decode legs' steps and a prefill chunk; 8192-65536: the decode prefill
  and the train legs) × hidden 768, 1024 and 4096, bf16 and fp32: the row
  shape (16-byte chunks a thread, W warps a row, the backward's), at most
  16 warps a CTA, a named barrier for each group, one row a group and the
  rows over as many SMs as there are rows where they fit, full resident
  CTAs walking their rows otherwise, shared memory within a CTA's 227 KB;
  the walk covers every row once.
* A plain fp32 emulation of the kernel's statistics — thread j of a row's
  group sums its chunks j, j + 32W, ... in order, the warp by an xor
  butterfly, the group's warps in warp order; the mean, then the mean of
  (x - mean)^2 (fused multiply-adds); rsqrt — held against the JAX
  reference's ``ln_fwd`` in interpret mode within 1e-5 (relative and
  absolute: fp32 sums in another order), for LayerNorm and RMSNorm and
  each affine form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import layer_norm as jk
from apex_tpu_torch.ops import layer_norm as LN

H100_SMS = 132
SMEM_PER_CTA = 232448
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = (1, 8, 16, 256, 8192, 14592, 16384, 20480, 65536)


def _vec(dtype):
    return 8 if dtype == torch.bfloat16 else 4


# --- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hidden", [768, 1024, 4096])
@pytest.mark.parametrize("rows", ROWS)
def test_plan_at_the_legs_shapes(rows, hidden, dtype):
    plan = LN._fwd_plan(rows, hidden, dtype, H100_SMS)
    c, w = plan.chunks, plan.warps
    assert (c, w) == LN.row_shape(hidden, dtype)
    assert w in (1, 2, 3, 4, 6, 8) and c in (1, 2, 4)
    assert c * _vec(dtype) <= 16, "at most 16 elements a thread"
    # the row's chunks covered, no warp idle
    assert 32 * w * c * _vec(dtype) >= hidden
    assert 32 * (w - 1) * c * _vec(dtype) < hidden
    # the CTA: at most its warps, a named barrier (1-15) for each group
    assert plan.groups * w <= LN.FWD_CTA_WARPS[c]
    assert w == 1 or plan.groups <= 15
    assert plan.depth == LN.FWD_DEPTH[c]
    assert plan.smem == plan.groups * 2 * w * 4 <= SMEM_PER_CTA
    resident = H100_SMS * max(1, LN.FWD_SM_WARPS[c] // (plan.groups * w))
    assert 1 <= plan.ctas <= resident
    if rows <= H100_SMS:  # few rows: one row a CTA, on as many SMs
        assert (plan.groups, plan.ctas) == (1, rows)
    # every group has a row, or the grid is the card's resident CTAs
    assert plan.ctas * plan.groups >= rows or plan.ctas == resident


@pytest.mark.parametrize("rows,hidden,dtype,want", [
    (16, 1024, torch.bfloat16, (1, 4, 1, 2, 16)),     # decode step
    (8, 1024, torch.bfloat16, (1, 4, 1, 2, 8)),       # serve step
    (256, 1024, torch.bfloat16, (1, 4, 2, 2, 128)),   # prefill chunk
    (20480, 1024, torch.bfloat16, (1, 4, 4, 2, 264)),  # GPT train
    (65536, 768, torch.bfloat16, (1, 3, 5, 2, 264)),   # T5 encoder
    (16, 4096, torch.bfloat16, (2, 8, 1, 2, 16)),
    (20480, 4096, torch.float32, (4, 8, 1, 1, 264)),
])
def test_plan_takes_each_shape(rows, hidden, dtype, want):
    plan = LN._fwd_plan(rows, hidden, dtype, H100_SMS)
    assert (plan.chunks, plan.warps, plan.groups, plan.depth,
            plan.ctas) == want


@pytest.mark.parametrize("rows,sms", [(1, 132), (37, 4), (3001, 132),
                                      (20480, 132), (40, 2)])
def test_walk_covers_every_row_once(rows, sms):
    """Group g of CTA c takes rows c * groups + g, then every
    (ctas * groups)-th after it."""
    plan = LN._fwd_plan(rows, 1024, torch.bfloat16, sms)
    step = plan.ctas * plan.groups
    seen = [first + it * step for first in range(step)
            for it in range(-(-(rows - first) // step) if first < rows
                            else 0)]
    assert sorted(seen) == list(range(rows))


def test_plan_refuses_other_dtypes():
    """float64 has no kernel; fp16 (amp's strict-fp16 step) takes bf16's
    plan: the same 2-byte chunks."""
    with pytest.raises(ValueError, match="no forward kernel"):
        LN._fwd_plan(16, 1024, torch.float64, H100_SMS)
    for rows, hidden in ((16, 1024), (16384, 1024), (5, 768)):
        assert LN._fwd_plan(rows, hidden, torch.float16, H100_SMS) == \
            LN._fwd_plan(rows, hidden, torch.bfloat16, H100_SMS)


# --- the kernel's arithmetic, emulated -----------------------------------------

def _butterfly(lanes):
    """The xor butterfly of apex::warp_sum over one warp's 32 fp32 values:
    every lane ends with the same total."""
    v = lanes.copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    assert (v == v[0]).all()
    return v[0]


def _group_total(per_thread, warps):
    """Warp sums by the butterfly, then the warps in warp order."""
    t = np.float32(0)
    for wi in range(warps):
        t = np.float32(t + _butterfly(per_thread[32 * wi:32 * wi + 32]))
    return t


def _emulate(x, w, b, eps, rms, plan, vec):
    """The kernel's y, mean and rstd of fp32 rows x on ``plan``'s shape."""
    rows, n = x.shape
    G = 32 * plan.warps
    E = plan.chunks * vec
    idx = np.array([[(j + G * c) * vec + k for c in range(plan.chunks)
                     for k in range(vec)] for j in range(G)])  # (G, E)
    live = idx < n
    y = np.zeros_like(x)
    mean = np.zeros(rows, np.float32)
    rstd = np.zeros(rows, np.float32)
    nf = np.float32(n)
    for r in range(rows):
        v = np.where(live, x[r][np.minimum(idx, n - 1)], 0).astype(
            np.float32)
        mu = np.float32(0)
        if not rms:
            t = np.zeros(G, np.float32)
            for e in range(E):
                t = (t + v[:, e]).astype(np.float32)
            mu = np.float32(_group_total(t, plan.warps) / nf)
        v = np.where(live, v - mu, 0).astype(np.float32)
        ss = np.zeros(G, np.float32)
        for e in range(E):  # fmaf(v, v, ss)
            ss = (v[:, e].astype(np.float64) ** 2 + ss).astype(np.float32)
        var = np.float32(_group_total(ss, plan.warps) / nf)
        rs = np.float32(1.0 / np.sqrt(np.float64(np.float32(var + eps))))
        o = (v * rs).astype(np.float32)
        if w is not None:
            o = (o * w[np.minimum(idx, n - 1)]).astype(np.float32)
        if b is not None:
            o = (o + b[np.minimum(idx, n - 1)]).astype(np.float32)
        y[r][idx[live]] = o[live]
        mean[r], rstd[r] = mu, rs
    return y, mean, rstd


@pytest.mark.parametrize("rows,hidden,sms", [(5, 1024, 132), (40, 768, 2),
                                             (3, 256, 132)])
@pytest.mark.parametrize("rms,affine", [(False, "wb"), (False, "w"),
                                        (False, ""), (True, "w"),
                                        (True, "")])
def test_emulated_split_sums_match_reference(rows, hidden, sms, rms,
                                             affine):
    rng = np.random.default_rng(rows + hidden)
    x = (rng.standard_normal((rows, hidden)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(hidden)).astype(np.float32)
    b = (0.2 * rng.standard_normal(hidden)).astype(np.float32)
    w = w if "w" in affine else None
    b = b if "b" in affine else None
    plan = LN._fwd_plan(rows, hidden, torch.float32, sms)
    y, mean, rstd = _emulate(x, w, b, 1e-5, rms, plan, 4)
    jy, jm, jr = jk.ln_fwd(jnp.asarray(x),
                           None if w is None else jnp.asarray(w),
                           None if b is None else jnp.asarray(b), eps=1e-5,
                           rms=rms, interpret=True)
    np.testing.assert_allclose(y, np.asarray(jy), **TOL)
    np.testing.assert_allclose(mean, np.asarray(jm)[:, 0], **TOL)
    np.testing.assert_allclose(rstd, np.asarray(jr)[:, 0], **TOL)
    # and the port's plain version, which the card's kernel is held to
    py, pm, pr = LN._torch_fwd(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), 1e-5, rms)
    np.testing.assert_allclose(y, py.numpy(), **TOL)
    np.testing.assert_allclose(rstd, pr.numpy()[:, 0], **TOL)


def test_emulated_bf16_shape_matches_reference():
    """The bf16 row shape (8 elements a chunk, 4 warps at 1024) on
    bf16-valued inputs, against the reference on the same values."""
    rng = np.random.default_rng(3)
    xb = torch.from_numpy((rng.standard_normal((6, 1024)) * 2).astype(
        np.float32)).bfloat16()
    x = xb.float().numpy()
    w = (1 + 0.3 * rng.standard_normal(1024)).astype(np.float32)
    plan = LN._fwd_plan(6, 1024, torch.bfloat16, H100_SMS)
    assert (plan.chunks, plan.warps) == (1, 4)
    y, mean, rstd = _emulate(x, w, None, 1e-5, False, plan, 8)
    jy, jm, jr = jk.ln_fwd(jnp.asarray(x), jnp.asarray(w), None, eps=1e-5,
                           rms=False, interpret=True)
    np.testing.assert_allclose(y, np.asarray(jy), **TOL)
    np.testing.assert_allclose(mean, np.asarray(jm)[:, 0], **TOL)
    np.testing.assert_allclose(rstd, np.asarray(jr)[:, 0], **TOL)
