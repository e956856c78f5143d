"""Port parity for batch norm: ``apex_tpu_torch.parallel.sync_batchnorm``
against ``apex_tpu.parallel.sync_batchnorm`` (``axis_name=None``: one
process) on the same seeded numpy inputs.

* y within 1e-5 of the largest entry, the new running statistics within
  1e-5, ``num_batches_tracked`` counted; the gradients of x, scale, bias
  and the residual within 2e-4 of each one's largest entry: plain, with
  the residual, with the ReLU, both, without the affine, in eval;
* the output dtype of O2 (x's) and O3 (the compute dtype) against the
  reference's, values within one bf16 ulp of the largest entry;
* the knobs that need a process group raise ``TypeError`` naming the
  ROADMAP item;
* ``_bn_plan`` at every batch-norm call of ResNet-50 at batch 256, and a
  numpy emulation of the kernels' chunked Welford sums in their order
  against the fp64 statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.parallel.sync_batchnorm import BatchNormState as JState
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JSyncBN
from apex_tpu.parallel.sync_batchnorm import sync_batch_norm as j_bn
from apex_tpu_torch import amp
from apex_tpu_torch.contrib.bottleneck import Bottleneck
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.models.convert import bn_state_from_jax
from apex_tpu_torch.models.resnet import ResNet50, ResNetConfig
from apex_tpu_torch.ops import batch_norm as B
from apex_tpu_torch.parallel import BatchNormState, SyncBatchNorm
from apex_tpu_torch.parallel import sync_batch_norm

OUT_TOL = 1e-5
GRAD_TOL = 2e-4
SHAPE = (4, 6, 5, 16)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 2.0, C)
         + rng.uniform(-2, 2, C)).astype(np.float32)
    return (x, rng.uniform(0.5, 1.5, C).astype(np.float32),
            (rng.standard_normal(C) * 0.2).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal(C) * 0.3).astype(np.float32),
            rng.uniform(0.5, 2.0, C).astype(np.float32))


CASES = [
    pytest.param(dict(), id="plain"),
    pytest.param(dict(residual=True), id="residual"),
    pytest.param(dict(relu=True), id="relu"),
    pytest.param(dict(residual=True, relu=True), id="residual-relu"),
    pytest.param(dict(affine=False), id="no-affine"),
    pytest.param(dict(training=False, relu=True, residual=True),
                 id="eval-residual-relu"),
    pytest.param(dict(training=False), id="eval"),
]


@pytest.mark.parametrize("kw", CASES)
def test_sync_batch_norm_matches_reference(kw):
    training = kw.get("training", True)
    x, scale, bias, res, dy, rm, rv = _inputs(len(kw) + 3 * training)
    affine = kw.get("affine", True)
    use_res = kw.get("residual", False)
    relu = kw.get("relu", False)
    jstate = JState(jnp.asarray(rm), jnp.asarray(rv), jnp.asarray(3))

    def ref(x, scale, bias, res):
        y, st = j_bn(x, scale if affine else None, bias if affine else None,
                     jstate, training=training, momentum=0.2, eps=1e-3,
                     axis_name=None, fuse_relu=relu,
                     residual=res if use_res else None)
        return jnp.sum(y * dy), (y, st)

    (_, (y_r, st_r)), g_r = jax.value_and_grad(
        ref, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
            jnp.asarray(res))

    t = {k: torch.tensor(v, requires_grad=True) for k, v in
         (("x", x), ("scale", scale), ("bias", bias), ("res", res))}
    state = bn_state_from_jax(jstate, device="cpu")
    y, st = sync_batch_norm(t["x"], t["scale"] if affine else None,
                            t["bias"] if affine else None, state,
                            training=training, momentum=0.2, eps=1e-3,
                            fuse_relu=relu,
                            residual=t["res"] if use_res else None)
    (y * torch.tensor(dy)).sum().backward()
    _close(y.detach(), y_r, OUT_TOL, "y")
    for name, st_t, st_j in (("mean", st.running_mean, st_r.running_mean),
                             ("var", st.running_var, st_r.running_var)):
        _close(st_t, st_j, OUT_TOL, name)
    assert int(st.num_batches_tracked) == int(st_r.num_batches_tracked)
    assert int(st.num_batches_tracked) == 3 + training
    if not training:
        assert st is state
    names = ["x"] + (["scale", "bias"] if affine else []) + (
        ["res"] if use_res else [])
    idx = {"x": 0, "scale": 1, "bias": 2, "res": 3}
    for name in names:
        _close(t[name].grad, g_r[idx[name]], GRAD_TOL, name)


@pytest.mark.parametrize("level", ["O2", "O3"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_output_dtype_follows_the_policy(level, x_dtype):
    x, scale, bias, *_ = _inputs(7)
    jx = jnp.asarray(x).astype(jnp.dtype(x_dtype))
    with jamp.with_policy(jamp.get_policy(level)):
        y_r, _ = j_bn(jx, jnp.asarray(scale), jnp.asarray(bias),
                      JState.create(SHAPE[-1]), axis_name=None)
    tx = torch.tensor(x).to(getattr(torch, x_dtype))
    with amp.with_policy(amp.get_policy(level)):
        y, _ = sync_batch_norm(tx, torch.tensor(scale), torch.tensor(bias),
                               BatchNormState.create(SHAPE[-1], device="cpu"))
    assert str(y.dtype).split(".")[-1] == str(y_r.dtype)
    want = tx.dtype if level == "O2" else torch.bfloat16
    assert y.dtype == want
    _close(y.float(), np.asarray(y_r.astype(jnp.float32)), 2 ** -7, level)


def test_module_surfaces_match_reference():
    x, _, _, res, *_ = _inputs(11)
    jm = JSyncBN(SHAPE[-1], momentum=0.3, axis_name=None, fuse_relu=True)
    jp, js = jm.init()
    y_r, st_r = jm(jp, js, jnp.asarray(x), residual=jnp.asarray(res))
    for mod in (SyncBatchNorm(SHAPE[-1], momentum=0.3, fuse_relu=True),
                BatchNorm2d_NHWC(SHAPE[-1], fuse_relu=True, momentum=0.3)):
        p, s = mod.init(device="cpu")
        assert set(p) == {"scale", "bias"}
        y, st = mod(p, s, torch.tensor(x), residual=torch.tensor(res))
        _close(y, y_r, OUT_TOL, type(mod).__name__)
        _close(st.running_var, st_r.running_var, OUT_TOL)
    p, _ = SyncBatchNorm(8, affine=False).init(device="cpu")
    assert p == {}


def test_process_group_knobs_refuse():
    x = torch.zeros((4, 3))
    st = BatchNormState.create(3, device="cpu")
    with pytest.raises(TypeError, match="item 6"):
        sync_batch_norm(x, None, None, st, process_group=object())
    with pytest.raises(TypeError, match="item 6"):
        sync_batch_norm(x, None, None, st, process_group_size=2)
    with pytest.raises(TypeError, match="item 6"):
        SyncBatchNorm(3, process_group=object())
    with pytest.raises(TypeError, match="item 6"):
        BatchNorm2d_NHWC(3, bn_group=2)
    with pytest.raises(TypeError, match="item 6"):
        ResNetConfig(bn_axis="dp")
    blk = Bottleneck(8, 4, 8)
    p, s = blk.init(torch.Generator(), device="cpu")
    with pytest.raises(TypeError, match="item 6"):
        blk(p, s, torch.zeros((1, 4, 4, 8)), spatial_axis="cp")


def resnet50_bn_calls():
    """(rows, channels, residual, relu) of every batch norm of ResNet-50 at
    batch 256 on 224² images."""
    return [c[:4] for c in ResNet50(ResNetConfig()).bn_calls(256, 224)]


def test_resnet50_bn_calls():
    calls = resnet50_bn_calls()
    assert len(calls) == 53
    assert sum(r and u for _, _, r, u in calls) == 16
    assert sum(u and not r for _, _, r, u in calls) == 33
    assert sum(not r and not u for _, _, r, u in calls) == 4
    assert len(set(calls)) == 16
    assert calls[0] == (3_211_264, 64, False, True)
    assert calls[-1] == (12_544, 2048, True, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_bn_plan_at_resnet50_shapes(dtype):
    for M, C, _, _ in set(resnet50_bn_calls()):
        plan = B._bn_plan(M, C, dtype)
        assert plan == B._bn_plan(M, C, dtype)  # a function of its inputs
        natural = 16 // torch.empty((), dtype=dtype).element_size()
        assert plan.vec == natural  # every ResNet width takes 16 bytes
        assert plan.tx * plan.ty <= B.CTA_THREADS and plan.tx <= 32
        assert plan.vec <= plan.ty  # the in-CTA combine has a thread a column
        assert plan.col_blocks * plan.tx * plan.vec >= C
        assert (plan.col_blocks - 1) * plan.tx * plan.vec < C
        assert plan.rows_per_chunk % plan.ty == 0
        assert plan.chunks * plan.rows_per_chunk >= M
        assert (plan.chunks - 1) * plan.rows_per_chunk < M
        assert plan.chunks * plan.col_blocks <= 2 * B.TARGET_CTAS
        assert 1 <= plan.apply_ctas <= 65535
        # the fault plant needs a last chunk to leave out
        assert plan.chunks >= 2
    unaligned = B._bn_plan(1000, 13, torch.bfloat16)
    assert unaligned.vec == 1
    assert B._bn_plan(4096, 64, torch.bfloat16, aligned=False).vec == 1


def _emulate_stats(x, plan):
    """The kernels' statistics in their order: each thread row's Welford
    over every ty-th row of its chunk (fp32), Chan's combine of the ty
    rows in order (fp32), then the chunks' two fp64 sums in the final
    kernel's group order."""
    M, C = x.shape
    f32 = np.float32
    means, m2s, counts = [], [], []
    for k in range(plan.chunks):
        r0 = k * plan.rows_per_chunk
        r1 = min(M, r0 + plan.rows_per_chunk)
        cn, cm, cm2 = f32(0), np.zeros(C, f32), np.zeros(C, f32)
        for j in range(plan.ty):
            rows = x[r0 + j:r1:plan.ty]
            if len(rows) == 0:
                break
            mean, m2 = np.zeros(C, f32), np.zeros(C, f32)
            for n, row in enumerate(rows, 1):
                d = row - mean
                mean = mean + d * (f32(1) / f32(n))
                m2 = m2 + d * (row - mean)
            fb = f32(len(rows))
            nn = cn + fb
            d = mean - cm
            cm = cm + d * (fb / nn)
            cm2 = cm2 + m2 + d * d * (cn * fb / nn)
            cn = nn
        means.append(cm)
        m2s.append(cm2)
        counts.append(r1 - r0)
    groups = 8
    s = [sum(np.float64(counts[k]) * means[k].astype(np.float64)
             for k in range(g, plan.chunks, groups)) for g in range(groups)]
    mu = sum(s) / M
    q = [sum(m2s[k].astype(np.float64) + counts[k]
             * (means[k].astype(np.float64) - mu) ** 2
             for k in range(g, plan.chunks, groups)) for g in range(groups)]
    return mu, sum(q) / M


@pytest.mark.parametrize("M,C", [(3000, 16), (997, 24), (64, 40)])
def test_kernel_sum_order_emulation_matches_fp64(M, C):
    rng = np.random.default_rng(M)
    x = (rng.standard_normal((M, C)) * 3 + 100).astype(np.float32)
    plan = B._bn_plan(M, C, torch.float32)
    mu, var = _emulate_stats(x, plan)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mu, x64.mean(0), rtol=1e-6)
    # the centred moment: no E[x²] − E[x]² cancellation at a mean of 100
    np.testing.assert_allclose(var, x64.var(0), rtol=1e-5)


def test_batch_norm_core_refuses_cpu_tensors():
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        B.bn_fwd_cuda(x, None, None, training=True)
    with pytest.raises(ValueError, match="CUDA"):
        B.bn_bwd_cuda(x, x, None, torch.zeros((5, 4)), training=True)
