"""Port parity for the scaled masked softmax: apex_tpu_torch's
``scaled_masked_softmax``, ``scaled_upper_triang_masked_softmax``, their
plain versions and ``FusedScaleMaskSoftmax`` against apex_tpu's on the
same seeded inputs.

The reference runs with its Pallas ``softmax_fwd``/``softmax_bwd`` in
interpret mode (``APEX_TPU_PALLAS=interpret``; its kernel takes sk % 128
== 0, so sk 114 takes its XLA path there too) and on its XLA path
(``=0``); the port runs its plain versions (CPU tensors). fp32 on both
sides. Tolerances: probabilities within 1e-5 relative and absolute; the
gradient within 2e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import softmax as jsm
from apex_tpu.ops.pallas import softmax as jk
from apex_tpu.transformer.enums import AttnMaskType as JMaskType
from apex_tpu.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax as JFused)
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.transformer import enums
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4
SCALE = 0.125


def _close_grad(got, want, what="dx"):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_RTOL * scale, err_msg=what)


def _scores(shape, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) * 4).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _mask(kind, b, sq, sk, seed):
    """True = masked: None, a (b, 1, 1, sk) key-padding mask, or a
    (b, 1, sq, sk) mask with random holes; every non-None kind has one
    fully masked row."""
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "key":
        lens = np.array([sk * 3 // 4, 0][:b] + [sk] * max(0, b - 2))
        return (np.arange(sk)[None, :] >= lens[:, None])[:, None, None, :]
    m = rng.random((b, 1, sq, sk)) < 0.3
    m[0, 0, 1] = True
    return m


def _run_both(jfn, tfn, x, dy):
    y_j, vjp = jax.vjp(jfn, jnp.asarray(x))
    g_j = vjp(jnp.asarray(dy))[0]
    tx = torch.tensor(x, requires_grad=True)
    y = tfn(tx)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL)
    y.backward(torch.tensor(dy))
    _close_grad(tx.grad.numpy(), g_j)
    return y.detach().numpy()


@pytest.mark.parametrize("pallas", ["interpret", "0"])
@pytest.mark.parametrize("b,h,sq,sk,kind", [
    pytest.param(2, 3, 16, 128, "key", id="key-mask"),
    pytest.param(2, 3, 16, 128, "full", id="full-mask"),
    pytest.param(2, 2, 8, 128, None, id="no-mask"),
    pytest.param(2, 3, 16, 114, "key", id="key-mask-sk114"),
    pytest.param(3, 2, 114, 114, "full", id="full-mask-sk114"),
])
def test_scaled_masked_softmax_matches_reference(pallas, b, h, sq, sk, kind,
                                                 monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    x, dy = _scores((b, h, sq, sk), seed=sq + sk)
    m = _mask(kind, b, sq, sk, seed=b)
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.tensor(m)
    y = _run_both(lambda a: jsm.scaled_masked_softmax(a, jm, SCALE),
                  lambda a: tsm.scaled_masked_softmax(a, tm, SCALE), x, dy)
    if kind == "key":  # batch row 1 has length 0: every key masked
        np.testing.assert_allclose(y[1], 1.0 / sk, rtol=1e-6)
    if kind == "full":
        np.testing.assert_allclose(y[0, :, 1], 1.0 / sk, rtol=1e-6)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
@pytest.mark.parametrize("shape", [(6, 128, 128), (2, 3, 114, 114),
                                   (4, 64, 128)])
def test_scaled_upper_triang_masked_softmax_matches_reference(
        pallas, shape, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    x, dy = _scores(shape, seed=shape[-1])
    _run_both(lambda a: jsm.scaled_upper_triang_masked_softmax(a, SCALE),
              lambda a: tsm.scaled_upper_triang_masked_softmax(a, SCALE),
              x, dy)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_match_the_pallas_kernels(causal):
    """``_torch_fwd``/``_torch_bwd`` against the Pallas kernels in
    interpret mode and the reference's ``_xla_fwd`` on (rows, sk) with a
    materialised mask (a fully masked row included); the port's take the
    same rows as (2, sq, sk)."""
    sq, sk = 64, 256
    x, dy = _scores((2 * sq, sk), seed=5)
    m = np.random.default_rng(6).random((2 * sq, sk)) < 0.4
    m[3] = True
    mask = None if causal else m
    y = tsm._torch_fwd(torch.tensor(x).reshape(2, sq, sk),
                       None if causal else torch.tensor(m).reshape(2, sq, sk),
                       SCALE, causal).reshape(-1, sk)
    dx = tsm._torch_bwd(torch.tensor(dy), y, SCALE)
    jmask = None if causal else jnp.asarray(mask.astype(np.int8))
    for yj in (jk.softmax_fwd(jnp.asarray(x), jmask, scale=SCALE,
                              causal=causal, sq=sq, interpret=True),
               jsm._xla_fwd(jnp.asarray(x), jmask, SCALE, causal, sq)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **OUT_TOL)
    dxj = jk.softmax_bwd(jnp.asarray(dy), jnp.asarray(y.numpy()),
                         scale=SCALE, interpret=True)
    _close_grad(dx.numpy(), dxj)
    if not causal:
        np.testing.assert_allclose(y[3].numpy(), 1.0 / sk, rtol=1e-6)


def _fused_pair(mask_type, fusion, scale, jfunc, tfunc):
    kw = dict(input_in_fp16=False, input_in_bf16=True,
              scaled_masked_softmax_fusion=fusion, softmax_in_fp32=True,
              scale=scale)
    return (JFused(attn_mask_type=getattr(JMaskType, mask_type),
                   mask_func=jfunc, **kw),
            FusedScaleMaskSoftmax(
                attn_mask_type=getattr(enums.AttnMaskType, mask_type),
                mask_func=tfunc, **kw))


@pytest.mark.parametrize("pallas", ["interpret", "0"])
@pytest.mark.parametrize("mask_type,sk,fusion,use_mask_func,kernel", [
    pytest.param("padding", 128, True, False, True, id="padding-fused"),
    pytest.param("causal", 128, True, False, True, id="causal-fused"),
    pytest.param("padding", 114, True, False, False, id="padding-sk114"),
    pytest.param("padding", 128, False, True, False, id="padding-mask-func"),
    pytest.param("causal", 114, True, False, False, id="causal-sk114"),
])
def test_fused_scale_mask_softmax_both_routes_match_reference(
        pallas, mask_type, sk, fusion, use_mask_func, kernel, monkeypatch):
    """``is_kernel_available`` (kept verbatim, ``sk % 128`` included)
    picks the same route on both sides, and each route (-10000 fill on
    the fused one, -1e30 or ``mask_func`` on the other) matches; a fully
    masked row comes out uniform on both."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    b, h, sq = 2, 2, sk
    x, dy = _scores((b, h, sq, sk), seed=sk)
    m = None if mask_type == "causal" else _mask("key", b, sq, sk, seed=1)

    def jfunc(s, mm):
        return jnp.where(mm, -50.0, s)

    def tfunc(s, mm):
        return torch.where(mm, -50.0, s)

    jmod, tmod = _fused_pair(mask_type, fusion, 0.5,
                             jfunc if use_mask_func else None,
                             tfunc if use_mask_func else None)
    assert isinstance(tmod, torch.nn.Module)
    shape = (b, h, sq, sk)
    assert tmod.is_kernel_available(m, *shape) == kernel
    assert jmod.is_kernel_available(m, *shape) == kernel
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.tensor(m)
    y = _run_both(lambda a: jmod(a, jm), lambda a: tmod(a, tm), x, dy)
    if m is not None and not use_mask_func:
        # the fully masked batch row: uniform over all keys either way
        np.testing.assert_allclose(y[1], 1.0 / sk, rtol=1e-6)


def test_fused_scale_mask_softmax_argument_checks():
    kw = dict(attn_mask_type=enums.AttnMaskType.padding,
              scaled_masked_softmax_fusion=True, mask_func=None)
    with pytest.raises(RuntimeError, match="fp16 and bf16"):
        FusedScaleMaskSoftmax(True, True, softmax_in_fp32=True, scale=None,
                              **kw)
    with pytest.raises(RuntimeError, match="fp32 when scaled"):
        FusedScaleMaskSoftmax(False, True, softmax_in_fp32=False, scale=2.0,
                              **kw)
    with pytest.raises(ValueError, match="attn_mask_type"):
        FusedScaleMaskSoftmax(False, True, attn_mask_type=None,
                              scaled_masked_softmax_fusion=True,
                              mask_func=None, softmax_in_fp32=True,
                              scale=None)


def test_enums_match_the_reference():
    from apex_tpu.transformer import enums as jenums

    for name in ("ModelType", "LayerType", "AttnType", "AttnMaskType"):
        assert ({m.name: m.value for m in getattr(enums, name)}
                == {m.name: m.value for m in getattr(jenums, name)})


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_impl():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tsm.softmax_fwd_cuda(x, None, 1.0, True)
    with pytest.raises(ValueError, match="CUDA"):
        tsm.softmax_bwd_cuda(x, x, 1.0)
    with pytest.raises(ValueError, match="impl"):
        tsm.scaled_masked_softmax(x, None, impl="pallas")
    assert tsm.MASK_FILL == jk.MASK_FILL


@pytest.mark.parametrize("xshape,mshape", [
    ((2, 3, 5, 7), (2, 1, 1, 7)), ((2, 3, 5, 7), (1, 1, 5, 7)),
    ((2, 3, 5, 7), (2, 3, 5, 7)), ((6, 5, 7), (5, 7)), ((5, 7), (7,)),
    ((2, 2, 3, 4, 7), (2, 1, 1, 7)), ((3, 5, 7), (3, 1, 7))])
def test_mask_view_addresses_every_row_as_the_kernel_does(xshape, mshape):
    """The CUDA kernel reads mask element (r, k) of x's row r at
    ``base + (r // (h·q))·s_b + (r // q % h)·s_h + (r % q)·s_q + k·s_k``
    from ``mask_view``'s strides (no materialised copy where x has four
    dimensions or fewer): that address gives the broadcast mask's value
    at every row and key."""
    rng = np.random.default_rng(len(xshape) + len(mshape))
    mask = torch.tensor(rng.random(mshape) < 0.5)
    v = tsm.mask_view(mask, xshape)
    assert v.ndim == 4
    if len(xshape) <= 4:
        assert v.data_ptr() == mask.data_ptr()  # a view, no copy
    sk = xshape[-1]
    want = torch.broadcast_to(mask, xshape).reshape(-1, sk)
    _, h, q, _ = v.shape
    sb, sh, sq_, sk_ = v.stride()  # bytes: one byte an element
    store = torch.tensor(list(bytes(v.untyped_storage())), dtype=torch.uint8)
    for r in range(want.shape[0]):
        start = (v.storage_offset() + (r // (h * q)) * sb
                 + (r // q % h) * sh + (r % q) * sq_)
        got = store[[start + k * sk_ for k in range(sk)]].bool()
        assert torch.equal(got, want[r]), r
