"""Port parity: apex_tpu_torch's seq-major ``flash_attention(layout="bshd")``
backward with per-batch ``kv_lens``, and the additive array ``bias`` of both
layouts, against apex_tpu's, on the same inputs.

The reference runs its Pallas kernels in interpret mode (``flash_fwd_bshd``
and ``flash_bwd_bshd``, the bh-flat ``flash_fwd``/``flash_bwd`` and the
``_dbias_pallas`` bias gradient) and its XLA composition; the port runs its
plain versions (CPU tensors). The reference's ``auto`` gate sends the bshd
layout at head_dim 64 with more than one head to its XLA path (a TPU
128-lane rule, ``bshd_kernel_ok``), so there the kernels are reached
through ``_flash_core_bshd`` with ``use_pallas=True``, as the gate would
on a shape it takes. fp32, full-precision matmuls on both sides.
Tolerances: the output within 1e-5 (relative and absolute), every
gradient — dq, dk, dv and dbias — within 2e-4 of its largest entry (fp32
sums in another order; dbias sums b·h / hb rows per entry); a bf16 bias's
cotangent in bf16 on both sides, within 1e-2 of its largest entry (one
bf16 rounding of sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import _flash_core_bshd, bshd_kernel_ok
from apex_tpu.ops.attention import flash_attention as jflash
from apex_tpu_torch.ops import attention as amod

torch.backends.cuda.matmul.allow_tf32 = False

O_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4
BF16_RTOL = 1e-2


def _case(layout, b, h, h_kv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if layout == "bshd":
        return (f(b, sq, h, d), f(b, sk, h_kv, d), f(b, sk, h_kv, d),
                f(b, sq, h, d))
    return f(b, h, sq, d), f(b, h_kv, sk, d), f(b, h_kv, sk, d), f(b, h, sq, d)


def _reference(q, k, v, do, bias, lens, *, causal, layout, mode):
    """(o, dq, dk, dv, dbias) from apex_tpu, its kernels in interpret mode
    (``mode="pallas"``) or its XLA composition (``"xla"``)."""
    d = q.shape[-1]
    direct = (layout == "bshd" and mode == "pallas" and not bshd_kernel_ok(
        q.shape[1], k.shape[1], q.shape[2], d, jnp.float32))

    def f(q, k, v, bias):
        if direct:
            lj = None if lens is None else jnp.asarray(lens, jnp.int32)
            return _flash_core_bshd(q, k, v, bias, lj, None, d ** -0.5,
                                    causal, True, 0.0)
        return jflash(q, k, v, causal=causal, layout=layout, impl=mode,
                      kv_lens=None if lens is None else jnp.asarray(lens),
                      bias=bias)

    @jax.jit
    def fwd_bwd(q, k, v, bias, do):
        o, vjp = jax.vjp(f, q, k, v, bias)
        return (o, *vjp(do))

    with jax.default_matmul_precision("highest"):
        out = fwd_bwd(*(jnp.asarray(a) for a in (q, k, v)),
                      None if bias is None else jnp.asarray(bias),
                      jnp.asarray(do))
    return list(out)


def _port(q, k, v, do, bias, lens, *, causal, layout):
    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    o = amod.flash_attention(*args, causal=causal, layout=layout, bias=tb,
                             kv_lens=None if lens is None
                             else torch.tensor(lens))
    o.backward(torch.tensor(do))
    return [o.detach()] + [t.grad for t in args] + [
        None if tb is None else tb.grad]


def _assert_match(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               err_msg="o", **O_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got[1:], want[1:]):
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal,lens", [
    # BERT's case: per-batch padding with a row of length 0 and a full row
    pytest.param(3, 4, 4, 128, 128, 64, False, [0, 128, 77], id="pad-d64"),
    # grouped kv heads, causal, d 128
    pytest.param(2, 4, 2, 128, 128, 128, True, [128, 50], id="gqa-d128"),
    # sq < sk with bottom-right causal alignment, one kv head, no lengths
    pytest.param(2, 2, 1, 128, 256, 64, True, None, id="mqa-sq<sk"),
])
def test_bshd_forward_backward_match_reference(mode, b, h, h_kv, sq, sk, d,
                                               causal, lens):
    q, k, v, do = _case("bshd", b, h, h_kv, sq, sk, d, seed=sq + sk + d)
    lens = None if lens is None else np.asarray(lens, np.int32)
    kw = dict(causal=causal, layout="bshd")
    got = _port(q, k, v, do, None, lens, **kw)
    want = _reference(q, k, v, do, None, lens, mode=mode, **kw)
    _assert_match(got, want)
    if lens is not None and 0 in lens:
        assert not got[0][torch.tensor(lens) == 0].any()


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("hb,causal,lens", [
    pytest.param(1, True, None, id="broadcast-causal"),
    pytest.param(4, False, [100, 0], id="per-head-padded"),
    pytest.param(8, True, [128, 70], id="per-row-causal-padded"),
])
def test_array_bias_flat_matches_reference(mode, hb, causal, lens):
    """hb ∈ {1, h, b·h} on the bh-flat layout (b 2, h 4), row r reading
    bias row r % hb, composed with causal and kv_lens."""
    b, h, s, d = 2, 4, 128, 64
    q, k, v, do = _case("bhsd", b, h, h, s, s, d, seed=hb)
    bias = np.random.default_rng(hb + 10).standard_normal(
        (hb, s, s)).astype(np.float32)
    lens = (None if lens is None else
            np.repeat(np.asarray(lens, np.int32)[:, None], h, 1))
    kw = dict(causal=causal, layout="bhsd")
    _assert_match(_port(q, k, v, do, bias, lens, **kw),
                  _reference(q, k, v, do, bias, lens, mode=mode, **kw))


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("hb,h_kv,d,causal,lens", [
    pytest.param(1, 4, 128, False, [128, 33], id="broadcast-d128"),
    pytest.param(2, 2, 64, True, [0, 90], id="pairs-gqa-d64"),
])
def test_array_bias_bshd_matches_reference(mode, hb, h_kv, d, causal, lens):
    """hb | h on the seq-major layout (h 4): head t reads bias row t % hb;
    with per-batch kv_lens."""
    b, h, s = 2, 4, 128
    q, k, v, do = _case("bshd", b, h, h_kv, s, s, d, seed=hb + d)
    bias = np.random.default_rng(hb).standard_normal(
        (hb, s, s)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    kw = dict(causal=causal, layout="bshd")
    _assert_match(_port(q, k, v, do, bias, lens, **kw),
                  _reference(q, k, v, do, bias, lens, mode=mode, **kw))


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_bf16_bias_cotangent_matches_reference(layout):
    """A bf16 bias on fp32 operands: the kernels read it as fp32 and its
    cotangent comes back in bf16 on both sides (``_bias_cotangent``)."""
    b, h, s, d = 2, 2, 128, 64
    q, k, v, do = _case(layout, b, h, h, s, s, d, seed=21)
    bias32 = np.random.default_rng(3).standard_normal((h, s, s)).astype(
        np.float32)
    jb = jnp.asarray(bias32, jnp.bfloat16)
    lens = np.asarray([128, 64], np.int32)
    if layout == "bhsd":
        lens = np.repeat(lens[:, None], h, 1)

    def f(bias):
        return jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      bias=bias, kv_lens=jnp.asarray(lens), layout=layout,
                      impl="xla")

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(f, jb)
        want = vjp(jnp.asarray(do))[0]
    tb = torch.tensor(np.asarray(jb.astype(jnp.float32))).bfloat16()
    tb.requires_grad_()
    o = amod.flash_attention(*(torch.tensor(a) for a in (q, k, v)), bias=tb,
                             kv_lens=torch.tensor(lens), layout=layout)
    o.backward(torch.tensor(do))
    assert want.dtype == jnp.bfloat16 and tb.grad.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(tb.grad.float().numpy(), w, rtol=0,
                               atol=BF16_RTOL * np.abs(w).max())


def test_bshd_equals_flat_on_transposed_operands():
    """The seq-major plain path and the bh-flat one agree on the same
    numbers: per-batch lengths expanded over the heads, (b, s, h, d)
    operands transposed to (b, h, s, d)."""
    b, h, h_kv, s, d = 2, 4, 2, 96, 64
    q, k, v, do = (torch.tensor(a) for a in _case("bshd", b, h, h_kv, s, s,
                                                  d, seed=5))
    bias = torch.randn(2, s, s)
    lens = torch.tensor([96, 40], dtype=torch.int32)
    kw = dict(scale=0.125, causal=True, bias=bias)
    o, lse = amod.flash_fwd_bshd(q, k, v, kv_lens=lens, **kw)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    flat_lens = lens.repeat_interleave(h)
    o2, lse2 = amod.flash_fwd(t(q), t(k), t(v), kv_lens=flat_lens,
                              bias=bias.repeat(2, 1, 1), **{
                                  k_: v_ for k_, v_ in kw.items()
                                  if k_ != "bias"})
    torch.testing.assert_close(o, t(o2))
    torch.testing.assert_close(lse.reshape(b * h, s), lse2)
    g = amod.flash_bwd_bshd(q, k, v, o, lse, do, kv_lens=lens, **kw)
    g2 = amod.flash_bwd(t(q), t(k), t(v), t(o), lse.reshape(b * h, s), t(do),
                        kv_lens=flat_lens, scale=0.125, causal=True,
                        bias=bias.repeat(2, 1, 1))
    for a, c in zip(g[:3], g2[:3]):
        torch.testing.assert_close(a, t(c))
    torch.testing.assert_close(g[3], g2[3].reshape(2, 2, s, s).sum(0))


def test_array_bias_refusals():
    x = torch.zeros((2, 4, 128, 64))
    with pytest.raises(ValueError, match="bias must be"):
        amod.flash_attention(x, x, x, bias=torch.zeros(4, 128, 64))
    with pytest.raises(ValueError, match="must divide"):
        amod.flash_attention(x, x, x, bias=torch.zeros(3, 128, 128))
    xs = x.transpose(1, 2)
    with pytest.raises(ValueError, match="dividing q heads"):
        amod.flash_attention(xs, xs, xs, bias=torch.zeros(8, 128, 128),
                             layout="bshd")
    with pytest.raises(ValueError, match="per-batch"):
        amod.flash_attention(xs, xs, xs, kv_lens=torch.ones(2, 4),
                             layout="bshd")
    with pytest.raises(NotImplementedError, match="BucketedBias"):
        amod.flash_attention(xs, xs, xs, layout="bshd",
                             bias=amod.BucketedBias(torch.zeros(32, 4)))
