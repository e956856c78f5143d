"""Port parity: apex_tpu_torch's bh-flat ``flash_attention`` (kv_lens and
the bucketed relative bias) and its bucketing against apex_tpu's, on the
same inputs.

The reference runs its Pallas kernels in interpret mode
(``APEX_TPU_PALLAS=interpret``: ``flash_fwd``, ``flash_bwd`` and the
in-kernel ``_dtable_pallas``) and its XLA composition (``=0``, where the
bias materialises and the table gradient is the gather's VJP); the port
runs its plain versions (CPU tensors). fp32, full-precision matmuls on
both sides. Tolerances: the output within 1e-5 (relative and absolute),
every gradient — dq, dk, dv and the bucket table — within 2e-4 of its
largest entry (fp32 sums in another order; the table sums up to b·sq·sk
terms per bucket). Buckets must be identical at every offset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import BucketedBias as JBias
from apex_tpu.ops.attention import flash_attention as jflash
from apex_tpu.ops.pallas.attention import relative_position_bucket as jbucket
from apex_tpu_torch.ops import attention as amod

torch.backends.cuda.matmul.allow_tf32 = False

O_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4


@pytest.fixture(params=["interpret", "0"])
def ref_mode(request, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", request.param)
    return request.param


def _case(b, h, h_kv, sq, sk, d, seed, nb=32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b, h, sq, d), f(b, h_kv, sk, d), f(b, h_kv, sk, d),
            f(b, h, sq, d), (0.5 * f(nb, h)))


def _run_both(q, k, v, do, table, *, causal, kv_lens=None, rel=None):
    """(o, dq, dk, dv, dtable) from the reference and from the port."""
    lens_j = None if kv_lens is None else jnp.asarray(kv_lens)

    def jf(q, k, v, t):
        bias = None if rel is None else JBias(t, *rel)
        return jflash(q, k, v, causal=causal, kv_lens=lens_j, bias=bias)

    @jax.jit
    def fwd_bwd(q, k, v, t, do):
        o, vjp = jax.vjp(jf, q, k, v, t)
        return (o, *vjp(do))

    with jax.default_matmul_precision("highest"):
        want = [np.asarray(x) for x in fwd_bwd(
            *(jnp.asarray(a) for a in (q, k, v, table, do)))]

    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v, table)]
    bias = None if rel is None else amod.BucketedBias(args[3], *rel)
    lens_t = None if kv_lens is None else torch.tensor(kv_lens)
    o = amod.flash_attention(*args[:3], causal=causal, kv_lens=lens_t,
                             bias=bias)
    o.backward(torch.tensor(do))
    got = [o.detach().numpy()] + [
        np.zeros_like(a) if t.grad is None else t.grad.numpy()
        for t, a in zip(args, (q, k, v, table))]
    return got, want


def _assert_match(got, want, names=("o", "dq", "dk", "dv", "dtable")):
    np.testing.assert_allclose(got[0], want[0], err_msg="o", **O_TOL)
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("kind,b,h,h_kv,sq,sk,d,lens", [
    # encoder self-attention: bidirectional buckets, padded keys
    pytest.param("enc", 2, 2, 2, 128, 128, 64, [100, 128], id="enc"),
    # decoder self-attention: causal buckets
    pytest.param("dec", 2, 2, 2, 128, 128, 64, None, id="dec"),
    # cross-attention: sq != sk, padded keys, no bias
    pytest.param("cross", 2, 2, 2, 128, 256, 64, [256, 140], id="cross"),
    # grouped kv heads, d 128, a row of length 0
    pytest.param("enc", 2, 4, 2, 128, 128, 128, [0, 77], id="gqa-d128"),
])
def test_flash_attention_bhsd_matches_reference(ref_mode, kind, b, h, h_kv,
                                                sq, sk, d, lens):
    q, k, v, do, table = _case(b, h, h_kv, sq, sk, d, seed=sq + sk + h)
    rel = {"enc": (True, 128), "dec": (False, 128), "cross": None}[kind]
    kv_lens = (None if lens is None else
               np.repeat(np.asarray(lens, np.int32)[:, None], h, 1))
    got, want = _run_both(q, k, v, do, table, causal=kind == "dec",
                          kv_lens=kv_lens, rel=rel)
    _assert_match(got, want)
    if lens is not None and 0 in lens:
        dead = kv_lens == 0
        assert not got[0][dead].any(), "a length-0 row must be zeros"


def test_flash_attention_offsets_match_reference(ref_mode):
    """A nonzero (q_offset, k_offset) pair — the global positions of a
    piece of a longer sequence — in the forward and the backward: key
    minus query positions span [-187, 67], past max_distance 40 on both
    sides, so the clamped end buckets and the exact ones all carry
    weight."""
    q, k, v, do, table = _case(1, 2, 2, 128, 128, 64, seed=3, nb=16)
    got, want = _run_both(q, k, v, do, table, causal=False,
                          rel=(True, 40, 100, 40))
    _assert_match(got, want)


def test_dtable_is_the_sum_of_the_unscaled_ds():
    """The table gradient on its own terms: the materialised bias's
    autograd gradient, summed by bucket, equals the flash backward's
    table cotangent (an error of exactly sqrt(d) would be the scale
    applied twice)."""
    q, k, v, do, table = _case(2, 2, 2, 64, 96, 64, seed=9)
    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v, table)]
    bias = amod.BucketedBias(args[3], bidirectional=False, max_distance=20,
                             q_offset=32, k_offset=0)
    o = amod.flash_attention(*args[:3], causal=True, bias=bias)
    o.backward(torch.tensor(do))
    t2 = args[3].detach().clone().requires_grad_()
    s = torch.einsum("bhqd,bhkd->bhqk", args[0].detach(),
                     args[1].detach()) / 8.0
    s = s + amod.BucketedBias(t2, False, 20, 32, 0).materialize(64, 96)
    mask = torch.arange(96)[None, :] <= torch.arange(64)[:, None] + 32
    p = torch.softmax(torch.where(mask, s, -1e30), -1)
    (torch.einsum("bhqk,bhkd->bhqd", p, args[2].detach())
     * torch.tensor(do)).sum().backward()
    want = t2.grad.numpy()
    np.testing.assert_allclose(args[3].grad.numpy(), want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


def test_flat_ops_take_rows_and_views_alike():
    """flash_fwd / flash_bwd on (bh, s, d) rows and on (b, h, s, d)
    transposed views of a (b, s, h·d) buffer give the same numbers."""
    rng = np.random.default_rng(4)
    b, h, s, d = 2, 4, 64, 64
    y = torch.tensor(rng.standard_normal((b, s, 3 * h * d)),
                     dtype=torch.float32)
    q4, k4, v4 = (t.view(b, s, h, d).transpose(1, 2)
                  for t in y.split(h * d, -1))
    do4 = torch.tensor(rng.standard_normal((b, h, s, d)), dtype=torch.float32)
    lens = torch.tensor([40] * h + [64] * h, dtype=torch.int32)
    bias = amod.BucketedBias(torch.randn(8, h), bidirectional=True,
                             max_distance=16)
    kw = dict(scale=0.125, causal=False, kv_lens=lens, rel_bias=bias)
    o4, lse4 = amod.flash_fwd(q4, k4, v4, **kw)
    rows = [t.reshape(b * h, s, d) for t in (q4, k4, v4)]
    o3, lse3 = amod.flash_fwd(*rows, **kw)
    torch.testing.assert_close(o4.reshape(b * h, s, d), o3)
    torch.testing.assert_close(lse4, lse3)
    g4 = amod.flash_bwd(q4, k4, v4, o4, lse4, do4, **kw)
    g3 = amod.flash_bwd(*rows, o3, lse3, do4.reshape(b * h, s, d), **kw)
    for a, c in zip(g4, g3):
        torch.testing.assert_close(a.reshape(c.shape), c)


@pytest.mark.parametrize("nb,maxd", [(32, 128), (8, 16), (16, 40),
                                     (32, 64)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_buckets_identical_to_reference(nb, maxd, bidirectional):
    rel = np.arange(-maxd - 2, maxd + 3, dtype=np.int32)
    want = np.asarray(jbucket(jnp.asarray(rel), bidirectional=bidirectional,
                              num_buckets=nb, max_distance=maxd))
    got = amod.relative_position_bucket(
        torch.tensor(rel), bidirectional=bidirectional, num_buckets=nb,
        max_distance=maxd).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_kernel_lookup_equals_the_materialized_bias(bidirectional):
    """The kernels' per-offset lookup (clamped to ±max_distance) gives
    the materialised bias at every score, offsets far past
    max_distance included."""
    table = torch.randn(16, 3)
    bias = amod.BucketedBias(table, bidirectional, 24, q_offset=7,
                             k_offset=90)
    lut, bucket, rel_off = bias.kernel_operands()
    sq, sk = 50, 200
    n = (torch.arange(sk)[None, :] - torch.arange(sq)[:, None] + rel_off)
    idx = n.clamp(-24, 24) + 24
    torch.testing.assert_close(lut[:, idx], bias.materialize(sq, sk),
                               rtol=0, atol=0)
    assert bucket.dtype == torch.int32 and bucket.shape == (49,)


def test_flash_attention_refusals():
    x = torch.zeros((1, 2, 128, 64))
    with pytest.raises(ValueError, match="bias must be"):
        amod.flash_attention(x, x, x, bias=torch.zeros(2, 128, 64))
    with pytest.raises(NotImplementedError, match="dropout"):
        amod.flash_attention(x, x, x, bias=torch.zeros((2, 128, 128)),
                             dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(ValueError, match="dropout_seed"):
        amod.flash_attention(x, x, x, dropout_rate=0.1)
    with pytest.raises(ValueError, match="sq <= sk"):
        amod.flash_attention(x, x[:, :, :64], x[:, :, :64], causal=True)
    with pytest.raises(ValueError, match="kv_lens"):
        amod.flash_attention(x, x, x, kv_lens=torch.ones(2))
    with pytest.raises(ValueError, match="even"):
        amod.flash_attention(x, x, x, bias=amod.BucketedBias(
            torch.zeros(7, 2), bidirectional=True))
    with pytest.raises(ValueError, match="divide"):
        amod.flash_attention(x, x, x, bias=amod.BucketedBias(
            torch.zeros(8, 3)))
    with pytest.raises(ValueError, match="max_distance"):
        amod.flash_attention(x, x, x, bias=amod.BucketedBias(
            torch.zeros(32, 2), bidirectional=True, max_distance=8))
