"""Port parity for dropout in the flash attention: apex_tpu_torch's
``flash_attention`` (bh-flat, with and without a ``BucketedBias``; bshd
with per-batch ``kv_lens``), ``fused_qkv_attention`` and the packed
kernels' plain versions against apex_tpu's, with the same dropout seeds.

The reference runs its Pallas kernels in interpret mode
(``APEX_TPU_PALLAS=interpret``: the masks of ``_fwd_kernel``,
``_bwd_single_block_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and
``_bwd_dtable_kernel``) and its XLA composition (``=0``:
``_dropout_keep_dense``); the port runs its plain versions (CPU tensors),
which rebuild the same counter-hash masks. fp32, full-precision matmuls.
Tolerances: outputs within 1e-5 relative (and absolute), every gradient
within 2e-4 of its leaf's largest entry (fp32 sums in another order). The
masks are exact (``test_torch_dropout.py``), so any disagreement in where
the mask applies — the normaliser, dV's p, dS's dP — shows far above
these bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import BucketedBias as JBias
from apex_tpu.ops.attention import _flash_core_bshd, bshd_kernel_ok
from apex_tpu.ops.attention import flash_attention as jflash
from apex_tpu.ops.attention import fused_qkv_attention as j_fused
from apex_tpu.ops.pallas import attention as jk
from apex_tpu_torch.ops import attention as amod

torch.backends.cuda.matmul.allow_tf32 = False

O_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4
RATE = 0.1


@pytest.fixture(params=["interpret", "0"])
def ref_mode(request, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", request.param)
    return request.param


def _f(rng, *s):
    return rng.standard_normal(s).astype(np.float32)


def _assert_match(got, want, names):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), err_msg=names[0],
                               **O_TOL)
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)


def _vjp(f, args, cot):
    @jax.jit
    def fwd_bwd(*a):
        o, vjp = jax.vjp(f, *a[:-1])
        return (o, *vjp(a[-1]))
    with jax.default_matmul_precision("highest"):
        return [np.asarray(x) for x in fwd_bwd(
            *(jnp.asarray(a) for a in (*args, cot)))]


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal,lens,rel,seed", [
    # causal, grouped kv heads: the mask keyed by the q head's row
    pytest.param(2, 4, 2, 128, 128, 64, True, None, None, -7, id="gqa"),
    # T5's encoder: bidirectional buckets, padded keys, a negative seed
    pytest.param(2, 2, 2, 128, 128, 64, False, [100, 128], (True, 128),
                 -2 ** 31, id="enc-bucketed"),
    # decoder: causal buckets, the seed's top edge
    pytest.param(2, 2, 2, 128, 128, 64, True, None, (False, 128),
                 2 ** 31 - 1, id="dec-bucketed"),
    # cross: sq != sk, no bias
    pytest.param(1, 2, 1, 128, 256, 64, False, [256], None, 9,
                 id="cross-mqa"),
])
def test_flash_attention_bhsd_dropout_matches_reference(
        ref_mode, b, h, h_kv, sq, sk, d, causal, lens, rel, seed):
    rng = np.random.default_rng(sq + sk + h + h_kv)
    q, k, v, do = (_f(rng, b, h, sq, d), _f(rng, b, h_kv, sk, d),
                   _f(rng, b, h_kv, sk, d), _f(rng, b, h, sq, d))
    table = 0.5 * _f(rng, 32, h)
    kv_lens = (None if lens is None else
               np.repeat(np.asarray(lens, np.int32)[:, None], h, 1))

    def jf(q, k, v, t):
        bias = None if rel is None else JBias(t, *rel)
        return jflash(q, k, v, causal=causal, bias=bias,
                      kv_lens=None if kv_lens is None
                      else jnp.asarray(kv_lens),
                      dropout_rate=RATE, dropout_seed=jnp.int32(seed))

    want = _vjp(jf, (q, k, v, table), do)
    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v, table)]
    bias = None if rel is None else amod.BucketedBias(args[3], *rel)
    o = amod.flash_attention(*args[:3], causal=causal, bias=bias,
                             kv_lens=None if kv_lens is None
                             else torch.tensor(kv_lens),
                             dropout_rate=RATE, dropout_seed=seed)
    o.backward(torch.tensor(do))
    got = [o.detach().numpy()] + [
        np.zeros_like(a) if t.grad is None else t.grad.numpy()
        for t, a in zip(args, (q, k, v, table))]
    names = ("o", "dq", "dk", "dv", "dtable")
    if rel is None:
        got, want, names = got[:4], want[:4], names[:4]
    _assert_match(got, want, names)


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal,lens", [
    pytest.param(2, 4, 2, 128, 128, 64, True, [128, 77], id="causal-gqa"),
    pytest.param(2, 2, 2, 128, 128, 128, False, [128, 0], id="padded"),
])
def test_flash_attention_bshd_dropout_matches_reference(
        ref_mode, b, h, h_kv, sq, sk, d, causal, lens):
    """The seq-major layout with per-batch kv_lens: q-head row t = b·h +
    head on both sides."""
    rng = np.random.default_rng(sq + h + d)
    q, k, v, do = (_f(rng, b, sq, h, d), _f(rng, b, sk, h_kv, d),
                   _f(rng, b, sk, h_kv, d), _f(rng, b, sq, h, d))
    seed = 12345
    lj = jnp.asarray(np.asarray(lens, np.int32))
    pallas = ref_mode == "interpret"
    direct = pallas and not bshd_kernel_ok(sq, sk, h, d, jnp.float32)

    def jf(q, k, v):
        if direct:  # the reference's gate sends d 64 multi-head to XLA
            return _flash_core_bshd(q, k, v, None, lj, jnp.int32(seed),
                                    d ** -0.5, causal, True, RATE)
        return jflash(q, k, v, causal=causal, layout="bshd", kv_lens=lj,
                      impl="pallas" if pallas else "xla",
                      dropout_rate=RATE, dropout_seed=jnp.int32(seed))

    want = _vjp(jf, (q, k, v), do)
    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = amod.flash_attention(*args, causal=causal, layout="bshd",
                             kv_lens=torch.tensor(lens),
                             dropout_rate=RATE, dropout_seed=seed)
    o.backward(torch.tensor(do))
    got = [o.detach().numpy()] + [t.grad.numpy() for t in args]
    _assert_match(got, want, ("o", "dq", "dk", "dv"))


@pytest.mark.parametrize("h_kv,causal", [(2, True), (1, True), (2, False)])
def test_fused_qkv_attention_dropout_matches_reference(h_kv, causal,
                                                       monkeypatch):
    """Output and the four cotangents at b 2, s 128, d 128, h 2: the
    reference's packed forward and single-block backward, each masked."""
    monkeypatch.setenv("APEX_TPU_PALLAS", "interpret")
    b, s, H, h, d = 2, 128, 64, 2, 128
    rng = np.random.default_rng(h_kv + 10 * causal)
    G = h + 2 * h_kv
    x = _f(rng, b, s, H)
    w_qkv = 0.1 * _f(rng, G * d, H)
    b_qkv = 0.1 * _f(rng, G * d)
    w_out = 0.1 * _f(rng, H, h * d)
    cot = _f(rng, b, s, H)
    scale, seed = d ** -0.5, -424242

    def jf(x, w_qkv, b_qkv, w_out):
        return j_fused(x, w_qkv, b_qkv, w_out, None, jnp.int32(seed), None,
                       h, h_kv, d, scale, causal, RATE)

    want = _vjp(jf, (x, w_qkv, b_qkv, w_out), cot)
    args = [torch.tensor(a, requires_grad=True)
            for a in (x, w_qkv, b_qkv, w_out)]
    y = amod.fused_qkv_attention(*args, h, h_kv, d, scale, causal,
                                 dropout_rate=RATE, dropout_seed=seed)
    y.backward(torch.tensor(cot))
    got = [y.detach().numpy()] + [t.grad.numpy() for t in args]
    _assert_match(got, want, ("y", "dx", "dw_qkv", "db_qkv", "dw_out"))


@pytest.mark.parametrize("h_kv", [4, 2])
def test_packed_multi_block_dropout_matches_reference(h_kv):
    """The packed plain versions against the reference's Pallas forward
    and its dQ / dK-dV pair (interpret mode, 128-row blocks at s 256:
    the masks of :929 and :996 on blocks other than the first)."""
    b, s, h, d = 1, 256, 4, 128
    rng = np.random.default_rng(h_kv)
    qkv = _f(rng, b, s, (h + 2 * h_kv) * d)
    do = _f(rng, b, s, h * d)
    kw = dict(scale=d ** -0.5, causal=True, dropout_rate=RATE)
    seed = 77
    with jax.default_matmul_precision("highest"):
        o_j, lse_j = jk.flash_fwd_packed(
            jnp.asarray(qkv), h, h_kv, d, bq=128, bk=128, interpret=True,
            dropout_seed=jnp.int32(seed), **kw)
        g_j = jk.flash_bwd_packed(
            jnp.asarray(qkv), h, h_kv, d, o_j, lse_j, jnp.asarray(do),
            bq=128, bk=128, interpret=True, dropout_seed=jnp.int32(seed),
            **kw)
    o, lse = amod.flash_fwd_packed(torch.tensor(qkv), h, h_kv, d,
                                   dropout_seed=seed, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **O_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **O_TOL)
    grads = amod.flash_bwd_packed(
        torch.tensor(qkv), torch.tensor(np.asarray(o_j)),
        torch.tensor(np.asarray(lse_j)), torch.tensor(do), h, h_kv, d,
        dropout_seed=seed, **kw)
    _assert_match([o.numpy(), *(g.numpy() for g in grads)],
                  [o_j, *g_j[:3]], ("o", "dq", "dk", "dv"))


def test_dropout_semantics_of_the_plain_versions():
    """lse is the un-dropped one; the same seed gives the same output, a
    rate of 0 ignores the seed; the mask is keyed by q head, not kv
    head."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(_f(rng, 2, 4, 64, 32)) for _ in range(3))
    kw = dict(scale=0.2, causal=True)
    _, lse0 = amod.flash_fwd(q, k, v, **kw)
    o1, lse1 = amod.flash_fwd(q, k, v, dropout_rate=RATE, dropout_seed=5,
                              **kw)
    o2, _ = amod.flash_fwd(q, k, v, dropout_rate=RATE, dropout_seed=5, **kw)
    o3, _ = amod.flash_fwd(q, k, v, dropout_rate=RATE, dropout_seed=6, **kw)
    assert torch.equal(lse0, lse1) and torch.equal(o1, o2)
    assert not torch.equal(o1, o3)
    o0 = amod.flash_attention(q, k, v, causal=True)
    assert torch.equal(amod.flash_attention(q, k, v, causal=True,
                                            dropout_seed=5), o0)
    # two q heads sharing a kv head draw different masks
    keep = amod._dropout_keep_dense(5, (2, 4), 64, 64, RATE)
    assert not torch.equal(keep[0, 0], keep[0, 1])


def test_dropout_refusals():
    """Dropout with an array bias runs on both layouts and in the
    wrappers (the dbias kernel takes the mask); a rate needs a seed; the
    sm80 variant refuses dropout (ROADMAP's simplicity item)."""
    x = torch.zeros((1, 2, 128, 64))
    bias = torch.zeros((2, 128, 128))
    assert amod.flash_attention(x, x, x, bias=bias, dropout_rate=RATE,
                                dropout_seed=1).shape == x.shape
    xs = x.transpose(1, 2)
    assert amod.flash_attention(xs, xs, xs, layout="bshd", bias=bias,
                                dropout_rate=RATE,
                                dropout_seed=1).shape == xs.shape
    for fn in (amod.flash_fwd, amod.flash_fwd_bshd):
        args = (x, x, x) if fn is amod.flash_fwd else (xs, xs, xs)
        o, _ = fn(*args, scale=1.0, causal=False, bias=bias,
                  dropout_rate=RATE, dropout_seed=1)
        assert o.shape == args[0].shape
    with pytest.raises(ValueError, match="requires dropout_seed"):
        amod.flash_attention(x, x, x, dropout_rate=RATE)
    with pytest.raises(ValueError, match="dropout_rate"):
        amod.flash_attention(x, x, x, dropout_rate=1.0, dropout_seed=1)
    plan = amod.FlashPlan("sm80", {}, None)
    with pytest.raises(ValueError, match="ROADMAP"):
        amod._drop_args(RATE, 1, plan, None, "flash_fwd_cuda")
    assert amod._drop_args(0.0, None, plan, None, "x") == (0, 0, 1.0, 0)
    wg = amod.FlashPlan("wgmma", {}, None)
    assert amod._drop_args(RATE, -1, wg, "swap_row_col", "x") == (
        2 ** 32 - 1, amod.dropout_threshold(RATE), amod.dropout_scale(RATE),
        2)
    with pytest.raises(ValueError, match="needs dropout_rate"):
        amod._drop_args(0.0, None, wg, "key_kv_head", "x")
