"""Port parity: ``flash_attention(layout="bshd", bias=BucketedBias)`` — T5's
bucketed relative bias on the seq-major layout — against apex_tpu's, forward,
gradients and the bucket table's gradient, on the same inputs.

The reference runs its Pallas ``flash_fwd_bshd``/``flash_bwd_bshd`` with
``rel_bias`` in interpret mode (reached through ``_flash_core_bshd`` with
``use_pallas=True``: its ``auto`` gate sends head_dim 64 with several heads
to XLA, a TPU lane rule) and its XLA composition; the port runs its plain
versions (CPU tensors). fp32, full-precision matmuls on both sides. The
table's rows are heads: row r = b·h + head of the b-major flatten reads
column r % heads. Tolerances (ROADMAP's rule): the loss sum(o·do) within
1e-5 relative, o within 1e-5, every gradient — dq, dk, dv and the table's
— within 2e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import BucketedBias as JBucketedBias
from apex_tpu.ops.attention import _flash_core_bshd
from apex_tpu.ops.attention import flash_attention as jflash
from apex_tpu_torch.ops import attention as amod

torch.backends.cuda.matmul.allow_tf32 = False

O_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


def _case(b, h, h_kv, sq, sk, d, heads, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b, sq, h, d), f(b, sk, h_kv, d), f(b, sk, h_kv, d),
            f(b, sq, h, d), f(32, heads) * 0.5)


def _reference(q, k, v, do, table, lens, *, causal, bidirectional, mode,
               q_offset=0, k_offset=0, rate=0.0, seed=None):
    d = q.shape[-1]

    def f(q, k, v, table):
        bias = JBucketedBias(table, bidirectional=bidirectional,
                             max_distance=128, q_offset=q_offset,
                             k_offset=k_offset)
        lj = None if lens is None else jnp.asarray(lens, jnp.int32)
        if mode == "pallas":
            sd = None if rate == 0.0 else jnp.asarray(seed, jnp.int32)
            return _flash_core_bshd(q, k, v, bias, lj, sd, d ** -0.5,
                                    causal, True, rate)
        return jflash(q, k, v, causal=causal, layout="bshd", impl="xla",
                      kv_lens=lj, bias=bias, dropout_rate=rate,
                      dropout_seed=seed)

    @jax.jit
    def fwd_bwd(q, k, v, table, do):
        o, vjp = jax.vjp(f, q, k, v, table)
        return (o, *vjp(do))

    with jax.default_matmul_precision("highest"):
        return list(fwd_bwd(*(jnp.asarray(a) for a in (q, k, v, table, do))))


def _port(q, k, v, do, table, lens, *, causal, bidirectional, q_offset=0,
          k_offset=0, rate=0.0, seed=None):
    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v, table)]
    bias = amod.BucketedBias(args[3], bidirectional=bidirectional,
                             max_distance=128, q_offset=q_offset,
                             k_offset=k_offset)
    o = amod.flash_attention(*args[:3], causal=causal, layout="bshd",
                             bias=bias, kv_lens=None if lens is None
                             else torch.tensor(lens), dropout_rate=rate,
                             dropout_seed=seed)
    o.backward(torch.tensor(do))
    return [o.detach()] + [t.grad for t in args]


def _assert_match(got, want, do):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               err_msg="o", **O_TOL)
    loss_g = float((got[0].double() * torch.tensor(do).double()).sum())
    loss_w = float((np.asarray(want[0], np.float64) * do).sum())
    assert abs(loss_g - loss_w) <= LOSS_RTOL * abs(loss_w)
    for name, g, w in zip(("dq", "dk", "dv", "dtable"), got[1:], want[1:]):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize(
    "b,h,h_kv,sq,sk,d,heads,causal,bidirectional,lens", [
        # T5's encoder self-attention on bshd: bidirectional, padded rows
        pytest.param(3, 4, 4, 128, 128, 64, 4, False, True, [0, 128, 77],
                     id="enc-pad-d64"),
        # the decoder's causal bucketing, grouped kv heads, d 128
        pytest.param(2, 4, 2, 128, 128, 128, 4, True, False, [128, 50],
                     id="dec-gqa-d128"),
        # a table of 2 heads shared by 4 (head t reads column t % 2),
        # sq < sk with bottom-right alignment, no lengths
        pytest.param(2, 4, 1, 128, 256, 64, 2, True, False, None,
                     id="shared-table-sq<sk"),
    ])
def test_bshd_rel_bias_matches_reference(mode, b, h, h_kv, sq, sk, d, heads,
                                         causal, bidirectional, lens):
    q, k, v, do, table = _case(b, h, h_kv, sq, sk, d, heads,
                               seed=sq + sk + d + heads)
    lens = None if lens is None else np.asarray(lens, np.int32)
    kw = dict(causal=causal, bidirectional=bidirectional)
    got = _port(q, k, v, do, table, lens, **kw)
    want = _reference(q, k, v, do, table, lens, mode=mode, **kw)
    _assert_match(got, want, do)
    if lens is not None and 0 in lens:
        assert not got[0][torch.tensor(lens) == 0].any()


def test_bshd_rel_bias_offsets_match_reference():
    """A piece of a longer sequence: the q and k offsets shift every
    score's bucket."""
    q, k, v, do, table = _case(2, 2, 2, 128, 128, 64, 2, seed=11)
    kw = dict(causal=False, bidirectional=True, q_offset=300, k_offset=170)
    got = _port(q, k, v, do, table, None, **kw)
    want = _reference(q, k, v, do, table, None, mode="xla", **kw)
    _assert_match(got, want, do)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_bshd_rel_bias_with_dropout_matches_reference(mode):
    """Dropout with the bucketed bias works on bshd as on bh-flat: the
    reference's mask, keyed by q-head row b·h + head, bit for bit."""
    q, k, v, do, table = _case(2, 4, 2, 128, 128, 64, 4, seed=21)
    kw = dict(causal=True, bidirectional=False, rate=0.1, seed=1234)
    got = _port(q, k, v, do, table, np.array([128, 90], np.int32), **kw)
    want = _reference(q, k, v, do, table, np.array([128, 90], np.int32),
                      mode=mode, **kw)
    _assert_match(got, want, do)


def test_bshd_rel_bias_equals_the_flat_route():
    """The bshd route with the bucketed bias is the bh-flat route on the
    transposed operands (per-batch lengths repeated over the heads)."""
    q, k, v, do, table = _case(2, 4, 4, 128, 128, 64, 4, seed=5)
    lens = np.array([100, 128], np.int32)
    got = _port(q, k, v, do, table, lens, causal=True, bidirectional=False)
    t = lambda a: torch.tensor(a).transpose(1, 2)  # noqa: E731
    args = [t(q).requires_grad_(), t(k).requires_grad_(),
            t(v).requires_grad_(), torch.tensor(table, requires_grad=True)]
    o = amod.flash_attention(*args[:3], causal=True,
                             bias=amod.BucketedBias(args[3], max_distance=128),
                             kv_lens=torch.tensor(lens).repeat_interleave(
                                 4).reshape(2, 4))
    o.backward(t(do))
    torch.testing.assert_close(got[0], o.detach().transpose(1, 2))
    for g, w in zip(got[1:4], args[:3]):
        torch.testing.assert_close(g, w.grad.transpose(1, 2))
    torch.testing.assert_close(got[4], args[3].grad)
