"""Port parity for dropout beside the array bias in the flash attention:
apex_tpu_torch's ``flash_attention`` with an (hb, sq, sk) bias and dropout
on both layouts against apex_tpu's, with the same int32 seed.

The reference runs its Pallas kernels in interpret mode
(``APEX_TPU_PALLAS=interpret``: the masks of ``_fwd_kernel``,
``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and ``_bwd_dbias_kernel``, whose
dS takes the dropped dP at ``:1083``) and its XLA composition (``=0``);
the port runs its plain versions (CPU tensors). fp32, full-precision
matmuls. Tolerances: o within 1e-5 relative (and absolute), dq, dk, dv
and dbias within 2e-4 of their leaf's largest entry (fp32 sums in another
order). The cases: bh-flat with the bias shared by head pairs and padded
rows; GQA, causal, one bias row; the key-padding route's head-major (h,
b, s, d) views of (b, s, h, d) tensors with a (b, sq, sk) bias, rows t =
h_i·b + b_i reading bias row t % b; bshd with per-batch lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import _flash_core_bshd
from apex_tpu.ops.attention import flash_attention as jflash
from apex_tpu_torch.ops import attention as amod

O_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4
RATE = 0.1


@pytest.fixture(params=["interpret", "0"])
def ref_mode(request, monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", request.param)
    return request.param


def _f(rng, *s):
    return rng.standard_normal(s).astype(np.float32)


def _vjp(f, args, cot):
    @jax.jit
    def fwd_bwd(*a):
        o, vjp = jax.vjp(f, *a[:-1])
        return (o, *vjp(a[-1]))
    with jax.default_matmul_precision("highest"):
        return [np.asarray(x) for x in fwd_bwd(
            *(jnp.asarray(a) for a in (*args, cot)))]


def _assert_match(got, want, names):
    np.testing.assert_allclose(got[0], want[0], err_msg=names[0], **O_TOL)
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)


def _port(args, do, **kw):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    o = amod.flash_attention(*ts[:3], bias=ts[3], dropout_rate=RATE, **kw)
    o.backward(torch.tensor(do))
    return [o.detach().numpy()] + [t.grad.numpy() for t in ts]


NAMES = ("o", "dq", "dk", "dv", "dbias")


@pytest.mark.parametrize("b,h,h_kv,hb,causal,lens,seed", [
    # hb 2 of 4 rows (r % hb), padded keys, the seed's bottom edge
    pytest.param(2, 2, 2, 2, False, [128, 77], -2 ** 31, id="shared-padded"),
    # grouped kv heads, causal, one bias row for every q head
    pytest.param(1, 4, 2, 1, True, None, 2 ** 31 - 1, id="gqa-causal"),
])
def test_bhsd_bias_dropout_matches_reference(ref_mode, b, h, h_kv, hb,
                                             causal, lens, seed):
    s, d = 128, 64
    rng = np.random.default_rng(h + hb + causal)
    q, k, v, do = (_f(rng, b, h, s, d), _f(rng, b, h_kv, s, d),
                   _f(rng, b, h_kv, s, d), _f(rng, b, h, s, d))
    bias = 0.5 * _f(rng, hb, s, s)
    kv_lens = (None if lens is None else
               np.repeat(np.asarray(lens, np.int32)[:, None], h, 1))

    def jf(q, k, v, bias):
        return jflash(q, k, v, causal=causal, bias=bias,
                      kv_lens=None if kv_lens is None
                      else jnp.asarray(kv_lens),
                      dropout_rate=RATE, dropout_seed=jnp.int32(seed))

    want = _vjp(jf, (q, k, v, bias), do)
    got = _port((q, k, v, bias), do, causal=causal, dropout_seed=seed,
                kv_lens=None if kv_lens is None else torch.tensor(kv_lens))
    _assert_match(got, want, NAMES)


def test_key_padding_head_major_rows_match_reference(ref_mode):
    """The key-padding route's operands: (h, b, s, d) views permuted from
    (b, s, h, d) tensors and a (b, sq, sk) −1e9 bias, so q-head row t =
    h_i·b + b_i hashes its mask and reads bias row t % b = b_i — on both
    sides, the views' flattened leading index, not a row in memory
    order."""
    b, s, h, d, seed = 3, 128, 2, 64, 31337
    rng = np.random.default_rng(5)
    q, k, v, do = (_f(rng, b, s, h, d) for _ in range(4))
    pad = np.zeros((b, s), bool)
    pad[1, 100:] = True
    pad[2, 9:] = True
    bias = np.broadcast_to(np.where(pad[:, None, :], np.float32(-1e9),
                                    np.float32(0)), (b, s, s)).copy()
    perm = (2, 0, 1, 3)

    def jf(q, k, v, bias):
        return jflash(*(x.transpose(perm) for x in (q, k, v)), bias=bias,
                      dropout_rate=RATE, dropout_seed=jnp.int32(seed)
                      ).transpose(1, 2, 0, 3)

    want = _vjp(jf, (q, k, v, bias), do)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    o = amod.flash_attention(*(x.permute(perm) for x in ts[:3]), bias=ts[3],
                             dropout_rate=RATE, dropout_seed=seed)
    o = o.permute(1, 2, 0, 3)
    o.backward(torch.tensor(do))
    got = [o.detach().numpy()] + [t.grad.numpy() for t in ts]
    _assert_match(got, want, NAMES)
    # the batch-major rows (t = b_i·h + h_i) draw another mask
    other = amod.flash_attention(*(x.detach().transpose(1, 2)
                                   for x in ts[:3]),
                                 bias=ts[3].detach().repeat_interleave(h, 0),
                                 dropout_rate=RATE, dropout_seed=seed)
    assert not np.allclose(other.transpose(1, 2).numpy(), got[0])


@pytest.mark.parametrize("h,h_kv,hb", [(2, 2, 2), (4, 2, 1)])
def test_bshd_bias_dropout_matches_reference(ref_mode, h, h_kv, hb):
    """The seq-major layout with per-batch kv_lens and an (hb, sq, sk)
    mask, hb | h: q-head row t = b·h + head on both sides (the reference's
    gate sends d 64 multi-head to its XLA path, so interpret mode calls
    its core with the Pallas flag)."""
    b, s, d, seed = 2, 128, 64, -99
    rng = np.random.default_rng(h * 10 + hb)
    q, k, v, do = (_f(rng, b, s, h, d), _f(rng, b, s, h_kv, d),
                   _f(rng, b, s, h_kv, d), _f(rng, b, s, h, d))
    bias = 0.5 * _f(rng, hb, s, s)
    lens = np.asarray([128, 60], np.int32)
    lj = jnp.asarray(lens)

    def jf(q, k, v, bias):
        return _flash_core_bshd(q, k, v, bias, lj, jnp.int32(seed),
                                d ** -0.5, False, ref_mode == "interpret",
                                RATE)

    want = _vjp(jf, (q, k, v, bias), do)
    got = _port((q, k, v, bias), do, layout="bshd", dropout_seed=seed,
                kv_lens=torch.tensor(lens))
    _assert_match(got, want, NAMES)


def test_seed_from_key_and_key_seed():
    """seed_from_key draws one int32 from a generator (the same seed,
    the same draw); key_seed takes a generator, an int or a one-element
    tensor, and refuses what is no int32."""
    a = amod.seed_from_key(torch.Generator().manual_seed(4))
    assert a == amod.seed_from_key(torch.Generator().manual_seed(4))
    assert -2 ** 31 <= a < 2 ** 31 and isinstance(a, int)
    g = torch.Generator().manual_seed(4)
    assert amod.key_seed(g) == a and amod.key_seed(g) != a
    assert amod.key_seed(-7) == -7
    assert amod.key_seed(torch.tensor(2 ** 31 - 1)) == 2 ** 31 - 1
    with pytest.raises(ValueError, match="int32"):
        amod.key_seed(2 ** 31)
    with pytest.raises(TypeError, match="Generator"):
        amod.seed_from_key(3)
