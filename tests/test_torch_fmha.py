"""Port parity for ``contrib.fmha``: apex_tpu_torch's ``fmha_varlen``,
``FMHA``, ``fmha`` and ``FMHAFun`` against apex_tpu's on seeded numpy
inputs, forward and the packed qkv's gradient: token-packed rows of
ragged lengths (a row of length 0 among them) scattered to the padded
bshd layout with per-batch lengths, with and without dropout 0.1 (the
reference's seed for its PRNG key passed as ``key=``), causal and not;
the equal-length padded layout. ``max_s`` shorter than a row and dropout
without a key are refused by both.

The reference runs its own CPU dispatch; the port its plain versions (CPU
tensors). fp32, full-precision matmuls. Tolerances: outputs within 1e-5,
gradients within 2e-4 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import fmha as jf
from apex_tpu.ops.attention import seed_from_key as j_seed
from apex_tpu_torch.contrib import fmha as tf

H, D = 2, 32
LENS = [9, 16, 0, 5]
O_TOL = dict(rtol=1e-5, atol=1e-5)


def _check(got, want, grad, gwant):
    np.testing.assert_allclose(got, want, **O_TOL)
    gwant = np.asarray(gwant)
    np.testing.assert_allclose(grad, gwant, rtol=0,
                               atol=2e-4 * np.abs(gwant).max())


def _packed(seed):
    rng = np.random.default_rng(seed)
    total = sum(LENS)
    qkv = rng.standard_normal((total, 3, H, D)).astype(np.float32)
    cot = rng.standard_normal((total, H, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(LENS)]).astype(np.int32)
    return qkv, cot, cu


@pytest.mark.parametrize("rate,causal", [(0.0, False), (0.1, True),
                                         (0.1, False)])
def test_fmha_varlen_matches_reference(rate, causal):
    qkv, cot, cu = _packed(int(rate * 10) + causal)
    max_s = 16
    jkey = jax.random.PRNGKey(4)

    def jloss(x):
        o = jf.fmha_varlen(x, jnp.asarray(cu), max_s, rate, True, causal,
                           key=jkey if rate else None)
        return jnp.sum(o * cot), o

    with jax.default_matmul_precision("highest"):
        (_, jo), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jnp.asarray(qkv))
    x = torch.tensor(qkv, requires_grad=True)
    o = tf.fmha_varlen(x, torch.tensor(cu), max_s, rate, True, causal,
                       key=int(j_seed(jkey)) if rate else None)
    o.backward(torch.tensor(cot))
    _check(o.detach().numpy(), np.asarray(jo), x.grad.numpy(), jg)


def test_fmha_module_and_padded_layout_match_reference():
    """FMHA over the flat (total, 3·h·d) layout in eval mode (dropout
    off), and fmha / FMHAFun.apply on the padded (b, s, 3, h, d) layout,
    causal."""
    qkv, cot, cu = _packed(7)
    total = qkv.shape[0]
    jmod, tmod = jf.FMHA(H, D, p_dropout=0.1), tf.FMHA(H, D, p_dropout=0.1)
    want = jmod(jnp.asarray(qkv.reshape(total, -1)), jnp.asarray(cu), 16,
                is_training=False)
    got = tmod(torch.tensor(qkv.reshape(total, -1)), torch.tensor(cu), 16,
               is_training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)
    rng = np.random.default_rng(8)
    pad = rng.standard_normal((2, 24, 3, H, D)).astype(np.float32)
    cot = rng.standard_normal((2, 24, H, D)).astype(np.float32)

    def jloss(x):
        o = jf.fmha(x, causal=True)
        return jnp.sum(o * cot), o

    with jax.default_matmul_precision("highest"):
        (_, jo), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jnp.asarray(pad))
    x = torch.tensor(pad, requires_grad=True)
    o = tf.FMHAFun.apply(x, True)
    o.backward(torch.tensor(cot))
    _check(o.detach().numpy(), np.asarray(jo), x.grad.numpy(), jg)
    assert torch.equal(tf.fmha(x.detach(), True), o.detach())


def test_fmha_refusals_match_reference():
    """max_s shorter than a row (checked on every call here: the port's
    cu_seqlens are always concrete), dropout without a key, a qkv of the
    wrong shape: both refuse."""
    qkv, _, cu = _packed(1)
    for args, kw in (((15,), {}), ((16, 0.1, True), {}),
                     ((16,), dict(qkv=qkv[:, :2]))):
        x = kw.get("qkv", qkv)
        with pytest.raises(ValueError):
            jf.fmha_varlen(jnp.asarray(x), jnp.asarray(cu), *args)
        with pytest.raises(ValueError):
            tf.fmha_varlen(torch.tensor(x), torch.tensor(cu), *args)
    # is_training=False turns dropout off without a key
    o = tf.fmha_varlen(torch.tensor(qkv), torch.tensor(cu), 16, 0.1, False)
    assert o.shape == (qkv.shape[0], H, D)
