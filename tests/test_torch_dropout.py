"""Port parity for the counter-hash dropout: the mask
(``apex_tpu_torch.ops.attention.dropout_keep`` against
``apex_tpu.ops.pallas.attention.dropout_keep``) and the elementwise
dropout (``apex_tpu_torch.ops.dropout`` against ``apex_tpu.models.gpt.
_dropout``), on the same seeds.

Both are exact integer and IEEE computations, so the tolerance is 0: the
masks bit-identical over seeds at and near the int32 edges, q-head rows,
rows and columns up to 2^20 and the rates 0.1, 0.5 and 2^-25 (which rounds
to a zero threshold: every element kept); the dropout's outputs and
gradients bit-identical in fp32 and bf16, the bf16 divisor rounded as
JAX's weak typing rounds it (1 - 0.1 → bf16 0.8984375).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import _dropout as j_dropout
from apex_tpu.ops.attention import seed_from_key
from apex_tpu.ops.pallas.attention import dropout_keep as j_keep
from apex_tpu_torch.ops import attention as amod
from apex_tpu_torch.ops import dropout as dmod

SEEDS = (0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 2, -2 ** 31 + 1,
         123456789, -987654321)
RATES = (0.1, 0.5, 2.0 ** -25)


def _coords(seed):
    """Seeded q-head rows, rows and columns in [0, 2^20], the edges
    included, broadcastable as (t, 1, 1), (1, r, 1), (1, 1, c)."""
    rng = np.random.default_rng(abs(seed) % 1000)
    edge = np.array([0, 1, 2 ** 20 - 1, 2 ** 20], np.int32)
    t = np.concatenate([edge, rng.integers(0, 2 ** 20, 4)]).astype(np.int32)
    r = np.concatenate([edge, rng.integers(0, 2 ** 20, 12)]).astype(np.int32)
    c = np.concatenate([edge, rng.integers(0, 2 ** 20, 28)]).astype(np.int32)
    return t[:, None, None], r[None, :, None], c[None, None, :]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_keep_matches_reference(seed, rate):
    t, r, c = _coords(seed)
    want = np.asarray(j_keep(jnp.int32(seed), jnp.asarray(t), jnp.asarray(r),
                             jnp.asarray(c), rate))
    got = amod.dropout_keep(seed, torch.from_numpy(t), torch.from_numpy(r),
                            torch.from_numpy(c), rate).numpy()
    np.testing.assert_array_equal(got, want)
    # the seed as a tensor, t as an int: the same bits
    got_t = amod.dropout_keep(torch.tensor(seed, dtype=torch.int32),
                              int(t[3, 0, 0]), torch.from_numpy(r),
                              torch.from_numpy(c), rate).numpy()
    np.testing.assert_array_equal(got_t[0], want[3])
    if rate == 2.0 ** -25:
        assert amod.dropout_threshold(rate) == 0 and got.all()


def test_dropout_threshold_rounds_half_to_even():
    # rate * 2^24 = 0.5 and 2.5 round down to even, 1.5 up
    assert amod.dropout_threshold(2.0 ** -25) == 0
    assert amod.dropout_threshold(1.5 * 2.0 ** -24) == 2
    assert amod.dropout_threshold(2.5 * 2.0 ** -24) == 2
    assert amod.dropout_threshold(0.1) == round(0.1 * 2 ** 24)
    assert amod.dropout_scale(0.1) == float(np.float32(1.0 / 0.9))


def test_dense_mask_matches_reference():
    """The plain attention's (rows, sq, sk) mask against the reference's
    ``_dropout_keep_dense`` over b·h rows."""
    from apex_tpu.ops.attention import _dropout_keep_dense as j_dense
    for seed in (-3, 2 ** 31 - 1):
        want = np.asarray(j_dense(jnp.int32(seed), 6, 40, 72, 0.1))
        got = amod._dropout_keep_dense(seed, (2, 3), 40, 72, 0.1)
        np.testing.assert_array_equal(got.reshape(6, 40, 72).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 96), (2, 3, 40, 40), (5, 7)])
@pytest.mark.parametrize("rate", RATES)
def test_dropout_matches_reference(dtype, shape, rate):
    """Forward and gradient of the plain version (and of the autograd
    entry) bit-identical to ``gpt.py::_dropout`` under one key."""
    rng = np.random.default_rng(sum(shape))
    x32 = rng.standard_normal(shape).astype(np.float32)
    g32 = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for k in (0, 7):
        key = jax.random.PRNGKey(k)
        seed = int(seed_from_key(key))
        xj = jnp.asarray(x32).astype(jdt)
        y_j, vjp = jax.vjp(lambda a: j_dropout(a, rate, key), xj)
        (dx_j,) = vjp(jnp.asarray(g32).astype(jdt))
        x = torch.tensor(x32).to(tdt).requires_grad_()
        y = dmod.dropout(x, rate, seed)
        y.backward(torch.tensor(g32).to(tdt))
        np.testing.assert_array_equal(
            y.detach().float().numpy(), np.asarray(y_j.astype(jnp.float32)))
        np.testing.assert_array_equal(
            x.grad.float().numpy(), np.asarray(dx_j.astype(jnp.float32)))
        plain = dmod.dropout_plain(x.detach(), rate, seed)
        assert torch.equal(plain, y.detach())


def test_dropout_bf16_divisor_is_rounded():
    """3 / bf16(0.9) = 3.34375 (the rounded divisor), not 3.328125."""
    x = torch.full((1, 8), 3.0, dtype=torch.bfloat16)
    y = dmod.dropout_plain(x, 0.1, 0)
    kept = y[y != 0]
    assert kept.numel() and (kept.float() == 3.34375).all()
    assert dmod.divisor(0.1, torch.bfloat16) == 0.8984375


def test_dropout_refusals():
    x = torch.ones(4, 8)
    assert dmod.dropout(x, 0.0, 1) is x
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            dmod.dropout(x, rate, 1)
    with pytest.raises(ValueError, match="CUDA"):
        dmod.dropout_cuda(x, 0.1, 1)
