"""The decode kernels' host-side launch plan and split walk, on the CPU:
what ``apex_tpu_torch/ops/decode_attention.py`` decides before it launches
``csrc/paged_decode_attn.cu``, and the kernel's arithmetic emulated.

* ``_decode_plan`` at the legs' shapes (serve: 64 rows, 8 blocks; decode:
  128 rows, max_s 1024; their GQA forms with 2 kv heads; the spec leg's 8
  rows; one block; one row): the split S within {1, 2, 4, 8}, S = 1
  where the rows already fill the card (one CTA an SM), the ring sized to
  the CTAs that share an SM, the shared memory within a CTA's 227 KB, the
  grid;
* ``split_blocks``: the strided shares partition a row's live blocks in
  order, and a live prefix is spread evenly;
* a plain fp32 emulation of the kernel's walk — rank r of a row's cluster
  runs the online softmax over blocks r, r + S, ... (live rows only, p
  rounded to V's dtype, l from the unrounded p), and rank 0 merges the
  states in rank order — held against the JAX reference's
  ``decode_attn_paged_fwd`` and ``decode_attn_fwd`` in interpret mode and
  against its XLA path, within 1e-5 (fp32 sums in another order), at
  S in {1, 2, 4, 8} with ragged lengths that include 0, 1, a block edge
  and the full table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.decode_attention import decode_attention as jdecode
from apex_tpu.ops.pallas.decode_attention import (decode_attn_fwd,
                                                  decode_attn_paged_fwd)
from apex_tpu_torch.ops import decode_attention as D

H100_SMS = 132
TOL = dict(rtol=1e-5, atol=1e-5)


# --- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("rows,nb,bs,group,splits", [
    (64, 8, 128, 1, 2),     # serve: 8 slots x 8 kv heads, 1024 / 128
    (16, 8, 128, 4, 8),     # serve, GQA: 8 slots x 2 kv heads
    (128, 8, 128, 1, 1),    # decode: 16 x 8 rows, max_s 1024
    (32, 8, 128, 4, 4),     # decode, GQA: 16 x 2 kv heads
    (8, 8, 128, 1, 8),      # the spec leg: batch 1
    (64, 1, 128, 1, 1),     # one block: nothing to split
    (1, 8, 128, 1, 8),      # one row
    (1, 2, 128, 1, 2),      # one row, two blocks
    (66, 8, 128, 1, 2),     # 132 CTAs: one an SM
    (67, 8, 128, 1, 1),
    (264, 8, 128, 1, 1),
    (1024, 8, 128, 1, 1),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_at_the_legs_shapes(rows, nb, bs, group, splits, dtype):
    plan = D._decode_plan(rows, nb, bs, 128, group, dtype, H100_SMS)
    assert plan.splits == splits
    assert plan.splits in D.DECODE_SPLITS
    assert 2 <= plan.tiles <= D.DECODE_MAX_TILES
    assert plan.tiles <= max(2, 2 * -(-nb // plan.splits))
    elem = 2 if dtype == torch.bfloat16 else 4
    assert plan.smem == D.decode_smem(elem, 128, group, bs, plan.tiles,
                                      plan.splits)
    assert plan.smem <= D.SMEM_PER_CTA
    # the ring holds at least one block's K and V
    assert plan.smem >= 2 * bs * 128 * elem


@pytest.mark.parametrize("rows,nb,tiles,per_sm", [
    (64, 8, 4, 1),    # serve: S 2, two blocks a rank, both in flight
    (128, 8, 4, 1),   # decode: S 1, the ring's most
    (8, 8, 2, 1),     # spec: S 8, one block a rank
    (320, 8, 3, 2),   # more CTAs than SMs: two share an SM
])
def test_ring_fits_the_ctas_that_share_an_sm(rows, nb, tiles, per_sm):
    plan = D._decode_plan(rows, nb, 128, 128, 1, torch.bfloat16, H100_SMS)
    assert plan.tiles == tiles
    share = D.SMEM_PER_SM // per_sm - D.SMEM_RESERVED
    assert plan.smem <= share
    if tiles < min(D.DECODE_MAX_TILES, 2 * -(-nb // plan.splits)):
        assert D.decode_smem(2, 128, 1, 128, tiles + 1, plan.splits) > share


@pytest.mark.parametrize("rows", [1, 7, 16, 17, 33, 64, 66, 67, 131, 132,
                                  133, 5000])
@pytest.mark.parametrize("nb", [1, 2, 3, 8, 64])
def test_splits_fill_the_card_once_and_never_outnumber_the_blocks(rows,
                                                                  nb):
    s = D.decode_splits(rows, nb, H100_SMS)
    assert s in D.DECODE_SPLITS and s <= nb
    assert s == 1 or rows * s <= H100_SMS
    # the largest such: doubling would pass the cap, the blocks or the SMs
    assert s == 8 or 2 * s > nb or rows * 2 * s > H100_SMS


@pytest.mark.parametrize("rows,nb,group", [(64, 8, 1), (16, 8, 4),
                                           (128, 8, 1), (8, 8, 16)])
@pytest.mark.parametrize("kv_dtype,maxd", [(torch.int8, 0),
                                           (torch.float8_e4m3fn, 0),
                                           (None, 128), (None, 32)])
def test_option_plans_lay_out_the_options(rows, nb, group, kv_dtype, maxd):
    """A quantized pool's ring holds 1-byte cells and, beside each slot,
    its block's bs fp32 scales; the bias adds the group's (maxd + 1)
    lookup values a head. The split is the float plan's (it never reads
    the options)."""
    base = D._decode_plan(rows, nb, 128, 128, group, torch.bfloat16,
                          H100_SMS)
    plan = D._decode_plan(rows, nb, 128, 128, group, torch.bfloat16,
                          H100_SMS, kv_dtype, maxd)
    assert plan.splits == base.splits
    quant = kv_dtype is not None
    assert plan.smem == D.decode_smem(2, 128, group, 128, plan.tiles,
                                      plan.splits, 1 if quant else 2, quant,
                                      maxd) <= D.SMEM_PER_CTA
    if quant and plan.tiles == base.tiles:
        ring = plan.tiles * 128 * 128
        parts = 8 * group * 128 * 4
        assert plan.smem - base.smem == (max(ring, parts) - max(2 * ring,
                                                                parts)
                                         + plan.tiles * 128 * 4)
    if not quant:
        assert plan.tiles == base.tiles
        assert plan.smem - base.smem == -(-group * (maxd + 1) * 4 // 16) * 16


def test_plan_depends_on_the_shapes_alone():
    a = D._decode_plan(64, 8, 128, 128, 1, torch.bfloat16, H100_SMS)
    assert D._decode_plan(64, 8, 128, 128, 1, torch.bfloat16,
                          H100_SMS) is a
    assert D._decode_plan(64, 8, 128, 128, 1, torch.bfloat16, 264) != a


@pytest.mark.parametrize("nblk", [0, 1, 4, 5, 7, 8, 9, 64])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_blocks_partition_the_walk_in_order(nblk, splits):
    shares = D.split_blocks(nblk, splits)
    assert len(shares) == splits
    assert sorted(j for share in shares for j in share) == list(range(nblk))
    for r, share in enumerate(shares):
        assert list(share) == sorted(share)
        assert all(j % splits == r for j in share)
    sizes = [len(share) for share in shares]
    assert max(sizes) - min(sizes) <= 1  # a live prefix spreads evenly


def test_split_blocks_spread_a_half_live_table():
    # 512 live rows of a 1024-row table: one block to each of 4 ranks
    assert D.split_blocks(4, 4) == ((0,), (1,), (2,), (3,))


# --- the kernel's arithmetic, emulated -------------------------------------------

def split_walk(q, k_rows, v_rows, length, splits, bs, scale):
    """One row of the kernel in fp32: q (G, d); k_rows / v_rows the row's
    (nb·bs, d) logical keys and values; each rank's online softmax over its
    strided blocks, then rank 0's merge in rank order. Returns (G, d)."""
    nblk = -(-min(length, k_rows.shape[0]) // bs)
    states = []
    for share in D.split_blocks(nblk, splits):
        m = np.full((q.shape[0], 1), -1e30, np.float32)
        l = np.zeros((q.shape[0], 1), np.float32)
        acc = np.zeros(q.shape, np.float32)
        for j in share:
            live = min(bs, length - j * bs)
            k = k_rows[j * bs:j * bs + live]
            v = v_rows[j * bs:j * bs + live]
            s = (q @ k.T) * np.float32(scale)
            m_new = np.maximum(m, s.max(axis=1, keepdims=True))
            alpha = np.exp(m - m_new)
            p = np.exp(s - m_new)
            l = l * alpha + p.sum(axis=1, keepdims=True)
            acc = acc * alpha + p.astype(v.dtype) @ v
            m = m_new
        states.append((m, l, acc))
    mx = np.max([m for m, _, _ in states], axis=0)
    l = np.zeros_like(mx)
    acc = np.zeros(q.shape, np.float32)
    for m, lr, ar in states:  # rank order
        w = np.exp(m - mx)
        l = l + w * lr
        acc = acc + w * ar
    return acc / np.maximum(l, np.float32(1e-30))


def _paged_case(h, h_kv, lengths, d=64, bs=128, nb=4, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    num_blocks = b * nb + 1
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    pk = rng.standard_normal((num_blocks, h_kv, bs, d)).astype(np.float32)
    pv = rng.standard_normal((num_blocks, h_kv, bs, d)).astype(np.float32)
    ids = list(rng.permutation(np.arange(1, num_blocks)))
    tables = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lengths):
        for j in range(min(-(-n // bs), nb)):
            tables[i, j] = ids.pop()
    return q, pk, pv, tables, np.asarray(lengths, np.int32)


def emulate_paged(q, pk, pv, tables, lengths, splits, scale):
    b, h, d = q.shape
    _, h_kv, bs, _ = pk.shape
    group = h // h_kv
    out = np.zeros(q.shape, np.float32)
    for i in range(b):
        for kvh in range(h_kv):
            k_rows = pk[tables[i], kvh].reshape(-1, d)
            v_rows = pv[tables[i], kvh].reshape(-1, d)
            heads = slice(kvh * group, (kvh + 1) * group)
            out[i, heads] = split_walk(q[i, heads], k_rows, v_rows,
                                       int(lengths[i]), splits, bs, scale)
    return out


def emulate_contiguous(q, k, v, lengths, splits, scale):
    b, h, d = q.shape
    h_kv = k.shape[1]
    group = h // h_kv
    out = np.zeros(q.shape, np.float32)
    for i in range(b):
        for kvh in range(h_kv):
            heads = slice(kvh * group, (kvh + 1) * group)
            out[i, heads] = split_walk(q[i, heads], k[i, kvh], v[i, kvh],
                                       int(lengths[i]), splits,
                                       D.KERNEL_CACHE_TILE, scale)
    return out


# 4 blocks of 128 a slot: 0, 1, a block edge and its neighbour, the full
# table and past it (clamped)
PAGED_CASES = [
    pytest.param(8, 2, [0, 1, 128, 129, 512, 300], id="gqa"),
    pytest.param(4, 4, [512, 127, 0, 700], id="mha"),
]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("h,h_kv,lengths", PAGED_CASES)
def test_split_walk_matches_reference_paged_pallas(splits, h, h_kv,
                                                   lengths):
    q, pk, pv, tables, lens = _paged_case(h, h_kv, lengths, seed=splits)
    b, _, d = q.shape
    scale = d ** -0.5
    got = emulate_paged(q, pk, pv, tables, lens, splits, scale)
    group = h // h_kv
    nblocks, _, bs, _ = pk.shape
    want = decode_attn_paged_fwd(
        jnp.asarray(q.reshape(b * h_kv, group, d)),
        jnp.asarray(pk.reshape(nblocks * h_kv, bs, d)),
        jnp.asarray(pv.reshape(nblocks * h_kv, bs, d)),
        jnp.asarray(np.repeat(np.minimum(lens, 4 * bs), h_kv)),
        jnp.asarray(tables), scale=scale, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want).reshape(b, h, d),
                               **TOL)
    assert not got[lens == 0].any()


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("h,h_kv,lengths", PAGED_CASES)
def test_split_walk_matches_reference_paged_xla(splits, h, h_kv, lengths):
    q, pk, pv, tables, lens = _paged_case(h, h_kv, lengths, seed=10 + splits)
    scale = q.shape[2] ** -0.5
    got = emulate_paged(q, pk, pv, tables, lens, splits, scale)
    want = jdecode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                   jnp.asarray(lens), block_tables=jnp.asarray(tables),
                   scale=scale, impl="xla")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _contiguous_case(h, h_kv, lengths, max_s=512, d=64, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, max_s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, max_s, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


CONTIGUOUS_CASES = [
    pytest.param(8, 2, [0, 1, 128, 129, 512], id="gqa"),
    pytest.param(4, 4, [300, 511, 0, 127], id="mha"),
]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("h,h_kv,lengths", CONTIGUOUS_CASES)
def test_split_walk_matches_reference_contiguous_pallas(splits, h, h_kv,
                                                        lengths):
    q, k, v, lens = _contiguous_case(h, h_kv, lengths, seed=20 + splits)
    b, _, d = q.shape
    max_s = k.shape[2]
    scale = d ** -0.5
    got = emulate_contiguous(q, k, v, lens, splits, scale)
    group = h // h_kv
    want = decode_attn_fwd(
        jnp.asarray(q.reshape(b * h_kv, group, d)),
        jnp.asarray(k.reshape(b * h_kv, max_s, d)),
        jnp.asarray(v.reshape(b * h_kv, max_s, d)),
        jnp.asarray(np.repeat(lens, h_kv)), scale=scale, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want).reshape(b, h, d),
                               **TOL)
    assert not got[lens == 0].any()


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("h,h_kv,lengths", CONTIGUOUS_CASES)
def test_split_walk_matches_reference_contiguous_xla(splits, h, h_kv,
                                                     lengths):
    q, k, v, lens = _contiguous_case(h, h_kv, lengths, seed=30 + splits)
    scale = q.shape[2] ** -0.5
    got = emulate_contiguous(q, k, v, lens, splits, scale)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(lens), scale=scale, impl="xla")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_split_walk_equals_the_port_plain_version():
    """The emulation at the plan's S for the serve shape against the
    port's own plain version (the CPU path of ``decode_attention``)."""
    q, pk, pv, tables, lens = _paged_case(8, 8, [0, 1, 128, 129, 512, 300,
                                                 400, 511], d=64, nb=4)
    scale = 64 ** -0.5
    splits = D._decode_plan(64, 4, 128, 64, 1, torch.float32,
                            H100_SMS).splits
    got = emulate_paged(q, pk, pv, tables, lens, splits, scale)
    want = D.decode_attention(torch.from_numpy(q), torch.from_numpy(pk),
                              torch.from_numpy(pv), torch.from_numpy(lens),
                              block_tables=torch.from_numpy(tables),
                              scale=scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)
