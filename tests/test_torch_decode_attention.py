"""Port parity: apex_tpu_torch's paged decode attention against apex_tpu's.

The port's plain version (the CPU path) is held against the reference's
XLA fallback and its Pallas kernel in interpret mode (as
``tests/test_serving.py`` runs it off-TPU: block 128, head_dim 64), at the
reference test's own tolerance, 2e-5, in fp32. The inputs are GQA and MHA,
ragged lengths including 0, and shuffled tables whose unused entries hold
the dead block. The CUDA kernel itself is held against the plain version
on the card by ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.decode_attention import decode_attention as jdecode
from apex_tpu_torch.ops import decode_attention as dmod
from apex_tpu_torch.ops.decode_attention import decode_attention

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(h, h_kv, lengths, d=64, bs=128, nb=4, seed=0, dtype=np.float32):
    """q, a shuffled pool and tables covering each slot's live blocks;
    table entries past a slot's length stay the dead block 0."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    num_blocks = b * nb + 1
    q = rng.standard_normal((b, h, d)).astype(dtype)
    pk = rng.standard_normal((num_blocks, h_kv, bs, d)).astype(dtype)
    pv = rng.standard_normal((num_blocks, h_kv, bs, d)).astype(dtype)
    ids = list(rng.permutation(np.arange(1, num_blocks)))
    tables = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // bs)):
            tables[i, j] = ids.pop()
    return q, pk, pv, tables, np.asarray(lengths, np.int32)


CASES = [
    pytest.param(8, 2, [5, 300, 0, 512], id="gqa-ragged-dead"),
    pytest.param(4, 4, [128, 1, 0, 257], id="mha-block-edges"),
    pytest.param(8, 1, [77, 0, 384, 2], id="mqa"),
]


def _port(q, pk, pv, tables, lengths, **kw):
    return decode_attention(torch.from_numpy(q), torch.from_numpy(pk),
                            torch.from_numpy(pv), torch.from_numpy(lengths),
                            block_tables=torch.from_numpy(tables), **kw
                            ).numpy()


@pytest.mark.parametrize("h,h_kv,lengths", CASES)
def test_plain_matches_reference_xla(h, h_kv, lengths):
    q, pk, pv, tables, lens = _case(h, h_kv, lengths)
    want = jdecode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                   jnp.asarray(lens), block_tables=jnp.asarray(tables),
                   impl="xla")
    got = _port(q, pk, pv, tables, lens)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert not got[np.asarray(lens) == 0].any(), "dead rows must be zeros"


@pytest.mark.parametrize("h,h_kv,lengths", CASES)
def test_plain_matches_reference_pallas_interpret(h, h_kv, lengths):
    q, pk, pv, tables, lens = _case(h, h_kv, lengths, seed=1)
    want = jdecode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                   jnp.asarray(lens), block_tables=jnp.asarray(tables),
                   impl="pallas")
    np.testing.assert_allclose(_port(q, pk, pv, tables, lens),
                               np.asarray(want), **TOL)


def test_explicit_scale_and_int64_tables():
    q, pk, pv, tables, lens = _case(8, 2, [40, 129, 0, 7], d=16, bs=16,
                                    nb=9)
    want = jdecode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                   jnp.asarray(lens), block_tables=jnp.asarray(tables),
                   impl="xla", scale=0.3)
    got = _port(q, pk, pv, tables.astype(np.int64), lens, scale=0.3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_later_slices_and_bad_inputs_raise():
    """The reference's validation errors, type for type: quantized pools
    and the bias are ported, so what raises is what the reference
    refuses."""
    from apex_tpu_torch.ops.attention import BucketedBias

    q, pk, pv, tables, lens = [torch.from_numpy(a) for a in
                               _case(8, 2, [5, 6], d=16, bs=16)]
    # without tables the pool is read as a contiguous (b, h_kv, max_s, d)
    # cache, whose batch it does not match
    with pytest.raises(ValueError, match="cache \\(b, h_kv, max_s, d\\)"):
        decode_attention(q, pk, pv, lens)
    with pytest.raises(ValueError, match="BucketedBias"):
        decode_attention(q, pk, pv, lens, block_tables=tables, bias=object())
    with pytest.raises(ValueError, match="causal"):
        decode_attention(q, pk, pv, lens, block_tables=tables,
                         bias=BucketedBias(torch.zeros(16, 8),
                                           bidirectional=True))
    with pytest.raises(ValueError, match="heads"):
        decode_attention(q, pk, pv, lens, block_tables=tables,
                         bias=BucketedBias(torch.zeros(16, 10)))
    qk, qv = pk.to(torch.int8), pv.to(torch.int8)
    sc = torch.ones(pk.shape[0], pk.shape[2])
    with pytest.raises(ValueError, match="BOTH k_scale and v_scale"):
        decode_attention(q, qk, qv, lens, block_tables=tables)
    with pytest.raises(ValueError, match="BOTH k_scale and v_scale"):
        decode_attention(q, pk, pv, lens, block_tables=tables, k_scale=sc,
                         v_scale=sc)
    with pytest.raises(ValueError, match="k_scale must be"):
        decode_attention(q, qk, qv, lens, block_tables=tables,
                         k_scale=sc[:, :3], v_scale=sc)
    with pytest.raises(ValueError, match="relative bias"):
        decode_attention(q, qk, qv, lens, block_tables=tables, k_scale=sc,
                         v_scale=sc, bias=BucketedBias(torch.zeros(16, 8)))
    with pytest.raises(ValueError, match="PAGED path only"):
        decode_attention(q, qk[:2], qv[:2], lens)
    with pytest.raises(ValueError, match="h_kv \\| h"):
        decode_attention(q[:, :3], pk, pv, lens, block_tables=tables)
    with pytest.raises(ValueError, match="block_tables"):
        decode_attention(q, pk, pv, lens, block_tables=tables[:1])
    with pytest.raises(ValueError, match="impl"):
        decode_attention(q, pk, pv, lens, block_tables=tables, impl="xla")


def test_cpu_tensor_never_reaches_the_kernel():
    q, pk, pv, tables, lens = _case(8, 2, [5, 6], d=16, bs=16)
    before = dmod.paged_decode_attn_cuda.launches
    _port(q, pk, pv, tables, lens)
    assert dmod.paged_decode_attn_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        dmod.paged_decode_attn_cuda(
            torch.from_numpy(q).reshape(4, 4, 16), torch.from_numpy(pk),
            torch.from_numpy(pv), torch.from_numpy(lens),
            torch.from_numpy(tables), scale=0.25)
