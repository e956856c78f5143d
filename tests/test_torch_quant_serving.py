"""Port parity: quantized KV pools (``ServingEngine(kv_dtype="int8" |
"fp8_e4m3")``) and decode attention with scales or the bucketed bias,
against apex_tpu's, on the CPU in fp32 (TF32 off).

* ``_quant_rows``: cells and scales equal to the reference's, bit for bit,
  on random rows, all-zero rows and planted ties (int8 .5 ties round half
  to even; fp8 ties between two e4m3 values round to the even mantissa).
* Quantized serves at the small GPT of ``test_torch_serving.py`` (2 slots
  of 16-row blocks, 32-token chunks, 9 blocks: chunked prefill, prefix
  hits and preemption): tokens, evictions and prefix hits equal the
  reference's serve request by request, ``pool_bytes`` equals its, and the
  final pool equals its final pool (the dead block aside: its rows take
  every dead write, in either framework's scatter order). The cells come
  from fp32 projections whose sums run in another order in the two
  frameworks, so a cell whose scaled value sits within ~1e-5 of a
  rounding boundary may round the other way: at most one step, in at most
  1 cell in 1000; the scales agree to 1e-5 relative.
* An int8 spec serve (chain and tree n-gram drafters) is token-identical
  to the int8 plain serve (the reference's ``tests/test_spec.py:389``).
* ``decode_attention`` with ``k_scale``/``v_scale`` and with a
  ``BucketedBias``: the port's CPU path against the reference's XLA path
  (2e-5), and the kernels' function (:func:`quant_decode_fp32`, the plain
  version with the bias) against the reference's Pallas kernels in
  interpret mode (2e-5 in fp32; one bf16 ulp for bf16 q).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import BucketedBias as JBucketedBias
from apex_tpu.ops.decode_attention import decode_attention as jdecode
from apex_tpu.ops.pallas.decode_attention import (decode_attn_fwd,
                                                  decode_attn_paged_fwd)
from apex_tpu.serving.engine import KV_QUANT_SPECS as JSPECS
from apex_tpu.serving.engine import ServingEngine as JServingEngine
from apex_tpu.serving.engine import _quant_rows as jquant_rows
from apex_tpu.serving.scheduler import Request as JRequest
from apex_tpu_torch.models.convert import serving_pool_from_jax
from apex_tpu_torch.ops.attention import BucketedBias
from apex_tpu_torch.ops.decode_attention import (decode_attention,
                                                 quant_decode_fp32)
from apex_tpu_torch.serving.engine import KV_QUANT_SPECS, ServingEngine
from apex_tpu_torch.serving.engine import _quant_rows
from apex_tpu_torch.serving.scheduler import Request
from apex_tpu_torch.spec import NGramDrafter, NGramTreeDrafter
from test_torch_serving import ENGINE, _models, _trace

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-5, atol=2e-5)
KV = ["int8", "fp8_e4m3"]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int32
                  ).numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.int32)


def _planted_rows(kv):
    """Rows whose amax makes the scale exactly 1 (amax = qmax), holding
    values that sit exactly on a rounding tie, and rows of zeros."""
    qmax = JSPECS[kv][0]
    if kv == "int8":
        ties = [0.5, 1.5, 2.5, -2.5, -3.5, 100.5, -126.5, 6.5]
    else:  # e4m3 steps of 2 on [16, 32), 8 on [64, 128), 32 on [256, 448]
        ties = [17.0, 19.0, -21.0, 68.0, 76.0, -84.0, 272.0, 304.0]
    rows = np.zeros((3, 2, 8), np.float32)
    rows[0, 0] = ties
    rows[0, 1, 0] = qmax
    rows[1, 0] = ties[::-1]
    rows[1, 1, 3] = -qmax
    return rows  # rows[2]: all zeros


@pytest.mark.parametrize("kv", KV)
def test_quant_rows_match_reference(kv):
    qmax, qdtype = KV_QUANT_SPECS[kv]
    assert qmax == JSPECS[kv][0]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 4, 2, 16)) * 3).astype(np.float32)
    x[1, 2] = 0.0                                      # all-zero rows
    x[3] *= 1e-30                                      # below the floor
    for dims, arr in (((2, 3), x), ((1, 2), _planted_rows(kv))):
        want_q, want_s = jquant_rows(jnp.asarray(arr), dims, qmax=qmax,
                                     qdtype=JSPECS[kv][1])
        got_q, got_s = _quant_rows(torch.from_numpy(arr), dims, qmax=qmax,
                                   qdtype=qdtype)
        assert got_q.dtype == qdtype
        np.testing.assert_array_equal(_bits(got_s), _ref_bits(want_s))
        np.testing.assert_array_equal(_bits(got_q), _ref_bits(want_q))
    # the planted ties: half to even, and zero rows back to exact zeros
    q, s = _quant_rows(torch.from_numpy(_planted_rows(kv)), (1, 2),
                       qmax=qmax, qdtype=qdtype)
    assert s[0].item() == 1.0
    assert s[2].item() == np.float32(1e-20) / np.float32(qmax)
    if kv == "int8":
        assert q[0, 0].tolist() == [0, 2, 2, -2, -4, 100, -126, 6]
    else:
        assert q[0, 0].float().tolist() == [16, 20, -20, 64, 80, -80, 256,
                                            320]
    assert not (q[2].float() * s[2]).any()


def _serve_both(kv, num_kv_heads=None, **kw):
    jm, jp, tm, tp = _models(num_kv_heads)
    trace = _trace(7, 8, 256, (4, 40), (2, 24), 32)
    args = dict(ENGINE, kv_dtype=kv, **kw)
    je = JServingEngine(jm, **args)
    te = ServingEngine(tm, device="cpu", **args)
    jsched, tsched = je.make_scheduler(), te.make_scheduler()
    jdone = je.serve(jp, [JRequest(rid=r, prompt=p, max_new_tokens=n)
                          for r, p, n in trace], clock=lambda: 0.0,
                     scheduler=jsched, telemetry=False)
    tdone = te.serve(tp, [Request(rid=r, prompt=p, max_new_tokens=n)
                          for r, p, n in trace], clock=lambda: 0.0,
                     scheduler=tsched)
    return je, te, jsched, tsched, jdone, tdone, trace


@pytest.mark.parametrize("num_kv_heads", [None, 2])
@pytest.mark.parametrize("kv", KV)
def test_quantized_serve_matches_reference(kv, num_kv_heads):
    je, te, jsched, tsched, jdone, tdone, trace = _serve_both(
        kv, num_kv_heads)
    assert len(tdone) == len(trace)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for jr, tr in zip(jdone, tdone):
        assert tr.tokens == [int(t) for t in jr.tokens], tr.rid
        assert tr.evictions == jr.evictions
        assert tr.prefix_hit_blocks == jr.prefix_hit_blocks
    assert tsched.preemptions == jsched.preemptions > 0
    assert sum(r.prefix_hit_blocks for r in tdone) > 0
    js, ts = je.last_stats, te.last_stats
    assert (ts.decode_steps, ts.prefill_chunks, ts.blocks_high_water) \
        == (js.decode_steps, js.prefill_chunks, js.blocks_high_water)
    tsched.allocator.check_accounting()
    assert te.pool_bytes() == je.pool_bytes()

    want = serving_pool_from_jax({k: np.asarray(v)
                                  for k, v in je.last_pool.items()})
    got = te.last_pool
    assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
    for name in ("k", "v"):
        assert got[name].dtype == KV_QUANT_SPECS[kv][1]
        g, w = got[name][:, 1:].float(), want[name][:, 1:].float()
        np.testing.assert_allclose(got[name + "_scale"][:, 1:].numpy(),
                                   want[name + "_scale"][:, 1:].numpy(),
                                   rtol=1e-5, atol=0)
        differ = (g != w)
        assert differ.float().mean().item() <= 1e-3, name
        # a differing cell is one rounding step away: the next value of
        # the format at the larger magnitude (int8: 1; e4m3: 1/8 of it)
        step = 1.0 if kv == "int8" else torch.maximum(g.abs(), w.abs()) / 8
        assert ((g - w).abs() <= step + 1e-6)[differ].all(), name


def test_pool_layout_and_bytes():
    _, _, tm, _ = _models(num_kv_heads=2)
    for kv in KV:
        te = ServingEngine(tm, device="cpu", kv_dtype=kv, **ENGINE)
        pool = te.init_pool()
        assert pool["k"].shape == (2, 9, 2, 16, 16)
        assert pool["k"].dtype == KV_QUANT_SPECS[kv][1]
        assert pool["k_scale"].shape == (2, 9, 16)
        assert pool["v_scale"].dtype == torch.float32
        cells = pool["k"].numel()
        assert te.pool_bytes() == 2 * cells + 2 * pool["k_scale"].numel() * 4
    with pytest.raises(ValueError, match="kv_dtype must be None"):
        ServingEngine(tm, device="cpu", kv_dtype="fp8", **ENGINE)


@pytest.mark.parametrize("draft", ["chain", "tree"])
def test_int8_spec_serve_matches_int8_plain(draft):
    _, _, tm, tp = _models()
    trace = _trace(3, 6, 256, (4, 40), (2, 24), 32)

    def run(drafter):
        eng = ServingEngine(tm, device="cpu", kv_dtype="int8",
                            **dict(ENGINE, num_blocks=None))
        done = eng.serve(tp, [Request(rid=r, prompt=p, max_new_tokens=n)
                              for r, p, n in trace], clock=lambda: 0.0,
                         draft=drafter)
        return eng, {r.rid: r.tokens for r in done}

    _, plain = run(None)
    eng, spec = run(NGramDrafter(k=3) if draft == "chain"
                    else NGramTreeDrafter(depth=3, branching=2))
    assert spec == plain
    assert eng.last_stats.spec_rounds > 0
    assert eng.last_stats.tree_rounds > 0 if draft == "tree" else True


def _pool_case(h, h_kv, lengths, kv, d=64, bs=128, nb=4, seed=0,
               qdtype=np.float32):
    """q, a shuffled quantized pool (the reference's _quant_rows over each
    block row) and tables covering each slot's live blocks."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    num_blocks = b * nb + 1
    q = rng.standard_normal((b, h, d)).astype(qdtype)
    qmax, jq = JSPECS[kv]
    pools = []
    for _ in range(2):
        x = rng.standard_normal((num_blocks, h_kv, bs, d)).astype(np.float32)
        cells, scales = jquant_rows(jnp.asarray(x.transpose(0, 2, 1, 3)),
                                    (2, 3), qmax=qmax, qdtype=jq)
        pools.append((np.asarray(cells).transpose(0, 2, 1, 3).copy(),
                      np.asarray(scales)))
    ids = list(rng.permutation(np.arange(1, num_blocks)))
    tables = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // bs)):
            tables[i, j] = ids.pop()
    return q, pools, tables, np.asarray(lengths, np.int32)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


CASES = [
    pytest.param(8, 2, [5, 300, 0, 512], id="gqa-ragged-dead"),
    pytest.param(4, 4, [128, 1, 0, 257], id="mha-block-edges"),
]


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("h,h_kv,lengths", CASES)
def test_quantized_decode_matches_reference(h, h_kv, lengths, kv):
    q, ((kc, ks), (vc, vs)), tables, lens = _pool_case(h, h_kv, lengths, kv)
    want = jdecode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                   jnp.asarray(lens), block_tables=jnp.asarray(tables),
                   k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                   impl="xla")
    got = decode_attention(_t(q), _t(kc), _t(vc), _t(lens),
                           block_tables=_t(tables), k_scale=_t(ks),
                           v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[torch.from_numpy(lens) == 0].any()


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,h_kv,lengths", CASES)
def test_quant_kernel_function_matches_pallas_interpret(h, h_kv, lengths,
                                                        qdtype, kv):
    """The quantized kernel's fp32 function against the Pallas kernel's
    quant branch run in interpret mode."""
    q, ((kc, ks), (vc, vs)), tables, lens = _pool_case(
        h, h_kv, lengths, kv, seed=2)
    b, _, d = q.shape
    jq = jnp.asarray(q).astype(qdtype)
    rows, group = b * h_kv, h // h_kv
    want = decode_attn_paged_fwd(
        jq.reshape(rows, group, d),
        jnp.asarray(kc).reshape(-1, 128, d),
        jnp.asarray(vc).reshape(-1, 128, d), jnp.repeat(jnp.asarray(lens),
                                                       h_kv),
        jnp.asarray(tables), scale=d ** -0.5, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True).reshape(b, h, d)
    got = quant_decode_fp32(_t(np.asarray(jq)), _t(kc), _t(vc), _t(lens),
                            _t(tables), _t(ks), _t(vs))
    want = np.asarray(want.astype(jnp.float32))
    tol = TOL if qdtype == "float32" else dict(rtol=2 ** -8, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _bias(h, seed, max_distance=64, buckets=16):
    table = (np.random.default_rng(seed).standard_normal((buckets, h))
             * 0.5).astype(np.float32)
    return (table, JBucketedBias(jnp.asarray(table), bidirectional=False,
                                 max_distance=max_distance),
            BucketedBias(torch.from_numpy(table), bidirectional=False,
                         max_distance=max_distance))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
@pytest.mark.parametrize("h,h_kv,lengths", CASES)
def test_biased_decode_matches_reference(h, h_kv, lengths, paged):
    """The CPU path with the bias against the reference's XLA path, and
    against its Pallas kernels (the ``rel`` option) in interpret mode."""
    rng = np.random.default_rng(h + h_kv)
    b, d, bs, nb = len(lengths), 64, 128, 4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    _, jb, tb = _bias(h, seed=h)
    lens = np.asarray(lengths, np.int32)
    if paged:
        k = rng.standard_normal((b * nb + 1, h_kv, bs, d)).astype(np.float32)
        v = rng.standard_normal(k.shape).astype(np.float32)
        tables = rng.permutation(np.arange(1, b * nb + 1)).reshape(
            b, nb).astype(np.int32)
        kw = dict(block_tables=tables)
    else:
        k = rng.standard_normal((b, h_kv, nb * bs, d)).astype(np.float32)
        v = rng.standard_normal(k.shape).astype(np.float32)
        kw = {}
    jkw = {n: jnp.asarray(a) for n, a in kw.items()}
    tkw = {n: torch.from_numpy(a) for n, a in kw.items()}
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lens),
                           bias=tb, **tkw).numpy()
    for impl in ("xla", "pallas"):
        want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(lens), bias=jb, impl=impl, **jkw)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    plain = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(lens),
                             **tkw).numpy()
    live = lens > 0
    assert np.abs(got[live] - plain[live]).max() > 1e-3


def test_biased_contiguous_kernel_function_matches_pallas_interpret():
    """``decode_attn_fwd``'s rel option in interpret mode, called directly
    at the decode leg's layout (lengths per kv row), against the port's
    plain version with the bias."""
    rng = np.random.default_rng(9)
    b, h, h_kv, d, max_s = 3, 8, 2, 64, 256
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, max_s, d)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    lens = np.array([200, 1, 129], np.int32)
    _, jb, tb = _bias(h, seed=5, max_distance=128, buckets=32)
    group = h // h_kv
    want = decode_attn_fwd(
        jnp.asarray(q).reshape(b * h_kv, group, d),
        jnp.asarray(k).reshape(b * h_kv, max_s, d),
        jnp.asarray(v).reshape(b * h_kv, max_s, d),
        jnp.repeat(jnp.asarray(lens), h_kv), scale=d ** -0.5,
        rel_bias=(jb.kernel_operands()[0], (32, 128)),
        interpret=True).reshape(b, h, d)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lens),
                           bias=tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_zero_scales_fault_is_visible():
    """The chip's planted fault (every scale 1) is far from the function:
    the rule that holds the kernel refuses it."""
    q, ((kc, ks), (vc, vs)), tables, lens = _pool_case(8, 2, [300, 64],
                                                       "int8", seed=4)
    good = quant_decode_fp32(_t(q), _t(kc), _t(vc), _t(lens), _t(tables),
                             _t(ks), _t(vs))
    ones = torch.ones(ks.shape)
    bad = quant_decode_fp32(_t(q), _t(kc), _t(vc), _t(lens), _t(tables),
                            ones, ones)
    assert (good - bad).abs().max().item() > 1.0
