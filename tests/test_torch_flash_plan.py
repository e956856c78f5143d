"""The flash backward's host-side launch plan, on the CPU: what the
wrappers of ``apex_tpu_torch/ops/attention.py`` decide before they launch
the dQ and dK/dV kernels of ``csrc/flash_attn_bwd.cu``.

* the variant: ``"wgmma"`` unless a caller names ``"sm80"``; anything
  else raises;
* the TMA maps of the operands — one 4-D (d, row, head, batch) bf16 map
  per q, k, v and do, 64 x 64 boxes — for the packed buffer, the bh-flat
  views and the seq-major tensors, at every train leg's call;
* the array bias's staging: TMA where a map describes the fp32 (sk, sq,
  hb) bias (T5's encoder, sk 512), ``cp.async`` where none does (its
  decoder, sk 114: rows of 456 bytes);
* the kernels' walk (:func:`dkv_schedule`, :func:`dq_schedule`) against a
  brute-force mask under bottom-right causal alignment and ``kv_lens``:
  every live score is visited exactly once, no visited tile is fully
  masked, every kv tile gets its CTA (it writes dk and dv, zeros where no
  head reaches it), and the CTAs go longest first;
* the call order: dQ first (it writes delta), its delta handed to dK/dV;
* the planted faults the chip checks must refuse;
* the plain version of the dQ kernel's delta side output against
  rowsum(do·o), and the plain backward fed that delta against the JAX
  reference's backward on the same seeded numpy inputs (fp32; gradients
  within 2e-4 of the leaf's largest entry, as the other flash parity
  tests: sums in another order).

Shapes are the legs' own sequence lengths and head widths with the batch
(and, for the brute-force walks, the heads) cut; the plan depends on the
batch only through the batch stride and the CTA count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import flash_attention as jflash
from apex_tpu_torch.ops import attention as A

GRAD_RTOL = 2e-4


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _map(x4):
    return A._view_map(x4)


# --- the variant ------------------------------------------------------------

def test_default_variant_is_wgmma():
    q4 = _bf16(2, 4, 128, 64)
    plan = A._bwd_plan(q4, q4, q4, q4)
    assert plan.variant == "wgmma"
    assert set(plan.maps) == {"q", "k", "v", "do"}
    assert plan.bias_staging is None


@pytest.mark.parametrize("variant", ["wgmma", "sm80"])
def test_a_named_variant_is_taken(variant):
    q4 = _bf16(2, 4, 128, 64)
    plan = A._bwd_plan(q4, q4, q4, q4, torch.zeros(4, 128, 128), variant)
    assert plan.variant == variant
    if variant == "sm80":
        assert plan.maps == {} and plan.bias_staging == "global"
    else:
        assert plan.bias_staging == "tma"


@pytest.mark.parametrize("variant", ["sm90", "WGMMA", "auto", ""])
def test_an_unknown_variant_raises(variant):
    q4 = _bf16(1, 2, 64, 64)
    with pytest.raises(ValueError, match="no variant"):
        A._bwd_plan(q4, q4, q4, q4, variant=variant)


def test_no_map_for_a_misaligned_view_raises():
    buf = _bf16(1, 130, 2 * 64 + 8)
    q4 = buf[:, :, 8:8 + 128].unflatten(-1, (2, 64)).transpose(1, 2)
    q4 = q4[:, :, 1:]  # row 1 first: its base is 8 * 2 + row stride bytes in
    bad = buf.view(-1)[3:3 + 2 * 64 * 64].view(1, 2, 64, 64)  # 6 bytes off
    with pytest.raises(ValueError, match="no tensor map"):
        A._bwd_plan(bad, bad, bad, bad)


# --- the tensor maps at each leg's call ---------------------------------------

def test_packed_maps_gpt():
    """GPT's train step: q, k, v as the three sections of the packed (b,
    s, (h + 2·h_kv)·d) buffer — head stride d, row stride (h + 2·h_kv)·d."""
    b, s, h, hkv, d = 2, 1024, 8, 8, 128
    qkv = _bf16(b, s, (h + 2 * hkv) * d)
    do = _bf16(b, s, h * d)
    q4, k4, v4 = A._packed_views(qkv, h, hkv, d)
    plan = A._bwd_plan(q4, k4, v4, A._heads4(do, d))
    F = (h + 2 * hkv) * d
    for name, heads in (("q", h), ("k", hkv), ("v", hkv)):
        m = plan.maps[name]
        assert m.dtype == "bf16" and m.box == (64, 64, 1, 1)
        assert m.dims == (d, s, heads, b)
        assert m.strides == (2 * F, 2 * d, 2 * s * F)
    assert plan.maps["do"].strides == (2 * h * d, 2 * d, 2 * s * h * d)
    # each section's base: h·d and (h + h_kv)·d elements into the buffer
    assert k4.data_ptr() - qkv.data_ptr() == 2 * h * d
    assert v4.data_ptr() - qkv.data_ptr() == 2 * (h + hkv) * d


def test_packed_maps_gqa():
    b, s, h, hkv, d = 2, 1000, 8, 2, 64
    qkv = _bf16(b, s, (h + 2 * hkv) * d)
    q4, k4, v4 = A._packed_views(qkv, h, hkv, d)
    plan = A._bwd_plan(q4, k4, v4, q4)
    assert plan.maps["q"].dims == (d, s, h, b)
    assert plan.maps["k"].dims == (d, s, hkv, b)
    assert plan.maps["k"].strides == plan.maps["q"].strides


@pytest.mark.parametrize("sq,sk", [(512, 512), (114, 114), (114, 512)])
def test_flat_maps_t5_views(sq, sk):
    """T5's three attention calls: (b, h, s, d) views of (b, s, h·d)
    projection outputs."""
    b, h, d = 3, 12, 64
    q4 = _bf16(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
    kv = _bf16(b, sk, 2 * h * d)
    k4 = kv[..., :h * d].view(b, sk, h, d).transpose(1, 2)
    v4 = kv[..., h * d:].view(b, sk, h, d).transpose(1, 2)
    plan = A._bwd_plan(q4, k4, v4, q4)
    assert plan.maps["q"].dims == (d, sq, h, b)
    assert plan.maps["q"].strides == (2 * h * d, 2 * d, 2 * sq * h * d)
    assert plan.maps["k"].dims == (d, sk, h, b)
    assert plan.maps["k"].strides == (4 * h * d, 2 * d, 4 * sk * h * d)


def test_flat_maps_contiguous_rows():
    """A contiguous (b·h, s, d) caller: the (b, h, s, d) view of its rows."""
    b, h, s, d = 2, 4, 300, 128
    rows = _bf16(b * h, s, d)
    q4 = A._rows4(rows, h)
    plan = A._bwd_plan(q4, q4, q4, q4)
    assert plan.maps["q"].dims == (d, s, h, b)
    assert plan.maps["q"].strides == (2 * d, 2 * s * d, 2 * h * s * d)


def test_bshd_maps_bert():
    """BERT's seq-major q/k/v, views of one packed projection: the
    head-stride-d case."""
    b, s, h, d = 4, 512, 16, 64
    y = _bf16(b, s, 3 * h * d)
    q, k, v = (y[..., i * h * d:(i + 1) * h * d].view(b, s, h, d)
               for i in range(3))
    q4, k4, v4 = A._bshd_views(q, k, v)
    plan = A._bwd_plan(q4, k4, v4, q4)
    for name in ("q", "k", "v", "do"):
        assert plan.maps[name].dims == (d, s, h, b)
        assert plan.maps[name].strides == (6 * h * d, 2 * d, 6 * s * h * d)


def test_an_extent_one_axis_gets_a_stride_the_encoder_takes():
    """h_kv = 1 (the wrappers' head stride 0) and b = 1: never stepped,
    given the largest span of the other axes, rounded to 16 bytes."""
    k4 = A._rows4(_bf16(1, 200, 64), 1)
    m = _map(k4)
    assert m.dims == (64, 200, 1, 1)
    assert m.strides[0] == 128
    assert m.strides[1] == m.strides[2] == 128 * 200
    assert all(st % 16 == 0 for st in m.strides)


@pytest.mark.parametrize("d,bias,tiles", [
    (128, False, (64, 64)),    # GPT's packed call
    (64, False, (128, 128)),   # T5 (the table is no array bias), BERT
    (64, True, (64, 128)),     # T5 materialized: the bias block's room
    (128, True, (64, 64)),
])
def test_stage_tiles(d, bias, tiles):
    q4 = _bf16(2, 4, 256, d)
    arr = torch.zeros(4, 256, 256) if bias else None
    assert A._bwd_plan(q4, q4, q4, q4, arr).tiles == tiles
    assert A._bwd_plan(q4, q4, q4, q4, arr, "sm80").tiles is None


# --- the bias's staging -----------------------------------------------------

@pytest.mark.parametrize("sq,sk,hb,staging", [
    (512, 512, 12, "tma"),      # T5 materialized, encoder self-attention
    (114, 114, 12, "cp.async"),  # its decoder: 456-byte rows
    (512, 512, 1, "tma"),       # the bshd leg's hb 1
    (300, 300, 4, "tma"),
    (77, 77, 2, "cp.async"),
])
def test_bias_staging(sq, sk, hb, staging):
    d = 64
    q4 = _bf16(2, 12, sq, d)
    k4 = _bf16(2, 12, sk, d)
    bias = torch.zeros(hb, sq, sk)
    plan = A._bwd_plan(q4, k4, k4, q4, bias)
    assert plan.bias_staging == staging
    if staging == "tma":
        m = plan.maps["bias"]
        assert m.dtype == "fp32" and m.box == (32, 64, 1)
        assert m.dims == (sk, sq, hb)
        assert m.strides[:1] == (4 * sk,)
        if hb > 1:
            assert m.strides[1] == 4 * sk * sq
    else:
        assert "bias" not in plan.maps


# --- the walk against a brute-force mask --------------------------------------

def _live(b, h, sq, sk, causal, lens):
    """(b, h, sq, sk) bool: the scores the masks keep."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= k <= q + (sk - sq)
    out = np.broadcast_to(m, (b, h, sq, sk)).copy()
    if lens is not None:
        lim = np.clip(np.asarray(lens), 0, sk)
        out &= k[None, None] < lim[:, :, None, None]
    return out


def _check_dkv(b, h, hkv, sq, sk, causal, lens, q_tile):
    live = _live(b, h, sq, sk, causal, lens)
    seen = np.zeros(live.shape, np.int32)
    ctas = A.dkv_schedule(b, h, hkv, sq, sk, causal, lens, q_tile)
    nkv = -(-sk // A.DKV_KV_TILE)
    assert sorted((bi, kvh, k0) for bi, kvh, k0, _ in ctas) == sorted(
        (bi, kvh, t * A.DKV_KV_TILE) for bi in range(b) for kvh in range(hkv)
        for t in range(nkv)), "every kv tile gets one CTA"
    group = h // hkv
    for bi, kvh, k0, tiles in ctas:
        for hd, q0 in tiles:
            assert hd // group == kvh
            blk = (bi, hd, slice(q0, q0 + q_tile),
                   slice(k0, k0 + A.DKV_KV_TILE))
            assert live[blk].any(), f"fully masked tile visited: {hd, q0, k0}"
            seen[blk] += 1
    assert (seen[live] == 1).all(), "a live score missed or visited twice"
    assert seen.max() <= 1
    heads = [(bi, kvh) for bi, kvh, _, _ in ctas]
    assert heads == sorted(heads), "kv head by kv head"
    if causal:  # within a head, longest first: the work never grows
        for i in range(0, len(ctas), nkv):
            work = [len(t) for *_, t in ctas[i:i + nkv]]
            assert work == sorted(work, reverse=True)


def _check_dq(b, h, hkv, sq, sk, causal, lens, kv_tile):
    live = _live(b, h, sq, sk, causal, lens)
    seen = np.zeros(live.shape, np.int32)
    ctas = A.dq_schedule(b, h, hkv, sq, sk, causal, lens, kv_tile)
    nq = -(-sq // A.DQ_Q_TILE)
    assert sorted((bi, hd, q0) for bi, hd, q0, _ in ctas) == sorted(
        (bi, hd, t * A.DQ_Q_TILE) for bi in range(b) for hd in range(h)
        for t in range(nq)), "every query tile gets one CTA"
    for bi, hd, q0, k0s in ctas:
        for k0 in k0s:
            blk = (bi, hd, slice(q0, q0 + A.DQ_Q_TILE),
                   slice(k0, k0 + kv_tile))
            assert live[blk].any(), f"fully masked tile visited: {hd, q0, k0}"
            seen[blk] += 1
    assert (seen[live] == 1).all(), "a live score missed or visited twice"
    assert seen.max() <= 1
    heads = [(bi, hd) for bi, hd, _, _ in ctas]
    assert heads == sorted(heads), "head by head"
    for i in range(0, len(ctas), nq):
        q0s = [q0 for _, _, q0, _ in ctas[i:i + nq]]
        assert q0s == sorted(q0s, reverse=True), "the last query tiles first"


def _lens(b, h, lo, hi, seed, per_batch=True, zero=False):
    rng = np.random.default_rng(seed)
    if per_batch:
        lens = np.repeat(rng.integers(lo, hi + 1, (b, 1)), h, 1)
    else:
        lens = rng.integers(lo, hi + 1, (b, h))
    if zero:
        lens[0, 0] = 0
    return lens


# (name, b, h, h_kv, sq, sk, causal, lens): every leg's backward call, the
# batch and heads cut
WALKS = [
    ("gpt_packed_d128_causal", 2, 2, 2, 1024, 1024, True, None),
    ("t5_encoder_padded", 2, 2, 2, 512, 512, False,
     _lens(2, 2, 256, 512, 1)),
    ("t5_encoder", 2, 2, 2, 512, 512, False, None),
    ("t5_decoder_114", 3, 2, 2, 114, 114, True, None),
    ("t5_cross_padded", 2, 2, 2, 114, 512, False, _lens(2, 2, 256, 512, 2)),
    ("t5_materialized_encoder", 1, 2, 2, 512, 512, False, None),
    ("t5_materialized_decoder", 2, 2, 2, 114, 114, True, None),
    ("bert_bshd_kv_lens", 4, 2, 2, 512, 512, False,
     _lens(4, 2, 64, 512, 3, zero=True)),
    ("gqa_h_2hkv", 2, 4, 2, 300, 300, True, _lens(2, 4, 1, 300, 4, False,
                                                  True)),
    ("gqa_bottom_right_sq_lt_sk", 2, 4, 2, 200, 333, True,
     _lens(2, 4, 100, 333, 5, False)),
]


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("name,b,h,hkv,sq,sk,causal,lens", WALKS,
                         ids=[w[0] for w in WALKS])
def test_dkv_walk_covers_every_live_score_once(name, b, h, hkv, sq, sk,
                                                causal, lens, tile):
    """``tile``: the query rows a stage holds (128 at d 64, 64 at d 128
    and with an array bias)."""
    _check_dkv(b, h, hkv, sq, sk, causal, lens, tile)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("name,b,h,hkv,sq,sk,causal,lens", WALKS,
                         ids=[w[0] for w in WALKS])
def test_dq_walk_covers_every_live_score_once(name, b, h, hkv, sq, sk,
                                               causal, lens, tile):
    """``tile``: the kv rows a stage holds (128 at d 64, 64 at d 128)."""
    _check_dq(b, h, hkv, sq, sk, causal, lens, tile)


def test_a_kv_tile_no_head_reaches_has_a_cta_with_no_work():
    """kv lengths short of the second kv tile: its CTA walks nothing and
    writes dk = dv = 0."""
    lens = np.full((2, 2), 100)
    ctas = A.dkv_schedule(2, 2, 2, 256, 256, False, lens)
    idle = [c for c in ctas if c[2] == A.DKV_KV_TILE]
    assert len(idle) == 4 and all(not c[3] for c in idle)


# --- the call order and the planted faults ------------------------------------

def _fake_pair(calls):
    """Counting fakes of a layout's dQ and dK/dV wrappers: the plain
    version's results, dq first returning a delta token."""
    def dq(*a, **kw):
        calls.append(("dq", kw.get("delta")))
        return "dq", "delta"

    def dkv(*a, **kw):
        calls.append(("dkv", kw.get("delta")))
        return ("dk", "dv", None) if "rel_bias" in kw else ("dk", "dv")
    return dq, dkv


@pytest.mark.parametrize("layout", ["packed", "bhsd", "bshd"])
def test_the_pair_runs_dq_first_and_hands_delta_on(monkeypatch, layout):
    calls = []
    dq, dkv = _fake_pair(calls)
    monkeypatch.setattr(A._backend, "use_kernel", lambda x, impl="auto": True)
    x = torch.zeros(1, 64, 3 * 64)
    if layout == "packed":
        monkeypatch.setattr(A, "flash_bwd_dq_cuda", dq)
        monkeypatch.setattr(A, "flash_bwd_dkv_cuda", dkv)
        out = A.flash_bwd_packed(x, x, x, x, 1, 1, 64, scale=1.0,
                                 causal=True)
    elif layout == "bhsd":
        monkeypatch.setattr(A, "flash_bwd_flat_dq_cuda", dq)
        monkeypatch.setattr(A, "flash_bwd_flat_dkv_cuda", dkv)
        out = A.flash_bwd(x, x, x, x, x, x, scale=1.0, causal=False)
    else:
        monkeypatch.setattr(A, "flash_bwd_bshd_dq_cuda", dq)
        monkeypatch.setattr(A, "flash_bwd_bshd_dkv_cuda", dkv)
        x = torch.zeros(1, 64, 2, 64)
        out = A.flash_bwd_bshd(x, x, x, x, x, x, scale=1.0, causal=False)
    assert calls == [("dq", None), ("dkv", "delta")]
    assert out[0] == "dq" and out[1:3] == ("dk", "dv")


def test_planted_fault_drop_last_kv_tile_without_lens():
    lens, strides, bias, lut = A._planted("drop_last_kv_tile", None, (1, 0),
                                          "bias", "lut", 2, 3, 114, "cpu")
    assert strides == (3, 1) and bias == "bias" and lut == "lut"
    assert lens.dtype == torch.int32 and lens.shape == (6,)
    assert (lens == 64).all()  # the last 64-row kv tile's first key


def test_planted_fault_drop_last_kv_tile_clamps_given_lens():
    given = torch.tensor([512, 300, 500], dtype=torch.int32)
    lens, strides, _, _ = A._planted("drop_last_kv_tile", given, (1, 0),
                                     None, None, 3, 16, 512, "cpu")
    assert strides == (1, 0)
    assert lens.tolist() == [448, 300, 448]


def test_planted_fault_drop_bias():
    lens, strides, bias, lut = A._planted("drop_bias", "lens", (4, 1),
                                          "bias", "lut", 2, 4, 512, "cpu")
    assert (lens, strides, bias, lut) == ("lens", (4, 1), None, None)


def test_an_unknown_planted_fault_raises():
    with pytest.raises(ValueError, match="planted_fault"):
        A._planted("drop_everything", None, (1, 1), None, None, 1, 1, 64,
                   "cpu")


# --- delta: the plain version, and the backward it feeds ---------------------

def _numpy_case(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, h, sq, d), f(b, h, sk, d), f(b, h, sk, d), f(b, h, sq, d)


def test_bwd_delta_is_the_row_sum_of_do_times_o():
    rng = np.random.default_rng(7)
    o = rng.standard_normal((3, 5, 114, 64)).astype(np.float32)
    do = rng.standard_normal((3, 5, 114, 64)).astype(np.float32)
    got = A.bwd_delta(torch.tensor(o), torch.tensor(do)).numpy()
    want = (do * o).sum(-1)  # 64 products: sums in another order
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(do * o).sum(-1).max())
    # bf16 inputs: the product and the sum in fp32
    ob, dob = torch.tensor(o).bfloat16(), torch.tensor(do).bfloat16()
    got = A.bwd_delta(ob, dob)
    assert got.dtype == torch.float32
    want = (dob.float() * ob.float()).sum(-1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("causal,lens,sq,sk", [
    (True, None, 128, 128),
    (False, [100, 37], 128, 128),
    (True, None, 64, 128),
])
def test_plain_backward_on_the_dq_delta_matches_reference(
        monkeypatch, causal, lens, sq, sk):
    """The pair's data flow in the plain version: delta from the dQ side
    output's plain version, handed to the backward, against the JAX
    reference's vjp (its XLA path) on the same inputs."""
    monkeypatch.setenv("APEX_TPU_PALLAS", "0")
    b, h, d = 2, 2, 64
    q, k, v, do = _numpy_case(b, h, sq, sk, d, seed=sq + sk)
    kv = None if lens is None else np.repeat(
        np.asarray(lens, np.int32)[:, None], h, 1)
    lens_j = None if kv is None else jnp.asarray(kv)

    def jf(q, k, v):
        return jflash(q, k, v, causal=causal, kv_lens=lens_j)

    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
        want = [np.asarray(x) for x in vjp(jnp.asarray(do))]

    qt, kt, vt, dot = (torch.tensor(a) for a in (q, k, v, do))
    lens_t = None if kv is None else torch.tensor(kv).reshape(-1)
    o, lse = A.flash_fwd(qt, kt, vt, scale=d ** -0.5, causal=causal,
                         kv_lens=lens_t)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)
    delta = A.bwd_delta(o, dot).reshape(b * h, sq)
    np.testing.assert_allclose(delta.numpy(),
                               (do * o.numpy()).sum(-1).reshape(b * h, sq),
                               rtol=1e-5, atol=1e-5)
    dq, dk, dv, _ = A._torch_flash_bwd_flat(
        A._rows3(qt), A._rows3(kt), A._rows3(vt), A._rows3(o), lse,
        A._rows3(dot), d ** -0.5, causal, lens_t, delta=delta)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
