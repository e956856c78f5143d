"""The flash forward's and the dbias kernel's host-side launch plans, on the
CPU: what the wrappers of ``apex_tpu_torch/ops/attention.py`` decide before
they launch ``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_dbias.cu``.

* the forward's variant: ``"wgmma"`` unless a caller names ``"sm80"``;
  anything else raises; its TMA maps (one 4-D (d, row, head, batch) bf16
  map per q, k and v, 64 x 64 boxes) for the packed buffer, the GQA case,
  T5's bh-flat views and BERT's seq-major ones; a misaligned view raises
  (no fallback); the array bias's staging (TMA, or ``cp.async`` where no
  map describes it) and the tiles;
* the plans kept by layout: one plan for repeated calls, a new one for
  any other stride, alignment, bias, variant or SM count;
* the forward's walk (:func:`fwd_schedule`) against a brute-force mask
  under bottom-right causal alignment and ``kv_lens`` (a length 0
  included, ragged tails): every live score visited exactly once, no
  visited stage fully masked, a warpgroup's skipped stage holding no live
  score of its rows, every query tile one CTA;
* the dbias plan: the split S of the sharing rows at each call, groups
  that partition the rows in order, every (bias row, tile) written once;
  its planted faults;
* the split fixed-order sum's plain emulation against the JAX reference's
  ``_dbias_pallas`` in interpret mode (through its ``flash_bwd``), fp32,
  within 2e-4 of the largest entry (sums in another order);
* both backward dispatches hand the dQ kernel's delta to dbias.

Shapes are the legs' own sequence lengths and head widths with the batch
(and, for the brute-force walks, the heads) cut.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import attention as jpa
from apex_tpu_torch.ops import attention as A

GRAD_RTOL = 2e-4


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


# --- the forward's variant, maps, staging and tiles -----------------------------

def test_forward_default_variant_is_wgmma():
    q4 = _bf16(2, 4, 128, 64)
    plan = A._fwd_plan(q4, q4, q4)
    assert plan.variant == "wgmma"
    assert set(plan.maps) == {"q", "k", "v"}
    assert plan.bias_staging is None
    assert plan.tiles == (A.FWD_Q_TILE, A.FWD_KV_TILE) == (128, 128)


@pytest.mark.parametrize("variant", ["wgmma", "sm80"])
def test_forward_named_variant_is_taken(variant):
    q4 = _bf16(2, 4, 128, 64)
    plan = A._fwd_plan(q4, q4, q4, torch.zeros(4, 128, 128), variant)
    assert plan.variant == variant
    if variant == "sm80":
        assert plan.maps == {} and plan.bias_staging == "global"
        assert plan.tiles is None
    else:
        assert plan.bias_staging == "tma"
        assert plan.tiles == (128, 128)  # d 64: the lookup's tiles
        wide = _bf16(2, 4, 128, 128)
        assert A._fwd_plan(wide, wide, wide, torch.zeros(4, 128, 128),
                           variant).tiles == (128, A.FWD_BIAS_KV_TILE)


@pytest.mark.parametrize("variant", ["sm90", "WGMMA", "auto", ""])
def test_forward_unknown_variant_raises(variant):
    q4 = _bf16(1, 2, 64, 64)
    with pytest.raises(ValueError, match="no variant"):
        A._fwd_plan(q4, q4, q4, variant=variant)


def test_forward_misaligned_view_raises_without_fallback():
    buf = _bf16(1, 130, 2 * 64 + 8)
    bad = buf.view(-1)[3:3 + 2 * 64 * 64].view(1, 2, 64, 64)  # 6 bytes off
    with pytest.raises(ValueError, match="no tensor map describes q"):
        A._fwd_plan(bad, bad, bad)
    # a row stride that is no multiple of 16 bytes: k's
    ok = _bf16(1, 2, 64, 64)
    odd = _bf16(1, 64, 2 * 64 + 4)[..., :128].unflatten(-1, (2, 64))
    with pytest.raises(ValueError, match="no tensor map describes k"):
        A._fwd_plan(ok, odd.transpose(1, 2), ok)


def test_plans_are_kept_by_layout():
    """A step's repeated calls reuse one plan; a view that differs in any
    input of a plan (strides, base alignment, the bias, the variant) gets
    its own, and a misaligned view still raises after an aligned one of
    the same shape and strides was planned."""
    q4, k4 = _bf16(2, 12, 128, 64), _bf16(2, 12, 128, 64)
    plan = A._fwd_plan(q4, k4, k4)
    assert A._fwd_plan(_bf16(2, 12, 128, 64), k4, k4) is plan
    assert A._fwd_plan(q4, k4, k4, torch.zeros(12, 128, 128)) is not plan
    assert A._fwd_plan(q4, k4, k4, variant="sm80").variant == "sm80"
    assert A._fwd_plan(q4.transpose(1, 2).contiguous().transpose(1, 2), k4,
                       k4).maps["q"] != plan.maps["q"]
    buf = _bf16(q4.numel() + 12)
    start = (-buf.data_ptr()) % 16 // 2 + 4  # 8 bytes off 16
    off = buf[start:start + q4.numel()].view(q4.shape)
    assert off.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="no tensor map describes q"):
        A._fwd_plan(off, k4, k4)
    qkv = _bf16(2, 1024, 3 * 8 * 128)
    assert A._packed_fwd_plan(qkv, 8, 8, 128, None) is A._packed_fwd_plan(
        _bf16(2, 1024, 3 * 8 * 128), 8, 8, 128, None)
    dec = _bf16(32, 12, 114, 64)  # T5's decoder rows, the batch cut
    plan = A._dbias_plan(dec, dec, dec, dec, 12, sms=132)
    assert A._dbias_plan(dec, dec, dec, dec, 12, sms=132) is plan
    assert plan.splits == 11
    assert A._dbias_plan(dec, dec, dec, dec, 12, sms=66).splits == 5


def test_forward_packed_maps_gpt():
    """GPT's train step: q, k, v as the packed buffer's three sections —
    head stride d, row stride (h + 2·h_kv)·d."""
    b, s, h, hkv, d = 2, 1024, 8, 8, 128
    qkv = _bf16(b, s, (h + 2 * hkv) * d)
    plan = A._fwd_plan(*A._packed_views(qkv, h, hkv, d))
    F = (h + 2 * hkv) * d
    for name, heads in (("q", h), ("k", hkv), ("v", hkv)):
        m = plan.maps[name]
        assert m.dtype == "bf16" and m.box == (64, 64, 1, 1)
        assert m.dims == (d, s, heads, b)
        assert m.strides == (2 * F, 2 * d, 2 * s * F)


def test_forward_packed_maps_gqa():
    b, s, h, hkv, d = 8, 1000, 8, 2, 128
    qkv = _bf16(b, s, (h + 2 * hkv) * d)
    plan = A._fwd_plan(*A._packed_views(qkv, h, hkv, d))
    assert plan.maps["q"].dims == (d, s, h, b)
    assert plan.maps["k"].dims == plan.maps["v"].dims == (d, s, hkv, b)
    assert plan.maps["k"].strides == plan.maps["q"].strides


@pytest.mark.parametrize("sq,sk", [(512, 512), (114, 114), (114, 512)])
def test_forward_flat_maps_t5_views(sq, sk):
    """T5's three attention calls: (b, h, s, d) views of (b, s, h·d)
    projection outputs (k and v two halves of one (b, sk, 2·h·d) one)."""
    b, h, d = 3, 12, 64
    q4 = _bf16(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
    kv = _bf16(b, sk, 2 * h * d)
    k4 = kv[..., :h * d].view(b, sk, h, d).transpose(1, 2)
    v4 = kv[..., h * d:].view(b, sk, h, d).transpose(1, 2)
    plan = A._fwd_plan(q4, k4, v4)
    assert plan.maps["q"].dims == (d, sq, h, b)
    assert plan.maps["q"].strides == (2 * h * d, 2 * d, 2 * sq * h * d)
    assert plan.maps["k"].dims == plan.maps["v"].dims == (d, sk, h, b)
    assert plan.maps["v"].strides == (4 * h * d, 2 * d, 4 * sk * h * d)


def test_forward_bshd_maps_bert_and_prefill():
    """BERT's and the prefill's seq-major q/k/v, views of one packed
    projection: the head-stride-d case."""
    b, s, h, d = 4, 512, 16, 64
    y = _bf16(b, s, 3 * h * d)
    q, k, v = (y[..., i * h * d:(i + 1) * h * d].view(b, s, h, d)
               for i in range(3))
    plan = A._fwd_plan(*A._bshd_views(q, k, v))
    for name in ("q", "k", "v"):
        assert plan.maps[name].dims == (d, s, h, b)
        assert plan.maps[name].strides == (6 * h * d, 2 * d, 6 * s * h * d)


@pytest.mark.parametrize("sq,sk,hb,staging", [
    (512, 512, 12, "tma"),      # T5 materialized, encoder self-attention
    (114, 114, 12, "cp.async"),  # its decoder: 456-byte rows
    (512, 512, 1, "tma"),       # the bshd leg's hb 1
    (77, 77, 2, "cp.async"),
])
def test_forward_bias_staging(sq, sk, hb, staging):
    q4 = _bf16(2, 12, sq, 64)
    k4 = _bf16(2, 12, sk, 64)
    plan = A._fwd_plan(q4, k4, k4, torch.zeros(hb, sq, sk))
    assert plan.bias_staging == staging
    assert plan.tiles == (128, 128)
    if staging == "tma":
        m = plan.maps["bias"]
        assert m.dtype == "fp32" and m.box == (32, 64, 1)
        assert m.dims == (sk, sq, hb)
    else:
        assert "bias" not in plan.maps


def test_forward_bias_at_a_misaligned_base_is_copied():
    bias = torch.zeros(4 * 128 * 128 + 1)[1:].view(4, 128, 128)
    q4 = _bf16(1, 4, 128, 64)
    assert A._fwd_plan(q4, q4, q4, bias).bias_staging == "cp.async"


# --- the forward's walk against a brute-force mask -------------------------------

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


def _lens(b, h, lo, hi, seed, per_batch=True, zero=False):
    rng = np.random.default_rng(seed)
    if per_batch:
        lens = np.repeat(rng.integers(lo, hi + 1, (b, 1)), h, 1)
    else:
        lens = rng.integers(lo, hi + 1, (b, h))
    if zero:
        lens[0, 0] = 0
    return lens


# (name, b, h, h_kv, sq, sk, causal, lens): every leg's forward call, the
# batch and heads cut
FWD_WALKS = [
    ("gpt_packed_causal", 2, 2, 2, 1024, 1024, True, None),
    ("gpt_gqa_1000", 2, 4, 2, 1000, 1000, True, None),
    ("prefill_512", 2, 2, 2, 512, 512, True, None),
    ("t5_encoder_padded", 2, 2, 2, 512, 512, False,
     _lens(2, 2, 256, 512, 1)),
    ("t5_encoder", 2, 2, 2, 512, 512, False, None),
    ("t5_decoder_114", 3, 2, 2, 114, 114, True, None),
    ("t5_cross_padded", 2, 2, 2, 114, 512, False, _lens(2, 2, 256, 512, 2)),
    ("bert_bshd_kv_lens", 4, 2, 2, 512, 512, False,
     _lens(4, 2, 64, 512, 3, zero=True)),
    ("gqa_ragged_300", 2, 4, 2, 300, 300, True,
     _lens(2, 4, 1, 300, 4, False, True)),
    ("bottom_right_sq_lt_sk", 2, 4, 2, 200, 333, True,
     _lens(2, 4, 100, 333, 5, False)),
]


@pytest.mark.parametrize("kv_tile", [A.FWD_KV_TILE, A.FWD_BIAS_KV_TILE])
@pytest.mark.parametrize("name,b,h,hkv,sq,sk,causal,lens", FWD_WALKS,
                         ids=[w[0] for w in FWD_WALKS])
def test_forward_walk_covers_every_live_score_once(name, b, h, hkv, sq, sk,
                                                    causal, lens, kv_tile):
    """``kv_tile``: the kv rows a stage holds (128; 64 with an array
    bias at d 128). Each CTA's two warpgroups (64 query rows each) skip a stage
    wholly above their rows' diagonal: such a stage holds no live score of
    theirs, so the skip loses nothing."""
    qt = A.FWD_Q_TILE
    live = _live(b, h, sq, sk, causal, lens)
    seen = np.zeros(live.shape, np.int32)
    ctas = A.fwd_schedule(b, h, hkv, sq, sk, causal, lens, kv_tile)
    nq = -(-sq // qt)
    assert sorted((bi, hd, q0) for bi, hd, q0, _ in ctas) == sorted(
        (bi, hd, t * qt) for bi in range(b) for hd in range(h)
        for t in range(nq)), "every query tile gets one CTA"
    coff = sk - sq
    for bi, hd, q0, k0s in ctas:
        for k0 in k0s:
            blk = (bi, hd, slice(q0, q0 + qt), slice(k0, k0 + kv_tile))
            assert live[blk].any(), f"fully masked stage loaded: {hd, q0, k0}"
            seen[blk] += 1
            for wq0 in (q0, q0 + 64):
                if causal and k0 > wq0 + 63 + coff:  # the warpgroup skips
                    assert not live[bi, hd, wq0:wq0 + 64,
                                    k0:k0 + kv_tile].any()
    assert (seen[live] == 1).all(), "a live score missed or visited twice"
    assert seen.max() <= 1
    heads = [(bi, hd) for bi, hd, _, _ in ctas]
    assert heads == sorted(heads), "head by head"
    for i in range(0, len(ctas), nq):
        q0s = [q0 for _, _, q0, _ in ctas[i:i + nq]]
        assert q0s == sorted(q0s, reverse=True), "the last query tiles first"


def test_forward_walk_gives_a_length_zero_row_no_stage():
    """A row of kv length 0 loads nothing: the kernel writes o = 0 and
    lse = 0 for it."""
    lens = np.array([[0, 512]])
    ctas = A.fwd_schedule(1, 2, 2, 512, 512, False, lens)
    assert all(not k0s for _, hd, _, k0s in ctas if hd == 0)
    assert all(k0s == [0, 128, 256, 384] for _, hd, _, k0s in ctas if hd == 1)


# --- the dbias plan ----------------------------------------------------------

@pytest.mark.parametrize("name,b,h,sq,sk,hb,splits", [
    ("t5_decoder_114", 128, 12, 114, 114, 12, 11),  # 24 tiles
    ("bshd_hb1", 32, 16, 512, 512, 1, 8),            # 32 tiles
    ("t5_encoder", 128, 12, 512, 512, 12, 1),       # 384 tiles fill the card
    ("few_rows", 2, 12, 114, 114, 12, 2),           # S at most nb
])
def test_dbias_splits_at_each_call(name, b, h, sq, sk, hb, splits):
    q4 = _bf16(b, h, sq, 64)
    k4 = _bf16(b, h, sk, 64)
    plan = A._dbias_plan(q4, k4, k4, q4, hb, sms=132)
    assert plan.variant == "wgmma" and plan.splits == splits
    assert plan.tiles == (A.DBIAS_Q_TILE, A.DBIAS_KV_TILE) == (128, 64)
    tiles = hb * -(-sq // 128) * -(-sk // 64)
    if 1 < splits < b * h // hb:  # the grid covers the card about twice
        assert 132 <= tiles * splits <= 2 * 132
    assert set(plan.maps) == {"q", "k", "v", "do"}


@pytest.mark.parametrize("nb,splits", [(128, 11), (512, 8), (6, 4), (7, 7),
                                       (128, 1)])
def test_dbias_groups_partition_the_rows_in_order(nb, splits):
    groups = A.dbias_groups(nb, splits)
    assert len(groups) == splits
    flat = [n for n0, n1 in groups for n in range(n0, n1)]
    assert flat == list(range(nb))
    assert all(n1 - n0 >= nb // splits for n0, n1 in groups)


@pytest.mark.parametrize("b,h,hb,sq,sk", [(128, 12, 12, 114, 114),
                                           (32, 16, 1, 512, 512),
                                           (128, 12, 12, 512, 512),
                                           (3, 4, 2, 200, 333)])
def test_dbias_writes_every_tile_once(b, h, hb, sq, sk):
    """Each (bias row, query tile, kv tile) gets one CTA per group; the
    groups' rows partition the sharing rows; with one group that CTA
    writes dbias, else the tile's partials are added in group order.
    The tiles cover the (hb, sq, sk) output exactly once."""
    nb = b * h // hb
    q4 = _bf16(b, h, sq, 64)
    k4 = _bf16(b, h, sk, 64)
    plan = A._dbias_plan(q4, k4, k4, q4, hb, sms=132)
    ctas = A.dbias_schedule(plan, hb, sq, sk)
    assert len(ctas) == plan.splits * hb * -(-sq // 128) * -(-sk // 64)
    covered = np.zeros((hb, sq, sk), np.int32)
    by_tile = {}
    for s, th, q0, k0, rows in ctas:
        by_tile.setdefault((th, q0, k0), []).append((s, rows))
        if s == 0:
            covered[th, q0:q0 + 128, k0:k0 + 64] += 1
    assert (covered == 1).all()
    for parts in by_tile.values():
        assert [s for s, _ in parts] == list(range(plan.splits))
        assert [n for _, rows in parts for n in rows] == list(range(nb))


def test_dbias_sm80_plan_is_one_group():
    q4 = _bf16(4, 12, 114, 64)
    plan = A._dbias_plan(q4, q4, q4, q4, 12, "sm80")
    assert plan.variant == "sm80" and plan.splits == 1
    assert plan.groups == ((0, 4),) and plan.maps == {}
    with pytest.raises(ValueError, match="no variant"):
        A._dbias_plan(q4, q4, q4, q4, 12, "fast")


def test_dbias_planted_faults():
    """Both faults are made from the wrapper's own inputs: the do and delta
    rows of the last group of sharing rows (with one group, of its last
    sharing row) zeroed, all others as given; or a zero bias."""
    gen = torch.Generator().manual_seed(5)
    bias = torch.randn(12, 114, 114, generator=gen)
    do4 = torch.randn(128, 12, 114, 64, generator=gen).to(torch.bfloat16)
    do4 = do4.transpose(1, 2).contiguous().transpose(1, 2)  # a bshd view
    delta = torch.randn(128 * 12, 114, generator=gen)
    plan = A._dbias_plan(do4, do4, do4, do4, 12, sms=132)
    assert A._dbias_planted(None, plan, 12, do4, delta, bias) == (
        do4, delta, bias)
    one = A._dbias_plan(do4, do4, do4, do4, 12, "sm80")
    for p, first in ((plan, plan.groups[-1][0]), (one, 127)):
        assert 0 < first < 128
        d2, dl2, same = A._dbias_planted("drop_last_group", p, 12, do4,
                                         delta, bias)
        assert same is bias and d2.shape == do4.shape
        rows, kept = d2.reshape(128 * 12, 114, 64), do4.reshape(-1, 114, 64)
        assert not rows[first * 12:].any() and not dl2[first * 12:].any()
        assert torch.equal(rows[:first * 12], kept[:first * 12])
        assert torch.equal(dl2[:first * 12], delta[:first * 12])
    assert A._dbias_planted("drop_last_group", one, 12, do4, None,
                            bias)[1] is None  # sm80 makes its own delta
    d2, dl2, zero = A._dbias_planted("drop_bias", plan, 12, do4, delta, bias)
    assert d2 is do4 and dl2 is delta
    assert not zero.any() and zero.shape == bias.shape
    with pytest.raises(ValueError, match="planted_fault"):
        A._dbias_planted("drop_last_kv_tile", plan, 12, do4, delta, bias)


# --- the split fixed-order sum against the reference ----------------------------

def dbias_split_sum(ds: torch.Tensor, hb: int, groups) -> torch.Tensor:
    """The wgmma dbias kernel's order of summation, in plain PyTorch: ds
    (rows, sq, sk) fp32, the unscaled dS of each q-head row r = n·hb + th,
    summed within each group over n in increasing order, then the groups'
    partials added in group order — the same fp32 additions, one at a
    time."""
    ds = ds.reshape(-1, hb, *ds.shape[1:])
    total = None
    for n0, n1 in groups:
        part = torch.zeros_like(ds[0])
        for n in range(n0, n1):
            part = part + ds[n]
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("splits", [1, 2, 4, 6])
def test_split_dbias_sum_matches_reference_dbias_pallas(splits):
    """hb 2, b 3, h 4 (nb 6 rows share each bias row), causal with
    bottom-right alignment (sq 128 < sk 256), per-row kv_lens: the unscaled
    dS of each row from the reference's own o and lse, summed in the
    kernel's split order, against ``_dbias_pallas`` in interpret mode."""
    b, h, hb, sq, sk, d = 3, 4, 2, 128, 256, 64
    rows = b * h
    rng = np.random.default_rng(splits)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = f(rows, sq, d), f(rows, sk, d), f(rows, sk, d), f(rows, sq, d)
    bias = f(hb, sq, sk)
    lens = rng.integers(100, sk + 1, rows).astype(np.int32)
    lens[5] = 0
    scale = d ** -0.5
    kw = dict(scale=scale, causal=True, kv_lens=jnp.asarray(lens),
              bias=jnp.asarray(bias), interpret=True)
    with jax.default_matmul_precision("highest"):
        jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
        o, lse = jpa.flash_fwd(jq, jk, jv, **kw)
        want = np.asarray(jpa.flash_bwd(jq, jk, jv, o, lse, jdo, **kw)[3])
    o_t = torch.tensor(np.asarray(o))
    lse_t = torch.tensor(np.asarray(lse))
    qt, kt, vt, dot = (torch.tensor(a) for a in (q, k, v, do))
    s = A.masked_scores(qt, kt, scale, True, torch.tensor(lens),
                        torch.tensor(bias))
    p = torch.exp(s - lse_t[..., None])
    dp = torch.einsum("rqd,rkd->rqk", dot, vt)
    ds = p * (dp - A.bwd_delta(o_t, dot)[..., None])
    got = dbias_split_sum(ds, hb, A.dbias_groups(rows // hb, splits))
    assert got.shape == want.shape == (hb, sq, sk)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


def test_split_sum_emulation_is_the_plain_sum_reordered():
    """Every split of the same dS sums the same terms: within fp32
    rounding of one another and of the plain version's one-shot sum."""
    ds = torch.randn(24, 16, 16)
    plain = ds.reshape(-1, 3, 16, 16).sum(0)
    for splits in (1, 2, 8):
        got = dbias_split_sum(ds, 3, A.dbias_groups(8, splits))
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


# --- delta: both dispatches hand the dQ kernel's to dbias -------------------------

@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_both_dispatches_hand_the_dq_delta_to_dbias(monkeypatch, layout):
    calls = []

    def dq(*a, **kw):
        calls.append(("dq", kw.get("delta")))
        return "dq", "delta"

    def dkv(*a, **kw):
        calls.append(("dkv", kw.get("delta")))
        return ("dk", "dv", None) if layout == "bhsd" else ("dk", "dv")

    def dbias(*a, **kw):
        calls.append(("dbias", kw.get("delta")))
        return "dbias"

    monkeypatch.setattr(A._backend, "use_kernel", lambda x, impl="auto": True)
    monkeypatch.setattr(A, "flash_bwd_dbias_cuda", dbias)
    bias = torch.zeros(2, 64, 64)
    if layout == "bhsd":
        monkeypatch.setattr(A, "flash_bwd_flat_dq_cuda", dq)
        monkeypatch.setattr(A, "flash_bwd_flat_dkv_cuda", dkv)
        x = torch.zeros(1, 2, 64, 64)
        out = A.flash_bwd(x, x, x, x, x, x, scale=1.0, causal=False,
                          bias=bias)
    else:
        monkeypatch.setattr(A, "flash_bwd_bshd_dq_cuda", dq)
        monkeypatch.setattr(A, "flash_bwd_bshd_dkv_cuda", dkv)
        x = torch.zeros(1, 64, 2, 64)
        out = A.flash_bwd_bshd(x, x, x, x, x, x, scale=1.0, causal=False,
                               bias=bias)
    assert calls == [("dq", None), ("dkv", "delta"), ("dbias", "delta")]
    assert out == ("dq", "dk", "dv", "dbias")
