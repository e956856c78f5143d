"""The sampling kernel's host-side launch plan and its arithmetic, on the
CPU: what ``apex_tpu_torch/ops/sampling.py`` decides before it launches
``csrc/fused_sample.cu``, and the kernel's filter emulated.

* ``_sample_plan`` at b 1, 8, 64 and 256 × V 32768, 30592 (BERT), 32128
  (T5) and 1000: the cluster size S within {1, 2, 4, 8}, b × S within
  one CTA an SM unless the row needs a larger S to fit the registers, the
  shares in multiples of 8 covering the row, whole warps holding a share,
  the shared memory within a CTA's 227 KB.
* A plain emulation of the kernel (numpy): the row split into the plan's
  S shares, the order-preserving keys (-0.0 as +0.0), radix select in 4
  rounds of 8-bit digits with each rank's 256-bin histogram (counts for
  top-k, fixed-point masses exp(s - m) * 2^40 for top-p) merged in rank
  order, and the draw's argmax per rank merged in rank order (ties to the
  lowest index), with top-p after top-k also found as the kernel's gather
  path finds it (the largest of at most 256 live keys whose integer mass
  at and above it reaches p * z: the same key) — held against the JAX
  reference's ``apply_top_k``,
  ``apply_top_p``, ``gumbel_argmax`` and ``fused_sample_fwd`` in interpret
  mode on shared noise. Top-k kept sets must be identical; top-p kept sets
  and tokens may differ only on a row with a near-tie (a cumulative mass
  within 1e-5 of p * z, or two best perturbed scores within 1e-5
  relative), at most 1% of rows. Ties at the k-th value, k = 1, k = V and
  k with top-p are covered.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu.ops.pallas import sampling as jsm
from apex_tpu_torch.ops import sampling as SM

H100_SMS = 132
SM_GATHER = 256  # live entries rank 0 gathers at most (kGather)
SMEM_PER_CTA = 232448
NEAR_TIE = 1e-5
VOCABS = (32768, 30592, 32128, 1000)


# --- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("b", [1, 8, 64, 256])
def test_plan_at_the_legs_shapes(b, V):
    plan = SM._sample_plan(b, V, H100_SMS)
    S = plan.splits
    assert S in SM.SAMPLE_SPLITS
    assert plan.share % 8 == 0 and plan.share * S >= V
    assert (S - 1) * plan.share < V, "every rank holds some of the row"
    assert plan.values in SM.SAMPLE_VALUES
    assert plan.threads % 32 == 0
    assert SM.SAMPLE_MIN_THREADS <= plan.threads <= SM.SAMPLE_VALUES[
        plan.values]
    assert plan.threads * plan.values >= plan.share
    assert SM.SAMPLE_SMEM <= SMEM_PER_CTA
    # the fewest values a thread that hold the share
    smaller = [v for v in SM.SAMPLE_VALUES if v < plan.values]
    assert all(-(-plan.share // v) > SM.SAMPLE_VALUES[v] for v in smaller)
    least = min(s for s in SM.SAMPLE_SPLITS
                if SM._fit(SM._share(V, s)) is not None)
    assert S >= least
    assert b * S <= H100_SMS or S == least
    if S < 8:
        # a larger S would leave an SM two CTAs or a rank a thin share
        assert (b * 2 * S > H100_SMS
                or SM._share(V, 2 * S) < SM.SAMPLE_MIN_SHARE)


@pytest.mark.parametrize("b,V,splits,threads,values", [
    (8, 32768, 8, 512, 8),      # the serve's decode step
    (1, 32768, 8, 512, 8),      # its prefill chunk
    (64, 32768, 2, 512, 32),
    (256, 32768, 2, 512, 32),   # V 32768 fits the registers from S 2
    (8, 30592, 8, 480, 8),
    (8, 1000, 4, 256, 8),
    (256, 1000, 1, 256, 8),
])
def test_plan_takes_each_split(b, V, splits, threads, values):
    plan = SM._sample_plan(b, V, H100_SMS)
    assert (plan.splits, plan.threads, plan.values) == (splits, threads,
                                                        values)


def test_plan_refuses_what_the_kernel_does_not_hold():
    with pytest.raises(ValueError, match="1 to"):
        SM._sample_plan(1, SM.KERNEL_MAX_VOCAB + 1, H100_SMS)
    assert SM._sample_plan(1, SM.KERNEL_MAX_VOCAB, H100_SMS).splits == 8


# --- the kernel's arithmetic, emulated -----------------------------------------

def score_key(s):
    """The order-preserving uint32 key of fp32 scores, -0.0 as +0.0."""
    b = np.asarray(s, np.float32).view(np.uint32).copy()
    b[(b << np.uint32(1)) == 0] = 0
    neg = (b & np.uint32(0x80000000)) != 0
    return np.where(neg, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def key_score(k):
    k = np.uint32(k)
    bits = (k & np.uint32(0x7fffffff)) if k & np.uint32(0x80000000) else ~k
    return np.array([bits], np.uint32).view(np.float32)[0]


def radix_select(ranks, target=None, top_p=None):
    """The largest key K with (the amounts of keys >= K) >= target, over
    the ranks' (keys, amounts) — 4 rounds of 8-bit digits, each rank's
    256-bin histogram merged in rank order, the suffix sums scanned. With
    ``top_p`` the target is top_p times the first round's total."""
    prefix, above = 0, np.uint64(0)
    for shift in (24, 16, 8, 0):
        hi = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        merged = np.zeros(256, np.uint64)
        for keys, amounts in ranks:
            sel = ((keys ^ np.uint32(prefix)) & np.uint32(hi)) == 0
            hist = np.zeros(256, np.uint64)
            np.add.at(hist, ((keys[sel] >> np.uint32(shift)) & 255).astype(
                np.int64), amounts[sel])
            merged += hist
        suffix = np.cumsum(merged[::-1], dtype=np.uint64)[::-1]
        if top_p is not None and shift == 24:
            target = float(np.float32(top_p)) * float(suffix[0])
        ok = (above + suffix).astype(np.float64) >= target
        d = int(np.flatnonzero(ok).max())
        above = above + (suffix[d + 1] if d < 255 else np.uint64(0))
        prefix |= d << shift
    return np.uint32(prefix)


def _shares(V, plan):
    return [(r * plan.share, min(V, (r + 1) * plan.share))
            for r in range(plan.splits)]


def emulate(logits, u, temperature, top_k, top_p, plan):
    """The kernel on (b, V) fp32 logits and noise: (tokens, the kept mask
    after top-k, the final kept mask)."""
    b, V = logits.shape
    s = (logits.astype(np.float32)
         * np.float32(1.0 / temperature)).astype(np.float32)
    keys = score_key(s)
    shares = _shares(V, plan)
    tokens = np.zeros(b, np.int32)
    kept_k = np.ones((b, V), bool)
    kept = np.ones((b, V), bool)
    for r in range(b):
        keep = np.uint32(0)
        if top_k > 0:
            keep = radix_select(
                [(keys[r, lo:hi], np.ones(hi - lo, np.uint64))
                 for lo, hi in shares], target=float(top_k))
        kept_k[r] = keys[r] >= keep
        if top_p < 1.0:
            m = key_score(max(keys[r, lo:hi].max(initial=0)
                              for lo, hi in shares))
            e = np.where(kept_k[r], np.exp((s[r] - m).astype(np.float32)),
                         0).astype(np.float32)
            q = np.rint(e.astype(np.float64) * 2.0 ** 40).astype(np.uint64)
            live = q > 0
            keep = radix_select(
                [(keys[r, lo:hi][live[lo:hi]], q[lo:hi][live[lo:hi]])
                 for lo, hi in shares], top_p=top_p)
            if top_k > 0 and kept_k[r].sum() <= SM_GATHER:
                # the kernel's gather path: the largest live key whose
                # integer mass at and above it reaches p * z
                lk, lq = keys[r][kept_k[r]], q[kept_k[r]]
                target = float(np.float32(top_p)) * float(lq.sum())
                w = np.array([lq[lk >= k].sum() for k in lk], np.uint64)
                assert lk[w.astype(np.float64) >= target].max() == keep
        kept[r] = keys[r] >= keep
        x = (s[r] + (-np.log(-np.log(u[r])))).astype(np.float32)
        best, best_i = -np.inf, V
        for lo, hi in shares:  # each rank's draw, ranks in order
            xr = np.where(kept[r, lo:hi], x[lo:hi], -np.inf)
            if hi > lo and xr.max() > best:
                best, best_i = xr.max(), lo + int(np.argmax(xr))
        tokens[r] = best_i
    return tokens, kept_k, kept


def _inputs(b, V, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:  # a few distinct values: ties at every k
        logits = rng.integers(-6, 7, (b, V)).astype(np.float32) * 0.5
    else:
        logits = (rng.standard_normal((b, V)) * 3.0).astype(np.float32)
    u = np.maximum(rng.random((b, V)),
                   np.finfo(np.float32).tiny).astype(np.float32)
    return logits, u


def _mass_near_ties(s, top_p):
    """Rows where the mass of the live scores at or above some distinct
    value lies within NEAR_TIE of p * z: the top-p threshold may land on
    either side there, so the kept set may differ."""
    s = np.asarray(s, np.float64)
    m = s.max(-1, keepdims=True)
    order = np.argsort(-s, axis=-1, kind="stable")
    srt = np.take_along_axis(s, order, -1)
    e = np.where(srt > jsm.FILTERED * 0.5, np.exp(srt - m), 0.0)
    cum = np.cumsum(e, axis=-1)
    z = cum[:, -1:]
    ends = np.ones_like(srt, bool)  # the last of each run of equal values
    ends[:, :-1] = srt[:, 1:] != srt[:, :-1]
    return ((np.abs(cum - top_p * z) <= NEAR_TIE * z) & ends).any(-1)


def _token_near_ties(logits, u, t, k, p):
    s = np.asarray(jsm.filtered_scaled(jnp.asarray(logits), temperature=t,
                                       top_k=k, top_p=p))
    x = s - np.log(-np.log(u.astype(np.float64)))
    top2 = np.sort(x, axis=-1)[:, -2:]
    return np.abs(top2[:, 1] - top2[:, 0]) <= NEAR_TIE * np.abs(top2[:, 1])


def test_keys_order_scores_and_fold_signed_zeros():
    s = np.array([-np.inf, -1e30, -3.5, -1e-40, -0.0, 0.0, 1e-40, 2.0,
                  1e30, np.inf], np.float32)
    k = score_key(s)
    assert k[4] == k[5], "-0.0 and +0.0 take one key"
    assert (np.diff(k.astype(np.int64)) >= 0).all()
    assert (np.diff(np.delete(k, 4).astype(np.int64)) > 0).all()
    for v in s:
        if v != 0:
            assert key_score(score_key(np.array([v]))[0]) == v


# (b, V) whose plan splits the rows: S 8 at V 2048, S 4 at V 1000 (the last
# rank's share shorter), S 1 at b 200; the emulations run ROWS rows on it
SPLIT_CASES = [(16, 2048), (16, 1000), (200, 256)]
ROWS = 200
KNOBS = [(0.8, 50, 1.0), (0.8, 0, 0.9), (0.8, 50, 0.9), (1.3, 1, 1.0),
         (0.7, 5, 0.5)]


@pytest.mark.parametrize("b,V", SPLIT_CASES)
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 5, 50, "V"])
def test_radix_top_k_equals_reference_kept_set(b, V, ties, k):
    k = V if k == "V" else k
    logits, _ = _inputs(ROWS, V, seed=V + k, ties=ties)
    plan = SM._sample_plan(b, V, H100_SMS)
    _, kept_k, _ = emulate(logits, np.full(logits.shape, 0.5, np.float32),
                           0.9, k, 1.0, plan)
    s = logits * np.float32(1.0 / 0.9)
    want = np.asarray(jsm.apply_top_k(jnp.asarray(s), k)) > jsm.FILTERED / 2
    np.testing.assert_array_equal(kept_k, want)
    assert (kept_k.sum(-1) >= k).all()
    if ties:  # ties at the k-th value all kept
        kth = -np.sort(-s, axis=-1)[:, k - 1:k]
        assert (kept_k == (s >= kth)).all()


@pytest.mark.parametrize("b,V", SPLIT_CASES)
@pytest.mark.parametrize("k,p", [(0, 0.9), (50, 0.9), (0, 0.5), (5, 0.3),
                                 ("V", 0.9)])
@pytest.mark.parametrize("ties", [False, True])
def test_radix_top_p_matches_reference_outside_near_ties(b, V, k, p, ties):
    k = V if k == "V" else k
    logits, _ = _inputs(ROWS, V, seed=V + 7, ties=ties)
    plan = SM._sample_plan(b, V, H100_SMS)
    _, _, kept = emulate(logits, np.full(logits.shape, 0.5, np.float32),
                         0.8, k, p, plan)
    s = logits * np.float32(1.0 / 0.8)
    sk = np.asarray(jsm.apply_top_k(jnp.asarray(s), k)) if k else s
    want = np.asarray(jsm.apply_top_p(jnp.asarray(sk), p)) > jsm.FILTERED / 2
    near = _mass_near_ties(sk, p)
    assert near.mean() <= 0.01
    bad = (kept != want).any(-1) & ~near
    assert not bad.any(), f"rows {np.flatnonzero(bad)} disagree"
    assert kept.any(-1).all()


@pytest.mark.parametrize("b,V", SPLIT_CASES)
@pytest.mark.parametrize("t,k,p", KNOBS)
def test_emulated_kernel_matches_reference_tokens(b, V, t, k, p):
    logits, u = _inputs(ROWS, V, seed=b + V)
    plan = SM._sample_plan(b, V, H100_SMS)
    got, _, _ = emulate(logits, u, t, k, p, plan)
    s = jsm.filtered_scaled(jnp.asarray(logits), temperature=t, top_k=k,
                            top_p=p)
    want = np.asarray(jsm.gumbel_argmax(s, jnp.asarray(u)))
    ties = _token_near_ties(logits, u, t, k, p)
    if p < 1.0:
        sk = (np.asarray(jsm.apply_top_k(jnp.asarray(
            logits * np.float32(1.0 / t)), k)) if k
            else logits * np.float32(1.0 / t))
        ties |= _mass_near_ties(sk, p)
    assert ties.mean() <= 0.01
    bad = (got != want) & ~ties
    assert not bad.any(), f"rows {np.flatnonzero(bad)} disagree"


@pytest.mark.parametrize("t,k,p", KNOBS[:3])
def test_emulated_kernel_matches_reference_pallas_interpret(t, k, p):
    b, V = 16, 2048
    logits, u = _inputs(b, V, seed=11)
    plan = SM._sample_plan(b, V, H100_SMS)
    assert plan.splits == 8
    got, _, _ = emulate(logits, u, t, k, p, plan)
    want = np.asarray(jsm.fused_sample_fwd(
        jnp.asarray(logits), jnp.asarray(u), temperature=t, top_k=k,
        top_p=p, interpret=True))
    ties = _token_near_ties(logits, u, t, k, p)
    assert ties.mean() <= 0.01
    assert not ((got != want) & ~ties).any()


def test_rank_ordered_draw_takes_the_lowest_index_on_ties():
    """Equal perturbed scores in two ranks' shares: rank order and the
    lowest-index rule give the first."""
    V = 2048
    plan = SM._sample_plan(1, V, H100_SMS)
    assert plan.splits == 8
    logits = np.zeros((1, V), np.float32)
    logits[0, [300, 1800]] = 5.0
    u = np.full((1, V), 0.5, np.float32)
    got, _, _ = emulate(logits, u, 1.0, 0, 1.0, plan)
    assert got[0] == 300


def test_dropping_the_last_rank_changes_the_draw():
    """The planted fault of the card's tests, emulated: the last rank left
    out of the merges loses a draw that lies in its share."""
    V = 2048
    plan = SM._sample_plan(1, V, H100_SMS)
    logits = np.zeros((1, V), np.float32)
    logits[0, V - 3] = 9.0
    u = np.full((1, V), 0.5, np.float32)
    got, _, _ = emulate(logits, u, 1.0, 1, 1.0, plan)
    assert got[0] == V - 3
    short = plan._replace(splits=plan.splits - 1)
    lost, _, _ = emulate(logits[:, :short.share * short.splits],
                         u[:, :short.share * short.splits], 1.0, 1, 1.0,
                         short)
    assert lost[0] != V - 3
