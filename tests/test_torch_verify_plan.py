"""The verify kernels' host-side launch plan and their arithmetic, on the
CPU: what ``apex_tpu_torch/ops/fused_verify.py`` decides before it launches
``csrc/fused_verify.cu``, and the kernel emulated.

* ``_verify_plan`` at b 1, 4, 16 × N1 2, 5, 9, 33 × V 32768, 30592 (BERT)
  and 1000: the cluster size S within {1, 2, 4, 8}, b × N1 × S within one
  CTA an SM unless the row needs a larger S to fit the registers (then the
  grid runs in waves), the shares in multiples of 8 covering the row,
  whole warps holding a share in sampled mode, a greedy-only plan that
  walks a share too wide for the registers, the shared memory within a
  CTA's 48 KB of static shared memory; the workspace's layout and epochs.
* A plain emulation of the kernel (numpy): every (batch, verify) row split
  into the plan's S shares; greedy: each rank's argmax merged in rank order
  (ties to the lowest index); sampled: the order-preserving keys, radix
  select in 4 rounds of 8-bit digits for top-k (each rank's 256-bin
  histogram merged in rank order), the largest key, integer masses
  exp(s - m) * 2^40 for z and for each drafted child (the accept flag
  u_acc < q / z in float64), every real child's token filtered from the
  row's draw (a filtered entry at -1e30 + its Gumbel term), each rank's
  draw merged in rank order; then the last arriver's resolution (each
  node's depth and root path from anc, the deepest accepted node, ties to
  the lowest) — held against the JAX reference's ``verify_greedy``,
  ``verify_sampled``, ``verify_tree_greedy``, ``verify_tree_sampled`` and
  ``fused_verify_fwd``/``fused_verify_tree_fwd`` in interpret mode, on
  shared noise. Greedy verdicts must be identical; sampled verdicts may
  differ only on a batch row with a near-tie (an acceptance draw within
  1e-5 relative of its probability, or a row's two best perturbed scores
  within 1e-5 relative), at most 1% of rows. Ties at the k-th value, k = 1,
  k = V, a child outside top-k and trees whose siblings share a parent
  are covered; so are the two planted faults of the card's tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import sampling as jsm
from apex_tpu.ops.pallas import verify as jv
from apex_tpu_torch.ops import fused_verify as VF
from apex_tpu_torch.ops import sampling as SM
from apex_tpu_torch.spec.tree import draft_tree
from test_torch_sample_plan import key_score, radix_select, score_key

H100_SMS = 132
STATIC_SMEM = 48 * 1024
NEAR_TIE = 1e-5
NO_DRAFT = -1


# --- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("V", [32768, 30592, 1000])
@pytest.mark.parametrize("n1", [2, 5, 9, 33])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_plan_at_the_legs_shapes(b, n1, V):
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    S = plan.splits
    assert S in SM.SAMPLE_SPLITS
    assert plan.share % 8 == 0 and plan.share * S >= V
    assert (S - 1) * plan.share < V, "every rank holds some of the row"
    assert plan.values in SM.SAMPLE_VALUES
    assert plan.threads % 32 == 0
    assert SM.SAMPLE_MIN_THREADS <= plan.threads <= 512
    assert plan.threads * plan.values >= plan.share, "sampled: registers"
    assert plan.smem == VF.VERIFY_SMEM <= STATIC_SMEM
    assert VF.VERIFY_SMEM < VF.VERIFY_TOP_P_SMEM <= STATIC_SMEM
    least = min(s for s in SM.SAMPLE_SPLITS
                if SM._fit(SM._share(V, s)) is not None)
    assert S >= least
    rows = b * n1
    assert rows * S <= H100_SMS or S == least, "waves only at the least S"
    if S < 8:
        # a larger S would leave an SM two CTAs or a rank a thin share
        assert (rows * 2 * S > H100_SMS
                or SM._share(V, 2 * S) < SM.SAMPLE_MIN_SHARE)


@pytest.mark.parametrize("b,n1,V,splits,threads,values", [
    (1, 5, 32768, 8, 512, 8),     # the spec leg's chain
    (1, 9, 32768, 8, 512, 8),     # its tree
    (4, 5, 32768, 4, 512, 16),
    (4, 9, 32768, 2, 512, 32),
    (1, 33, 32768, 4, 512, 16),   # the drafters' longest chain
    (4, 33, 32768, 2, 512, 32),   # 132 rows: 264 CTAs in waves
    (1, 9, 30592, 8, 480, 8),
    (16, 9, 1000, 1, 256, 8),
])
def test_plan_takes_each_split(b, n1, V, splits, threads, values):
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    assert (plan.splits, plan.threads, plan.values) == (splits, threads,
                                                        values)


def test_plan_walks_a_greedy_row_too_wide_for_the_registers():
    """Greedy mode takes any V: past what 8 CTAs hold in registers the
    plan keeps 512 threads and the kernel walks its share in a loop."""
    plan = VF._verify_plan(1, 5, 200000, H100_SMS)
    assert plan.splits == 8 and plan.share * 8 >= 200000
    assert (plan.threads, plan.values) == VF.VERIFY_LOOP_FIT
    assert plan.threads * plan.values < plan.share


def test_plan_refuses_what_the_kernel_does_not_take():
    for n1 in (1, VF.KERNEL_MAX_ROWS + 1):
        with pytest.raises(ValueError, match="verify rows"):
            VF._verify_plan(1, n1, 32768, H100_SMS)
    assert VF._verify_plan(1, VF.KERNEL_MAX_ROWS, 32768, H100_SMS)


def test_workspace_layout_and_epochs():
    """Counters first, then two 64-bit slots a row (8-byte aligned); each
    launch a new epoch, never 0; a call with more rows grows a new zeroed
    buffer, one with fewer keeps it."""
    logits = torch.zeros((2, 9, 8))
    VF._WORKSPACES.clear()
    ws = VF._workspace(logits, stream=7)
    assert ws.rows >= 18 and ws.buf.numel() == 5 * ws.rows
    assert not ws.buf.any()
    slots, arrivals, epoch = ws.pointers()
    assert arrivals == ws.buf.data_ptr() and slots == arrivals + 4 * ws.rows
    assert slots % 8 == 0 and epoch == 1
    assert ws.pointers()[2] == 2
    assert VF._workspace(torch.zeros((1, 5, 8)), stream=7) is ws
    assert VF._workspace(logits, stream=8) is not ws  # another stream
    big = VF._workspace(torch.zeros((16, 33, 8)), stream=7)
    assert big is not ws and big.rows >= 16 * 33 and not big.buf.any()
    big.epoch = 2 ** 31 - 1
    assert big.pointers()[2] == 1
    VF._WORKSPACES.clear()


# --- the kernel, emulated ------------------------------------------------------

def _shares(V, plan):
    return [(r * plan.share, min(V, (r + 1) * plan.share))
            for r in range(plan.splits)]


def _argmax_ranks(x, shares, ranks):
    """Each rank's argmax (ties to the lowest index) merged in rank order
    over the first ``ranks`` ranks."""
    best, best_i = -np.inf, None
    for lo, hi in shares[:ranks]:
        if hi > lo:
            i = lo + int(np.argmax(x[lo:hi]))
            if best_i is None or x[i] > best:
                best, best_i = x[i], i
    return best_i


def _top_p_keep(keys, q, top_p):
    """The kernel's top-p threshold over the top-k survivors ``keys`` with
    integer masses ``q``: the largest key whose mass at and above it
    reaches top_p times their total (a float64 compare, as the kernel's
    select_digit and its gathered path both make)."""
    target = float(top_p) * float(q.sum(dtype=np.uint64))
    order = np.argsort(keys, kind="stable")[::-1]
    ks = keys[order]
    cum = np.cumsum(q[order], dtype=np.uint64).astype(np.float64)
    ends = np.r_[ks[1:] != ks[:-1], True]  # the last of each tie group
    return ks[np.flatnonzero(ends & (cum >= target))[0]]


def emulate(logits, tokens, parents, anc, u_acc, u_gum, temperature,
            top_k, plan, fault=None, top_p=1.0):
    """The kernel on fp32 numpy operands as a tree (the chain as the
    one-branch tree): logits (b, N1, V), tokens/parents (b, N1) with node
    0's token ignored, anc (b, N1, N1), u_acc (b, N1) by node, u_gum
    (b, N1, V); ``top_p`` < 1 filters the top-k survivors by the nucleus
    (skipped under the ``no_top_p`` fault). Returns (accept_len, j_star,
    next) (b,) int."""
    b, n1, V = logits.shape
    shares = _shares(V, plan)
    ranks = plan.splits - 1 if fault == "drop_last_rank" else plan.splits
    sampled = temperature > 0
    a_out, j_out, nxt = (np.zeros(b, np.int64) for _ in range(3))
    for bi in range(b):
        tok, par = tokens[bi].copy(), parents[bi]
        tok[0] = NO_DRAFT
        cand = np.full(n1, -1, np.int64)
        acc = np.zeros(n1, bool)
        for r in range(n1):
            kids = [c for c in range(1, n1) if par[c] == r]
            published = not (fault == "no_publish" and r == 0)
            if not sampled:
                c_r = _argmax_ranks(logits[bi, r].astype(np.float32),
                                    shares, ranks)
                cand[r] = c_r if published else -1
                continue
            s = (logits[bi, r].astype(np.float32)
                 * np.float32(1.0 / temperature)).astype(np.float32)
            keys = score_key(s)
            keep = np.uint32(0)
            if top_k > 0:
                keep = radix_select(
                    [(keys[lo:hi], np.ones(hi - lo, np.uint64))
                     for lo, hi in shares[:ranks]], target=float(top_k))
            m = key_score(max(keys[lo:hi].max(initial=0)
                              for lo, hi in shares[:ranks]))
            kept = keys >= keep
            s0 = np.where(s == 0, np.float32(0), s)  # key_score(key(s))
            with np.errstate(over="ignore"):  # a faulted m: exp > 1
                e = np.exp((s0 - m).astype(np.float32)).astype(np.float32)
            # __float2ull_rn saturates at 2^64 - 1
            q_all = np.minimum(np.rint(e.astype(np.float64) * 2.0 ** 40),
                               2.0 ** 63)
            q_all = np.where(q_all >= 2.0 ** 63, np.uint64(2 ** 64 - 1),
                             q_all.astype(np.uint64))
            if top_p < 1.0 and fault != "no_top_p":
                inrank = np.zeros(V, bool)
                for lo, hi in shares[:ranks]:
                    inrank[lo:hi] = True
                live = kept & inrank
                kept = keys >= _top_p_keep(keys[live], q_all[live], top_p)
            q = np.where(kept, q_all, np.uint64(0))
            z = sum((q[lo:hi].sum(dtype=np.uint64)
                     for lo, hi in shares[:ranks]), np.uint64(0))
            drop = np.zeros(V, bool)
            for c in kids:
                if 0 <= tok[c] < V:
                    drop[tok[c]] = True
                qc = q[tok[c]] if 0 <= tok[c] < V else np.uint64(0)
                if published:
                    acc[c] = np.float64(u_acc[bi, c]) < float(qc) / float(z)
            g = (-np.log(-np.log(u_gum[bi, r].astype(np.float32)))).astype(
                np.float32)
            x = (np.where(kept & ~drop, s0, np.float32(jsm.FILTERED))
                 + g).astype(np.float32)
            c_r = _argmax_ranks(x, shares, ranks)
            cand[r] = c_r if published else -1
        # the last arriver's resolution
        if not sampled:
            for c in range(1, n1):
                acc[c] = (0 <= par[c] < n1 and tok[c] >= 0
                          and cand[par[c]] == tok[c])
        acc[0] = True
        best = (-1, n1)
        for i in range(n1):
            path = anc[bi, i] != 0
            if (acc | ~path).all():
                depth = int(path.sum()) - 1
                if depth > best[0]:
                    best = (depth, i)
        a_out[bi], j_out[bi] = best
        nxt[bi] = cand[best[1]]
    return a_out, j_out, nxt


def _chain_as_tree(drafted, u_acc):
    """The chain's operands as the tree's: node c = draft c - 1 with parent
    c - 1; anc lower-triangular; u_acc by node."""
    b, k = drafted.shape
    n1 = k + 1
    tokens = np.concatenate([np.full((b, 1), NO_DRAFT), drafted], 1)
    parents = np.tile(np.maximum(np.arange(n1) - 1, 0), (b, 1))
    anc = np.tile(np.tril(np.ones((n1, n1), np.int32)), (b, 1, 1))
    ua = np.concatenate([np.ones((b, 1), np.float32), u_acc[:, :-1]], 1)
    return tokens.astype(np.int32), parents.astype(np.int32), anc, ua


def _case(b, n1, V, seed, tree, ties=False, branching=2):
    """fp32 logits (a forced argmax tie in row 1; with ``ties`` a few
    distinct values, so ties at every k), drafts that mostly follow their
    parent row's argmax with a wrong sibling and a random last token
    (usually outside top-k), noise in [tiny, 1)."""
    rng = np.random.default_rng(seed)
    if ties:
        logits = rng.integers(-6, 7, (b, n1, V)).astype(np.float32) * 0.5
    else:
        logits = (rng.standard_normal((b, n1, V)) * 4.0).astype(np.float32)
    logits[:, 1, 7] = logits[:, 1].max(-1) + 1.0
    logits[:, 1, 3] = logits[:, 1, 7]
    cand = np.asarray(jv.row_argmax(jnp.asarray(logits)))
    tiny = np.finfo(np.float32).tiny
    u_acc = np.maximum(rng.random((b, n1)), tiny).astype(np.float32)
    u_gum = np.maximum(rng.random((b, n1, V)), tiny).astype(np.float32)
    if tree:
        topo = draft_tree(branching, (n1 - 1) // branching)
        parents, anc = topo.operands(b)
        tokens = np.take_along_axis(cand, parents, -1).astype(np.int32)
        tokens[:, 2] = (tokens[:, 2] + 1) % V
        tokens[:, -1] = rng.integers(0, V, b)
        tokens[:, 0] = NO_DRAFT
        return logits, (tokens, parents, anc), u_acc, u_gum
    drafted = cand[:, :-1].astype(np.int32)
    drafted[:, -1] = rng.integers(0, V, b)
    return logits, (drafted,), u_acc, u_gum


def _near_ties(logits, tokens, parents, u_acc, u_gum, t, k):
    """Batch rows where a near-tie could flip a sampled verdict (tree form,
    u_acc by node)."""
    s = np.asarray(jsm.filtered_scaled(jnp.asarray(logits), temperature=t,
                                       top_k=k, top_p=1.0), np.float64)
    b, n1, V = s.shape
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    z = e.sum(-1)
    tie = np.zeros(b, bool)
    x = s - np.log(-np.log(u_gum.astype(np.float64)))
    for bi in range(b):
        for c in range(1, n1):
            tk, p = tokens[bi, c], parents[bi, c]
            if 0 <= tk < V:
                ratio = e[bi, p, tk] / z[bi, p]
                tie[bi] |= abs(u_acc[bi, c] - ratio) <= NEAR_TIE * ratio
                x[bi, p, tk] = jsm.FILTERED
    top2 = np.sort(x, axis=-1)[..., -2:]
    # a row whose every entry is filtered ties exactly at -1e30: both
    # sides take the lowest index, so that is no near-tie
    gap = (np.abs(top2[..., 1] - top2[..., 0])
           <= NEAR_TIE * np.abs(top2[..., 1])) & (top2[..., 1]
                                                  > jsm.FILTERED / 2)
    return tie | gap.any(-1)


def _reference(logits, extra, u_acc, u_gum, tree, t, k):
    """The JAX reference's helpers on the same operands."""
    L = jnp.asarray(logits)
    if tree:
        tokens, parents, anc = (jnp.asarray(x) for x in extra)
        if t == 0:
            out = jv.verify_tree_greedy(L, tokens, parents, anc)
        else:
            out = jv.verify_tree_sampled(L, tokens, parents, anc,
                                         jnp.asarray(u_acc),
                                         jnp.asarray(u_gum), temperature=t,
                                         top_k=k, top_p=1.0)
        return tuple(np.asarray(x) for x in out)
    b = logits.shape[0]
    pad = jnp.concatenate([jnp.asarray(extra[0]),
                           jnp.full((b, 1), NO_DRAFT, jnp.int32)], 1)
    if t == 0:
        a, nxt = jv.verify_greedy(L, pad)
    else:
        a, nxt = jv.verify_sampled(L, pad, jnp.asarray(u_acc),
                                   jnp.asarray(u_gum), temperature=t,
                                   top_k=k, top_p=1.0)
    return np.asarray(a), np.asarray(nxt)


def _emulate_case(logits, extra, u_acc, u_gum, tree, t, k, plan,
                  fault=None):
    """(the emulation's verdicts in the reference's shape, the tree-form
    tokens and parents, u_acc by node)."""
    if tree:
        tokens, parents, anc = extra
        ua = u_acc
    else:
        tokens, parents, anc, ua = _chain_as_tree(extra[0], u_acc)
    a, j, nxt = emulate(logits, tokens, parents, anc, ua, u_gum, t, k, plan,
                        fault)
    return ((a, j, nxt) if tree else (a, nxt)), tokens, parents, ua


# (b, n1, V) whose plans split the rows: S 8 at V 2048, S 4 at V 1000 (the
# last rank's share shorter), S 1 at b 16 x n1 9 x V 256
SPLIT_CASES = [(2, 5, 2048), (3, 9, 1000), (16, 9, 256)]
# (T, top_k): the spec leg's knobs, no top-k, k = 1, k = V
KNOBS = [(0.0, 0), (0.8, 50), (1.3, 0), (0.7, 1), (0.9, "V")]


@pytest.mark.parametrize("b,n1,V", SPLIT_CASES)
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("t,k", KNOBS)
@pytest.mark.parametrize("ties", [False, True])
def test_emulated_kernel_matches_reference_verdicts(b, n1, V, tree, t, k,
                                                    ties):
    k = V if k == "V" else k
    seed = b * 1000 + n1 * 10 + V + int(tree) + 7 * int(ties)
    logits, extra, u_acc, u_gum = _case(b, n1, V, seed, tree, ties=ties)
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    got, tokens, parents, ua = _emulate_case(logits, extra, u_acc, u_gum,
                                             tree, t, k, plan)
    want = _reference(logits, extra, u_acc, u_gum, tree, t, k)
    bad = np.zeros(b, bool)
    for x, y in zip(got, want):
        bad |= x != y
    if t > 0:
        near = _near_ties(logits, tokens, parents, ua, u_gum, t, k)
        assert near.mean() <= 0.01 or near.sum() <= 1
        bad &= ~near
    assert not bad.any(), f"rows {np.flatnonzero(bad)}: {got} vs {want}"


@pytest.mark.parametrize("branching,depth", [(2, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("t,k", [(0.0, 0), (0.8, 50)])
def test_siblings_sharing_a_parent(branching, depth, t, k):
    """Wider trees: a row with several drafted children (4 and 8 at the
    root) filters all their tokens from its draw and takes each child's
    flag from its own mass."""
    n1 = branching * depth + 1
    b, V = 8, 2048
    logits, extra, u_acc, u_gum = _case(b, n1, V, 31 + branching, True,
                                        branching=branching)
    tokens = extra[0].copy()
    rng = np.random.default_rng(branching)
    # the root's children draft its top few tokens (each has real mass)
    top = np.argsort(-logits[:, 0], axis=-1)[:, :branching]
    for j in range(branching):
        tokens[:, 1 + j * depth] = top[:, j]
    tokens[:, 1] = rng.integers(0, V, b)  # one child outside top-k
    extra = (tokens, *extra[1:])
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    got, tokens, parents, ua = _emulate_case(logits, extra, u_acc, u_gum,
                                             True, t, k, plan)
    want = _reference(logits, extra, u_acc, u_gum, True, t, k)
    bad = np.zeros(b, bool)
    for x, y in zip(got, want):
        bad |= x != y
    if t > 0:
        bad &= ~_near_ties(logits, tokens, parents, ua, u_gum, t, k)
    assert not bad.any()


def test_every_child_rejected_draws_from_the_filtered_row():
    """top-k 2 and the row's two kept tokens both drafted and both
    rejected: the draw is over -1e30 + Gumbel everywhere, so the
    reference's lowest index, 0."""
    b, n1, V = 1, 3, 256
    logits = np.zeros((b, n1, V), np.float32)
    logits[0, 0, [40, 90]] = 10.0
    tokens = np.array([[NO_DRAFT, 40, 90]], np.int32)
    parents = np.array([[0, 0, 0]], np.int32)
    anc = np.array([[[1, 0, 0], [1, 1, 0], [1, 0, 1]]], np.int32)
    u_acc = np.array([[1.0, 0.9, 0.9]], np.float32)
    u_gum = np.full((b, n1, V), 0.5, np.float32)
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    got = emulate(logits, tokens, parents, anc, u_acc, u_gum, 1.0, 2, plan)
    want = _reference(logits, (tokens, parents, anc), u_acc, u_gum, True,
                      1.0, 2)
    assert [int(x[0]) for x in got] == [int(x[0]) for x in want] == [0, 0, 0]


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("t,k", [(0.0, 0), (0.8, 50)])
def test_emulated_kernel_matches_reference_pallas_interpret(tree, t, k):
    b, n1, V = 2, 9, 2048
    logits, extra, u_acc, u_gum = _case(b, n1, V, 11, tree)
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    assert plan.splits == 4  # 18 rows: 72 CTAs
    got, tokens, parents, ua = _emulate_case(logits, extra, u_acc, u_gum,
                                             tree, t, k, plan)
    L = jnp.asarray(logits)
    lanes = jv.VERIFY_LANES

    def pad(x, fill):
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, lanes - x.shape[1])),
                       constant_values=fill)

    noise = (pad(u_acc, 1.0), jnp.asarray(u_gum)) if t else (None, None)
    kw = dict(temperature=t, top_k=k, top_p=1.0, interpret=True)
    if tree:
        tk, par, anc = extra
        anc_pad = jnp.pad(jnp.asarray(anc),
                          ((0, 0), (0, 0), (0, lanes - n1)))
        want = jv.fused_verify_tree_fwd(L, pad(tk, NO_DRAFT), pad(par, 0),
                                        anc_pad, *noise, **kw)
    else:
        dp = np.concatenate([extra[0], np.full((b, 1), NO_DRAFT)], 1)
        want = jv.fused_verify_fwd(L, pad(dp.astype(np.int32), NO_DRAFT),
                                   *noise, **kw)
    want = tuple(np.asarray(x) for x in want)
    bad = np.zeros(b, bool)
    for x, y in zip(got, want):
        bad |= x != y
    if t > 0:
        bad &= ~_near_ties(logits, tokens, parents, ua, u_gum, t, k)
    assert not bad.any()


def test_tree_resolution_matches_reference_path():
    """The last arriver's walk (depth and root path from anc, the deepest
    accepted node, ties to the lowest) against tree_accepted_path on
    random flags."""
    rng = np.random.default_rng(3)
    for branching, depth in [(2, 4), (3, 3), (1, 6), (4, 8)]:
        topo = draft_tree(branching, depth)
        acc = rng.random((64, topo.n1)) < 0.6
        a, j = (np.asarray(x) for x in jv.tree_accepted_path(
            jnp.asarray(acc), jnp.asarray(np.tile(topo.anc, (64, 1, 1)))))
        for i in range(64):
            flags = acc[i].copy()
            flags[0] = True
            best = max(((int(topo.anc[n].sum()) - 1, -n)
                        for n in range(topo.n1)
                        if (flags | (topo.anc[n] == 0)).all()))
            assert (best[0], -best[1]) == (a[i], j[i])


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("t,k", [(0.0, 0), (0.8, 50)])
@pytest.mark.parametrize("fault", ("drop_last_rank", "no_publish"))
def test_planted_faults_change_the_verdict(tree, t, k, fault):
    """The card's planted-fault case, emulated: row 0's largest logit, 30
    above the rest, in the last rank's share, its children drafting other
    tokens with draws near 1. The sound kernel emits that token; leaving
    out the last rank, or row 0's slots (candidate -1), cannot."""
    b, n1, V = 2, 9, 2048
    logits, extra, u_acc, u_gum = _case(b, n1, V, 5, tree)
    logits[:, 0, V - 5] = logits[:, 0].max(-1) + 30.0
    if tree:
        tokens = extra[0].copy()
        tokens[:, 1], tokens[:, 1 + (n1 - 1) // 2] = 11, 12
        extra = (tokens, *extra[1:])
    else:
        drafted = extra[0].copy()
        drafted[:, 0] = 11
        extra = (drafted,)
    u_acc = np.full_like(u_acc, 0.999)
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    assert plan.splits == 4  # 18 rows: 72 CTAs
    sound, *_ = _emulate_case(logits, extra, u_acc, u_gum, tree, t, k, plan)
    want = _reference(logits, extra, u_acc, u_gum, tree, t, k)
    for x, y in zip(sound, want):
        np.testing.assert_array_equal(x, y)
    assert (want[-1] == V - 5).all()
    got, *_ = _emulate_case(logits, extra, u_acc, u_gum, tree, t, k, plan,
                            fault)
    bad = np.zeros(b, bool)
    for x, y in zip(got, want):
        bad |= x != y
    assert bad.all()
