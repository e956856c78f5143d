"""The verify pair's top-p option (the serve's sampled spec rounds) against
the JAX reference, on the CPU.

* The port's plain versions (``fused_verify``/``fused_verify_tree`` on CPU
  tensors) against the reference's ``verify_sampled``/
  ``verify_tree_sampled`` and against its Pallas ``fused_verify_fwd``/
  ``fused_verify_tree_fwd`` in interpret mode (V 256, a multiple of
  128), at top_p 0.5 and 0.9 × top_k 0 and 50, on shared noise: verdicts
  identical (fp32 on both sides; these rows hold no near-tie, which the
  test checks rather than assumes).
* The kernel emulated (``test_torch_verify_plan.emulate``: top-k by radix
  select, then top-p over the survivors with the kernel's integer masses,
  as its gathered path and its mass rounds both take it) against the
  reference on the same operands, at plans that split the rows: verdicts
  identical outside near-ties (an acceptance draw, the two best perturbed
  scores, or a cumulative mass at the nucleus boundary within 1e-5
  relative), at most 1% of rows.
* A draft inside top-k but outside the nucleus is never accepted, under
  64 acceptance draws spread over (0, 1); with top-p skipped (the ``no_top_p``
  planted fault of the card's tests) the emulated kernel accepts it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import sampling as jsm
from apex_tpu.ops.pallas import verify as jv
from apex_tpu_torch.ops import fused_verify as VF
from test_torch_verify_plan import (H100_SMS, NEAR_TIE, NO_DRAFT, _case,
                                    _chain_as_tree, emulate)

KNOBS = [(0, 0.5), (0, 0.9), (50, 0.5), (50, 0.9)]
T = 0.8


def _reference(logits, extra, u_acc, u_gum, tree, k, p):
    """The JAX reference's sampled helpers (tree form for the tree)."""
    L = jnp.asarray(logits)
    kw = dict(temperature=T, top_k=k, top_p=p)
    if tree:
        out = jv.verify_tree_sampled(L, *(jnp.asarray(x) for x in extra),
                                     jnp.asarray(u_acc), jnp.asarray(u_gum),
                                     **kw)
        return tuple(np.asarray(x) for x in out)
    b = logits.shape[0]
    pad = jnp.concatenate([jnp.asarray(extra[0]),
                           jnp.full((b, 1), NO_DRAFT, jnp.int32)], 1)
    a, nxt = jv.verify_sampled(L, pad, jnp.asarray(u_acc),
                               jnp.asarray(u_gum), **kw)
    return np.asarray(a), np.asarray(nxt)


def _port(logits, extra, u_acc, u_gum, tree, k, p):
    """The port's op on CPU tensors (its plain version)."""
    fn = VF.fused_verify_tree if tree else VF.fused_verify
    out = fn(torch.from_numpy(logits), *(torch.from_numpy(x) for x in extra),
             temperature=T, top_k=k, top_p=p,
             u_acc=torch.from_numpy(u_acc), u_gum=torch.from_numpy(u_gum))
    return tuple(x.numpy() for x in out)


def _near_ties(logits, tokens, parents, u_acc, u_gum, k, p):
    """Batch rows where a near-tie could flip a top-p verdict (tree form,
    u_acc by node): an acceptance draw near its probability, a row's two
    best perturbed scores near each other, or a cumulative mass of the
    top-k survivors (best first) near top_p times their total."""
    s = np.asarray(jsm.filtered_scaled(jnp.asarray(logits), temperature=T,
                                       top_k=k, top_p=p), np.float64)
    sk = np.asarray(jsm.filtered_scaled(jnp.asarray(logits), temperature=T,
                                        top_k=k, top_p=1.0), np.float64)
    b, n1, V = s.shape
    e = np.exp(s - s.max(-1, keepdims=True))
    z = e.sum(-1)
    sk = -np.sort(-sk, axis=-1)
    cum = np.cumsum(np.exp(sk - sk[..., :1]), -1)
    target = p * cum[..., -1:]
    # the cumulative mass at the last entry of each group of equal scores
    ends = np.concatenate([sk[..., 1:] != sk[..., :-1],
                           np.ones(sk.shape[:-1] + (1,), bool)], -1)
    edge = (ends & (np.abs(cum - target) <= NEAR_TIE * target)).any(-1)
    edge = edge.any(-1)
    tie = np.zeros(b, bool)
    x = s - np.log(-np.log(u_gum.astype(np.float64)))
    for bi in range(b):
        for c in range(1, n1):
            tk, par = tokens[bi, c], parents[bi, c]
            if 0 <= tk < V:
                ratio = e[bi, par, tk] / z[bi, par]
                tie[bi] |= abs(u_acc[bi, c] - ratio) <= NEAR_TIE * ratio
                x[bi, par, tk] = jsm.FILTERED
    top2 = np.sort(x, axis=-1)[..., -2:]
    gap = (np.abs(top2[..., 1] - top2[..., 0])
           <= NEAR_TIE * np.abs(top2[..., 1])) & (top2[..., 1]
                                                  > jsm.FILTERED / 2)
    return tie | gap.any(-1) | edge


def _tree_form(extra, u_acc, tree):
    if tree:
        return extra[0], extra[1], u_acc
    b, k = extra[0].shape
    tokens = np.concatenate([np.full((b, 1), NO_DRAFT), extra[0]], 1)
    parents = np.tile(np.maximum(np.arange(k + 1) - 1, 0), (b, 1))
    ua = np.concatenate([np.ones((b, 1), np.float32), u_acc[:, :-1]], 1)
    return tokens.astype(np.int32), parents.astype(np.int32), ua


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("k,p", KNOBS)
def test_plain_versions_match_reference_helpers(tree, k, p):
    b, n1, V = 4, 9, 256
    logits, extra, u_acc, u_gum = _case(b, n1, V, 40 + k, tree)
    tokens, parents, ua = _tree_form(extra, u_acc, tree)
    assert not _near_ties(logits, tokens, parents, ua, u_gum, k, p).any()
    got = _port(logits, extra, u_acc, u_gum, tree, k, p)
    want = _reference(logits, extra, u_acc, u_gum, tree, k, p)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("k,p", KNOBS)
def test_plain_versions_match_reference_pallas_interpret(tree, k, p):
    """The reference's Pallas verify kernels in interpret mode (its
    kernel bodies run the same helpers inside the grid) on the port's
    operands."""
    b, n1, V = 2, 9, 256
    logits, extra, u_acc, u_gum = _case(b, n1, V, 60 + k, tree)
    tokens, parents, ua = _tree_form(extra, u_acc, tree)
    assert not _near_ties(logits, tokens, parents, ua, u_gum, k, p).any()
    lanes = jv.VERIFY_LANES

    def pad(x, fill):
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, lanes - x.shape[1])),
                       constant_values=fill)

    kw = dict(temperature=T, top_k=k, top_p=p, interpret=True)
    L = jnp.asarray(logits)
    if tree:
        tk, par, anc = extra
        anc_pad = jnp.pad(jnp.asarray(anc), ((0, 0), (0, 0),
                                             (0, lanes - n1)))
        want = jv.fused_verify_tree_fwd(L, pad(tk, NO_DRAFT), pad(par, 0),
                                        anc_pad, pad(u_acc, 1.0),
                                        jnp.asarray(u_gum), **kw)
    else:
        dp = np.concatenate([extra[0], np.full((b, 1), NO_DRAFT)], 1)
        want = jv.fused_verify_fwd(L, pad(dp.astype(np.int32), NO_DRAFT),
                                   pad(u_acc, 1.0), jnp.asarray(u_gum), **kw)
    got = _port(logits, extra, u_acc, u_gum, tree, k, p)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))


# (b, n1, V) whose plans split the rows: S 8 at V 2048, S 4 at V 1000
SPLIT_CASES = [(2, 5, 2048), (3, 9, 1000)]


@pytest.mark.parametrize("b,n1,V", SPLIT_CASES)
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("k,p", KNOBS)
@pytest.mark.parametrize("ties", [False, True])
def test_emulated_kernel_matches_reference(b, n1, V, tree, k, p, ties):
    """With ``ties`` the logits take a few distinct values: ties at the
    k-th value push top-k's survivors past the 256 the kernel gathers, so
    it takes the mass rounds (the same threshold)."""
    logits, extra, u_acc, u_gum = _case(b, n1, V, b * 100 + n1 + k, tree,
                                        ties=ties)
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    got_p, tokens, parents, ua = _emulate_case_p(logits, extra, u_acc,
                                                 u_gum, tree, k, p, plan)
    want = _reference(logits, extra, u_acc, u_gum, tree, k, p)
    bad = np.zeros(b, bool)
    for x, y in zip(got_p, want):
        bad |= x != y
    near = _near_ties(logits, tokens, parents, ua, u_gum, k, p)
    assert near.mean() <= 0.01 or near.sum() <= 1
    assert not (bad & ~near).any(), f"{got_p} vs {want}"


def _emulate_case_p(logits, extra, u_acc, u_gum, tree, k, p, plan,
                    fault=None):
    if tree:
        tokens, parents, anc = extra
        ua = u_acc
    else:
        tokens, parents, anc, ua = _chain_as_tree(extra[0], u_acc)
    a, j, nxt = emulate(logits, tokens, parents, anc, ua, u_gum, T, k, plan,
                        fault, top_p=p)
    return ((a, j, nxt) if tree else (a, nxt)), tokens, parents, ua


def _outside_nucleus(tree, draws=64):
    """Row 0 puts 0.95 of its mass on token 100; row 0's first child
    drafts the runner-up (p 0.047 before top-p), inside top-k but outside
    the 0.9 nucleus; every row's top 50 are distinct."""
    b, n1, V = draws, (9 if tree else 5), 512
    logits, extra, u_acc, u_gum = _case(b, n1, V, 9, tree)
    logits[:, 0] = -30.0
    logits[:, 0, 300:348] = -10.0 + 0.125 * np.arange(48)
    logits[:, 0, 100] = 8.0
    logits[:, 0, 200] = 5.6
    # acceptance draws spread over (0, 1), the same for every node
    u_acc = np.repeat(np.linspace(1e-3, 0.999, b, dtype=np.float32)[:, None],
                      n1, 1)
    if tree:
        tokens = extra[0].copy()
        tokens[:, 1] = 200
        return logits, (tokens, *extra[1:]), u_acc, u_gum
    drafted = extra[0].copy()
    drafted[:, 0] = 200
    return logits, (drafted,), u_acc, u_gum


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("k", [0, 50])
def test_draft_outside_the_nucleus_is_never_accepted(tree, k):
    logits, extra, u_acc, u_gum = _outside_nucleus(tree)
    for got in (_port(logits, extra, u_acc, u_gum, tree, k, 0.9),
                _reference(logits, extra, u_acc, u_gum, tree, k, 0.9)):
        assert (got[0] == 0).all()
        assert (got[-1] == 100).all()  # the nucleus is {100}
    # the same draws without the nucleus accept it where u_acc < 0.047
    off = _reference(logits, extra, u_acc, u_gum, tree, k, 1.0)
    assert (off[0] > 0).any()


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("k", [0, 50])
def test_no_top_p_fault_accepts_it(tree, k):
    """The card's ``no_top_p`` fault, emulated at a plan of 4 ranks: the
    sound kernel rejects the draft at every batch row, the faulted one
    accepts it where u_acc = 1e-3."""
    logits, extra, u_acc, u_gum = _outside_nucleus(tree, draws=4)
    u_acc = np.full_like(u_acc, 1e-3)
    b, n1, V = logits.shape
    plan = VF._verify_plan(b, n1, V, H100_SMS)
    sound, *_ = _emulate_case_p(logits, extra, u_acc, u_gum, tree, k, 0.9,
                                plan)
    assert (sound[0] == 0).all() and (sound[-1] == 100).all()
    bad, *_ = _emulate_case_p(logits, extra, u_acc, u_gum, tree, k, 0.9,
                              plan, fault="no_top_p")
    assert (bad[0] >= 1).all()
    assert "no_top_p" in VF.PLANTED_FAULTS


def test_top_p_is_validated_as_the_reference():
    logits = torch.zeros((1, 3, 16))
    drafted = torch.zeros((1, 2), dtype=torch.int32)
    for p in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError, match="top_p"):
            VF.fused_verify(logits, drafted, temperature=0.8, top_p=p,
                            generator=torch.Generator())
        with pytest.raises(ValueError, match="top_p"):
            VF.fused_verify_tree(logits, torch.zeros((1, 3), dtype=torch.int32),
                                 torch.zeros((1, 3), dtype=torch.int32),
                                 torch.ones((1, 3, 3), dtype=torch.int32),
                                 temperature=0.8, top_p=p,
                                 generator=torch.Generator())
    # greedy ignores the filters, as the reference does
    a, nxt = VF.fused_verify(logits, drafted + 1, top_p=0.5)
    assert int(a[0]) == 0 and int(nxt[0]) == 0
