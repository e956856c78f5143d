"""Port parity for contrib's ASP: ``apex_tpu_torch.contrib.sparsity``
against ``apex_tpu.contrib.sparsity`` on the same seeded numpy inputs.

* the 2:4 masks identical to the reference's ``create_mask`` (ties broken
  by the stable argsort, as the reference's);
* ``exhaustive_search`` at C = 8: the same permutation, its improvement
  within 1e-5 relative;
* ``greedy_swap_search``: the same permutation where no near-tie decides
  an argmax, otherwise the retained sum within 1e-6 relative;
* the swap scores, and the row-chunked M against the unchunked one and
  the reference's broadcast, within 1e-6 relative;
* ASP's masks over a per-layer GPT tree equal to the reference's on the
  same tree, and pruned entries exactly 0 (and every group 2 of 4) after
  3 FusedAdam steps under ``wrap_optimizer``;
* the divergence the port's per-layer weights make: the reference's search
  over a stacked (layers, out, in) weight finds one permutation for all
  layers, the port's tree one per layer (equal to the reference's on the
  per-layer tree).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import sparsity as jsp
from apex_tpu.contrib.sparsity import permutation as jperm
from apex_tpu_torch.contrib import sparsity as tsp
from apex_tpu_torch.contrib.sparsity import permutation as tperm
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, param_leaves
from apex_tpu_torch.optimizers import FusedAdam


def _matrix(rows, cols, seed):
    return np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 16), (3, 5, 12), (64, 128)])
def test_masks_match_reference(shape):
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    w.reshape(-1, shape[-1])[0, :8] = 0.5          # ties inside groups
    w.reshape(-1, shape[-1])[1, 4:8] = [-1, 1, -1, 1]
    want = np.asarray(jsp.create_mask(jnp.asarray(w)))
    got = tsp.create_mask(torch.tensor(w)).numpy()
    assert np.array_equal(got, want)
    assert (got.reshape(-1, 4).sum(-1) == 2).all()
    with pytest.raises(ValueError):
        tsp.mask_2to4_best(torch.zeros((2, 6)))


def test_exhaustive_search_matches_reference():
    m = _matrix(6, 8, seed=1)
    pj, ij = jperm.exhaustive_search(jnp.asarray(m))
    pt, it = tperm.exhaustive_search(torch.tensor(m))
    assert np.array_equal(pt, pj)
    np.testing.assert_allclose(it, ij, rtol=1e-5)
    # the dispatcher takes it at C <= 8
    assert np.array_equal(tperm.search_for_good_permutation(
        torch.tensor(m))[0], pj)


@pytest.mark.parametrize("rows,cols,seed", [(16, 32, 0), (24, 64, 1),
                                            (40, 48, 2)])
def test_greedy_search_matches_reference(rows, cols, seed):
    m = _matrix(rows, cols, seed)
    pj, ij = jperm.greedy_swap_search(jnp.asarray(m))
    pt, it = tperm.greedy_swap_search(torch.tensor(m))
    if not np.array_equal(pt, pj):
        # a near-tie decided an argmax differently: the retained sums agree
        kj = float(jperm.sum_after_2_to_4(jnp.asarray(m[:, pj])))
        kt = float(tperm.sum_after_2_to_4(torch.tensor(m[:, pt])))
        assert abs(kt - kj) <= 1e-6 * abs(kj)
    else:
        np.testing.assert_allclose(it, ij, rtol=1e-5)
    before = float(tperm.sum_after_2_to_4(torch.tensor(m)))
    after = float(tperm.sum_after_2_to_4(torch.tensor(m[:, pt])))
    np.testing.assert_allclose(after - before, it, rtol=1e-4)


def test_swap_scores_and_chunked_m_match_reference():
    m = _matrix(37, 32, seed=4)
    want = np.asarray(jperm._swap_improvements(jnp.asarray(m)))
    finite = np.isfinite(want)
    w = torch.tensor(np.abs(m))
    s2 = torch.tensor(_matrix(37, 32, seed=5))
    whole = tperm._relu_cross_sum(w, s2, chunk_rows=37)
    brute = np.maximum(np.abs(m)[:, None, :] - s2.numpy()[:, :, None],
                       0).sum(0)
    np.testing.assert_allclose(whole.numpy(), brute, rtol=1e-6, atol=1e-5)
    for chunk in (1, 5, 16):
        np.testing.assert_allclose(
            tperm._relu_cross_sum(w, s2, chunk_rows=chunk).numpy(),
            whole.numpy(), rtol=1e-6, atol=1e-5)
        got = tperm._swap_improvements(torch.tensor(m), chunk_rows=chunk)
        assert np.array_equal(np.isfinite(got.numpy()), finite)
        np.testing.assert_allclose(got.numpy()[finite], want[finite],
                                   rtol=1e-6, atol=1e-4)


def test_permutation_helpers():
    perm = np.random.default_rng(0).permutation(16)
    w = torch.tensor(_matrix(4, 16, seed=6))
    back = tsp.apply_permutation(tsp.apply_permutation(w, perm),
                                 tsp.invert_permutation(perm))
    assert torch.equal(back, w)
    assert np.array_equal(tsp.invert_permutation(perm),
                          jperm.invert_permutation(perm))
    np.testing.assert_allclose(
        float(tsp.sum_after_2_to_4(w)),
        float(jsp.sum_after_2_to_4(jnp.asarray(w.numpy()))), rtol=1e-6)


def _gpt():
    model = GPTModel(GPTConfig(vocab_size=64, max_seq_len=16, hidden_size=32,
                               num_layers=2, num_heads=2))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return model, params


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_numpy_tree(v) for v in t]
    return jnp.asarray(t.detach().numpy())


def test_asp_masks_and_three_fused_adam_steps():
    """The masks over the per-layer tree equal the reference's on the same
    tree; after apply_masks and 3 steps of wrap_optimizer(FusedAdam) every
    pruned entry is exactly 0 and every kept group still 2 of 4."""
    model, params = _gpt()
    asp = tsp.ASP()
    masks = asp.compute_sparse_masks(params)
    jmasks = jsp.ASP().compute_sparse_masks(_numpy_tree(params))
    for m, jm in zip(param_leaves(masks), _jax_leaves(jmasks)):
        assert np.array_equal(m.numpy(), np.asarray(jm))
    params = asp.apply_masks(params, masks)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    opt = asp.wrap_optimizer(FusedAdam(leaves, lr=1e-2), masks)
    rng = np.random.default_rng(0)
    for _ in range(3):
        tokens = torch.tensor(rng.integers(0, 64, (2, 16)))
        loss = model.loss_fn(params, tokens, tokens)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        for t, m in zip(leaves, param_leaves(masks)):
            if m.ndim:
                assert (t.detach()[~m] == 0).all()
                assert ((t.detach() != 0).reshape(-1, 4).sum(-1) <= 2).all()
    pruned = [m for m in param_leaves(masks) if m.ndim]
    assert len(pruned) >= 8   # each layer's four linear weights, at least


def _jax_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _jax_leaves(v)]
    return [tree]


def test_wrap_optimizer_refuses_a_mismatched_tree():
    _, params = _gpt()
    asp = tsp.ASP()
    masks = asp.compute_sparse_masks(params)
    with pytest.raises(ValueError, match="masks"):
        asp.wrap_optimizer(FusedAdam(param_leaves(params)[:3]), masks)


def test_per_layer_permutations_diverge_from_the_stacked_search():
    """The port's tree keeps a tensor per layer: one permutation each,
    equal to the reference's search over the same per-layer tree. The
    reference's own models stack the layers, and its search over the
    stacked (L, out, in) weight gives one permutation for all of them,
    which differs."""
    rng = np.random.default_rng(3)
    per_layer = [rng.standard_normal((12, 32)).astype(np.float32)
                 for _ in range(2)]
    asp = tsp.ASP()
    got = asp.search_permutations({"w": [torch.tensor(w) for w in
                                         per_layer]})
    want = jsp.ASP().search_permutations({"w": [jnp.asarray(w) for w in
                                                per_layer]})
    for g, w, m in zip(got["w"], want["w"], per_layer):
        kg = float(tperm.sum_after_2_to_4(torch.tensor(m[:, g])))
        kw = float(jperm.sum_after_2_to_4(jnp.asarray(m[:, w])))
        assert np.array_equal(g, w) or abs(kg - kw) <= 1e-6 * abs(kw)
    stacked = jsp.ASP().search_permutations(
        {"w": jnp.asarray(np.stack(per_layer))})["w"]
    assert not all(np.array_equal(stacked, g) for g in got["w"])
    permuted = asp.permute_params({"w": [torch.tensor(w) for w in
                                         per_layer]}, got)
    for p, g, w in zip(permuted["w"], got["w"], per_layer):
        assert torch.equal(p, torch.tensor(w[:, g]))


def test_greedy_search_kept_m_equals_a_rebuild_every_sweep():
    """The search keeps M current across swaps (8 rows recomputed, two
    columns swapped); rebuilding the scores from the permuted matrix every
    sweep, as the reference does, takes the same swaps."""
    m = torch.tensor(_matrix(48, 96, seed=8))
    perm, gain = tperm.greedy_swap_search(m, max_sweeps=40)
    want = np.arange(96)
    work = m.clone()
    total = 0.0
    for _ in range(40):
        delta = tperm._swap_improvements(work)
        flat = int(torch.argmax(delta))
        if float(delta.reshape(-1)[flat]) <= 1e-6:
            break
        i, j = divmod(flat, 96)
        want[[i, j]] = want[[j, i]]
        work[:, [i, j]] = work[:, [j, i]]
        total += float(delta.reshape(-1)[flat])
    assert np.array_equal(perm, want)
    np.testing.assert_allclose(gain, total, rtol=1e-6)
