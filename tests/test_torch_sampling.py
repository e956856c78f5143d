"""Port parity: apex_tpu_torch's fused sampling tail against apex_tpu's.

Both packages get the same logits and the same uniform noise ``u`` (made
with numpy: torch cannot reproduce JAX's threefry bits). The port's plain
version must pick the same token as the reference's shared helpers
(``filtered_scaled`` + ``gumbel_argmax``) and as its Pallas kernel in
interpret mode. ``log`` is computed by two libraries, so a row whose top
two perturbed scores lie within 1e-5 relative is excluded and counted; at
most 1% of rows may be. The kept sets of top-k and top-p must be equal.
The CUDA kernel is held against the plain version on the card by
``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.sampling import FILTERED as JFILTERED
from apex_tpu.ops.pallas.sampling import filtered_scaled as jfiltered
from apex_tpu.ops.pallas.sampling import fused_sample_fwd
from apex_tpu.ops.pallas.sampling import gumbel_argmax as jgumbel
from apex_tpu_torch.ops import sampling as smod
from apex_tpu_torch.ops.sampling import (FILTERED, filtered_scaled,
                                         fused_sample)

V = 256
NEAR_TIE = 1e-5
KNOBS = [pytest.param(t, k, p, id=f"T{t}-k{k}-p{p}")
         for t in (0.7, 1.3) for k in (0, 5) for p in (1.0, 0.9)]


def _inputs(rows, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, V)) * 2.0).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    u = np.maximum(rng.random((rows, V)), tiny).astype(np.float32)
    return logits, u


def _near_ties(logits, u, t, k, p):
    """Rows whose two best perturbed scores (reference arithmetic) lie
    within NEAR_TIE relative: either token is a correct draw there."""
    s = np.asarray(jfiltered(jnp.asarray(logits), temperature=t, top_k=k,
                             top_p=p))
    x = s - np.log(-np.log(u.astype(np.float64)))
    top2 = np.sort(x, axis=-1)[:, -2:]
    return np.abs(top2[:, 1] - top2[:, 0]) <= NEAR_TIE * np.abs(top2[:, 1])


def _assert_tokens_match(got, want, ties):
    assert ties.mean() <= 0.01, f"{ties.sum()} near-tie rows excluded"
    bad = (got != want) & ~ties
    assert not bad.any(), f"rows {np.flatnonzero(bad)} disagree"


@pytest.mark.parametrize("t,k,p", KNOBS)
def test_plain_matches_reference_helpers(t, k, p):
    logits, u = _inputs(128, seed=0)
    want = np.asarray(jgumbel(jfiltered(jnp.asarray(logits), temperature=t,
                                        top_k=k, top_p=p), jnp.asarray(u)))
    got = fused_sample(torch.from_numpy(logits), temperature=t, top_k=k,
                       top_p=p, u=torch.from_numpy(u)).numpy()
    assert got.dtype == np.int32
    _assert_tokens_match(got, want, _near_ties(logits, u, t, k, p))


@pytest.mark.parametrize("t,k,p", KNOBS)
def test_plain_matches_reference_pallas_interpret(t, k, p):
    logits, u = _inputs(16, seed=1)
    want = np.asarray(fused_sample_fwd(jnp.asarray(logits), jnp.asarray(u),
                                       temperature=t, top_k=k, top_p=p,
                                       interpret=True))
    got = fused_sample(torch.from_numpy(logits), temperature=t, top_k=k,
                       top_p=p, u=torch.from_numpy(u)).numpy()
    _assert_tokens_match(got, want, _near_ties(logits, u, t, k, p))


@pytest.mark.parametrize("k,p", [(5, 1.0), (0, 0.9), (5, 0.9), (1, 0.5),
                                 (40, 0.3)])
def test_kept_sets_match_reference(k, p):
    logits, _ = _inputs(64, seed=2)
    want = np.asarray(jfiltered(jnp.asarray(logits), temperature=0.9,
                                top_k=k, top_p=p)) > JFILTERED * 0.5
    got = filtered_scaled(torch.from_numpy(logits), temperature=0.9,
                          top_k=k, top_p=p).numpy() > FILTERED * 0.5
    np.testing.assert_array_equal(got, want)
    assert got.any(-1).all(), "every row keeps at least one token"
    if k:
        assert (got.sum(-1) <= k).all()


def test_greedy_is_argmax_and_noise_is_drawn_from_the_generator():
    logits, _ = _inputs(8, seed=3)
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(fused_sample(t).numpy(),
                                  logits.argmax(-1))

    def draw(seed):
        return fused_sample(t, temperature=1.0, top_k=10,
                            generator=torch.Generator().manual_seed(seed))

    assert torch.equal(draw(4), draw(4))
    assert draw(4).dtype == torch.int32


def test_bad_knobs_raise_and_cpu_never_launches():
    t = torch.zeros((2, V))
    for kw, msg in (({"temperature": -1.0}, "temperature"),
                    ({"temperature": 1.0, "top_k": -1}, "top_k"),
                    ({"temperature": 1.0, "top_p": 0.0}, "top_p"),
                    ({"temperature": 1.0, "u": torch.rand(2, 3)}, "u must")):
        with pytest.raises(ValueError, match=msg):
            fused_sample(t, **kw)
    with pytest.raises(ValueError, match="logits"):
        fused_sample(t[0])
    before = smod.fused_sample_cuda.launches
    fused_sample(t, temperature=1.0, generator=torch.Generator())
    assert smod.fused_sample_cuda.launches == before
