"""Port parity: apex_tpu_torch's FusedAdam against apex_tpu's ``fused_adam``
plus ``optax.apply_updates`` (``bench.py``'s update), over 3 steps on the
same gradients.

fp32: params, m and v to 1e-6 relative, counts equal, with decoupled and
L2 weight decay, with and without bias correction, constant and scheduled
lr. bf16 params: the update is rounded to bf16 and added in bf16 as the
reference does, so params agree bit for bit (0 of 5168 differ in these
cases). Where the two frameworks' fp32 arithmetic (pow, division) differs
in the last bit, a bf16 rounding could flip, so the test allows at most 1
element in 1000 to differ, by at most one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.optimizers import fused_adam
from apex_tpu_torch.optimizers import FusedAdam

SHAPES = {"w": (64, 48), "b": (48,), "e": (128, 16)}


def _grads(step, seed=0):
    rng = np.random.default_rng(seed + 100 * step)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in
            SHAPES.items()}


def _run(dtype_j, dtype_t, steps=3, **kw):
    rng = np.random.default_rng(5)
    p0 = {k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in
          SHAPES.items()}
    # reference
    opt = fused_adam(**{("learning_rate" if k == "lr" else k): v
                        for k, v in kw.items() if k != "betas"},
                     **({"b1": kw["betas"][0], "b2": kw["betas"][1]}
                        if "betas" in kw else {}))
    pj = {k: jnp.asarray(v).astype(dtype_j) for k, v in p0.items()}
    state = opt.init(pj)
    # port
    pt = {k: torch.tensor(v).to(dtype_t).requires_grad_() for k, v in
          p0.items()}
    topt = FusedAdam([pt[k] for k in sorted(pt)], **kw)
    for i in range(steps):
        g = _grads(i)
        gj = {k: jnp.asarray(v).astype(dtype_j) for k, v in g.items()}
        upd, state = opt.update(gj, state, pj)
        pj = optax.apply_updates(pj, upd)
        for k in pt:
            pt[k].grad = torch.tensor(g[k]).to(dtype_t)
        topt.step()
    return pj, state, pt, topt


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3),
    dict(lr=1e-3, weight_decay=0.1),
    dict(lr=1e-3, weight_decay=0.1, adam_w_mode=False),
    dict(lr=lambda c: 1e-3 * 0.5 ** c, betas=(0.8, 0.99), eps=1e-6),
    dict(lr=2e-3, bias_correction=False, weight_decay=0.01),
], ids=["adam", "adamw", "l2", "schedule", "no_bias_correction"])
def test_fused_adam_fp32_matches_reference(kw):
    pj, state, pt, topt = _run(jnp.float32, torch.float32, **kw)
    assert int(state.count) == 3
    for k in SHAPES:
        st = topt.state[pt[k]]
        assert st["step"] == 3
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(state.buffers["m"][k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(state.buffers["v"][k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("kw", [dict(lr=1e-3), dict(lr=1e-3,
                                                    weight_decay=0.1)],
                         ids=["adam", "adamw"])
def test_fused_adam_bf16_params_match_reference(kw):
    pj, state, pt, topt = _run(jnp.bfloat16, torch.bfloat16, **kw)
    total = differ = 0
    for k in SHAPES:
        a = pt[k].detach().float().numpy()
        e = np.asarray(pj[k].astype(jnp.float32))
        total += a.size
        diff = a != e
        differ += int(diff.sum())
        if diff.any():  # at most one bf16 ulp
            ulp = np.abs(e[diff]) * 2.0 ** -7
            assert (np.abs(a[diff] - e[diff]) <= ulp).all(), k
        np.testing.assert_allclose(topt.state[pt[k]]["exp_avg"].numpy(),
                                   np.asarray(state.buffers["m"][k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    assert differ <= total // 1000, f"{differ} of {total} bf16 params differ"


def test_fused_adam_rejects_chunked_layout():
    """The reference's ``layout`` knob (its chunked mega-buffer) is not a
    FusedAdam argument: the port steps tensor by tensor."""
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(TypeError, match="layout"):
        FusedAdam([p], layout="chunked")
