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

fp32 bit for bit: the port equals a numpy float32 replay of the
reference's ``adam_math`` and per-tensor update, one operation at a time
(numpy's float32 arithmetic and ``sqrt`` are IEEE, as XLA's are), in
every element of params, m and v, so a square root or an operation order
that is not the reference's cannot come back unnoticed.
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


FP32_CASES = [
    dict(lr=1e-3),
    dict(lr=1e-3, weight_decay=0.1),
    dict(lr=1e-3, weight_decay=0.1, adam_w_mode=False),
    dict(lr=lambda c: 1e-3 * 0.5 ** c, betas=(0.8, 0.99), eps=1e-6),
    dict(lr=2e-3, bias_correction=False, weight_decay=0.01),
]
FP32_IDS = ["adam", "adamw", "l2", "schedule", "no_bias_correction"]


@pytest.mark.parametrize("kw", FP32_CASES, ids=FP32_IDS)
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


def _replay(steps=3, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=0.0, adam_w_mode=True, bias_correction=True):
    """The reference's fp32 ``adam_math`` (``apex_tpu/optimizers/
    fused_adam.py:39-54``) and per-tensor update (``_fused.py:124-128``,
    then ``optax.apply_updates``) in numpy float32, one operation at a
    time; Python-float constants rounded to float32 as JAX's weak types
    are."""
    f = np.float32
    b1, b2 = betas
    rng = np.random.default_rng(5)
    p = {k: (rng.standard_normal(s) * 0.05).astype(f) for k, s in
         SHAPES.items()}
    m = {k: np.zeros(s, f) for k, s in SHAPES.items()}
    v = {k: np.zeros(s, f) for k, s in SHAPES.items()}
    for i in range(steps):
        count = i + 1
        step = f(count)
        lr_t = f(lr(count - 1) if callable(lr) else lr)
        for k, g in _grads(i).items():
            if not adam_w_mode and weight_decay:
                g = g + f(weight_decay) * p[k]
            m[k] = f(b1) * m[k] + f(1.0 - b1) * g
            v[k] = f(b2) * v[k] + f(1.0 - b2) * g * g
            if bias_correction:
                m_hat = m[k] / (f(1.0) - f(b1) ** step)
                v_hat = v[k] / (f(1.0) - f(b2) ** step)
            else:
                m_hat, v_hat = m[k], v[k]
            update = m_hat / (np.sqrt(v_hat) + f(eps))
            if adam_w_mode and weight_decay:
                update = update + f(weight_decay) * p[k]
            new_p = p[k] - lr_t * update
            p[k] = p[k] + (new_p - p[k])
    return p, m, v


@pytest.mark.parametrize("kw", FP32_CASES, ids=FP32_IDS)
def test_fused_adam_fp32_bit_identical_to_float32_replay(kw):
    """Every element of params, m and v equal to the replay's, bit for
    bit."""
    _, _, pt, topt = _run(jnp.float32, torch.float32, **kw)
    p, m, v = _replay(**kw)
    for k in SHAPES:
        st = topt.state[pt[k]]
        for name, got, want in (("p", pt[k].detach().numpy(), p[k]),
                                ("m", st["exp_avg"].numpy(), m[k]),
                                ("v", st["exp_avg_sq"].numpy(), v[k])):
            assert got.dtype == want.dtype == np.float32
            differ = int((got.view(np.int32) != want.view(np.int32)).sum())
            assert differ == 0, f"{name}[{k}]: {differ} elements differ"


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
