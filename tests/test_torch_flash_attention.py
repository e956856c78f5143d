"""Port parity: apex_tpu_torch's packed flash attention and
``fused_qkv_attention`` against apex_tpu's, on the same inputs.

The reference runs its Pallas kernels in interpret mode
(``APEX_TPU_PALLAS=interpret``), the way ``tests/test_attention.py`` runs
``fused_qkv_attention``; the port runs its plain version (CPU tensors).
fp32 throughout, matmuls in full fp32 on both sides (TF32 off here,
``jax.default_matmul_precision("highest")`` there). Tolerances are the
reference test's own: 2e-5 on outputs, 3e-4 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import fused_qkv_attention as j_fused
from apex_tpu.ops.pallas import attention as jk
from apex_tpu_torch.ops import attention as amod

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)


def _t(a):
    return torch.tensor(np.asarray(a))


def _block_inputs(b, s, H, h, h_kv, d, seed):
    rng = np.random.default_rng(seed)
    G = h + 2 * h_kv
    x = rng.standard_normal((b, s, H)).astype(np.float32)
    w_qkv = (rng.standard_normal((G * d, H)) * 0.1).astype(np.float32)
    b_qkv = (rng.standard_normal((G * d,)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((H, h * d)) * 0.1).astype(np.float32)
    return x, w_qkv, b_qkv, w_out


@pytest.mark.parametrize("h_kv", [2, 1])
def test_fused_qkv_attention_matches_reference(h_kv, monkeypatch):
    """Output and all four cotangents (dx, dW_qkv, db_qkv, dW_out) at
    b 2, s 128, d 128, h 2: the reference's single-block backward."""
    monkeypatch.setenv("APEX_TPU_PALLAS", "interpret")
    b, s, H, h, d = 2, 128, 64, 2, 128
    scale = 1.0 / d ** 0.5
    arrs = _block_inputs(b, s, H, h, h_kv, d, seed=h_kv)
    cot = np.random.default_rng(7).standard_normal((b, s, H)).astype(
        np.float32)

    def jf(x, w_qkv, b_qkv, w_out):
        return j_fused(x, w_qkv, b_qkv, w_out, None, None, None, h, h_kv, d,
                       scale, True)

    with jax.default_matmul_precision("highest"):
        j_args = [jnp.asarray(a) for a in arrs]
        y_j, vjp = jax.vjp(jf, *j_args)
        g_j = vjp(jnp.asarray(cot))

    t_args = [_t(a).requires_grad_() for a in arrs]
    y_t = amod.fused_qkv_attention(*t_args, h, h_kv, d, scale, True)
    y_t.backward(_t(cot))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL)
    for name, a, e in zip(("dx", "dw_qkv", "db_qkv", "dw_out"), t_args,
                          g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(e),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("h_kv", [2, 1])
def test_packed_kernels_match_two_kernel_backward(h_kv):
    """At s 256 with 128-row blocks the reference runs its dq/dkv kernel
    pair (and a multi-block forward); the port's plain forward and
    backward agree with both."""
    b, s, h, d = 2, 256, 2, 128
    scale = 1.0 / d ** 0.5
    rng = np.random.default_rng(11 + h_kv)
    qkv = rng.standard_normal((b, s, (h + 2 * h_kv) * d)).astype(np.float32)
    do = rng.standard_normal((b, s, h * d)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        o_j, lse_j = jk.flash_fwd_packed(jnp.asarray(qkv), h, h_kv, d,
                                         scale=scale, causal=True, bq=128,
                                         bk=128, interpret=True)
        dq_j, dk_j, dv_j = jk.flash_bwd_packed(
            jnp.asarray(qkv), h, h_kv, d, o_j, lse_j, jnp.asarray(do),
            scale=scale, causal=True, bq=128, bk=128, interpret=True)
    o_t, lse_t = amod.flash_fwd_packed(_t(qkv), h, h_kv, d, scale=scale,
                                       causal=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **OUT_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **OUT_TOL)
    grads = amod.flash_bwd_packed(_t(qkv), _t(o_j), _t(lse_j), _t(do), h,
                                  h_kv, d, scale=scale, causal=True)
    for name, a, e in zip(("dq", "dk", "dv"), grads, (dq_j, dk_j, dv_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), err_msg=name,
                                   **GRAD_TOL)


def test_plain_backward_is_the_forward_gradient():
    """The hand-written plain backward equals autograd through the plain
    forward (fp64 inputs; the plain version computes in fp32), causal and
    not, with a ragged length and a kv group of 3."""
    b, s, h, h_kv, d = 2, 37, 6, 2, 16
    scale = d ** -0.5
    gen = torch.Generator().manual_seed(0)
    for causal in (True, False):
        qkv = torch.randn((b, s, (h + 2 * h_kv) * d), generator=gen,
                          requires_grad=True)
        o, lse = amod.flash_fwd_packed(qkv, h, h_kv, d, scale=scale,
                                       causal=causal)
        do = torch.randn(o.shape, generator=gen)
        (o * do).sum().backward()
        dq, dk, dv = amod.flash_bwd_packed(qkv.detach(), o.detach(), lse, do,
                                           h, h_kv, d, scale=scale,
                                           causal=causal)
        torch.testing.assert_close(torch.cat([dq, dk, dv], -1), qkv.grad,
                                   rtol=1e-5, atol=1e-5)


def test_packed_kernel_gate():
    """What the CUDA flash kernels take: bf16 or fp16, head dim 64 or 128,
    any sequence length (ragged tails are masked in-kernel)."""
    assert amod.packed_kernel_ok(1024, 8, 128, torch.float16)
    assert not amod.packed_kernel_ok(1024, 8, 96, torch.float16)
    assert amod.packed_kernel_ok(1024, 8, 128, torch.bfloat16)
    assert amod.packed_kernel_ok(1000, 8, 64, torch.bfloat16)
    assert amod.packed_kernel_ok(1, 1, 128, torch.bfloat16)
    assert not amod.packed_kernel_ok(1024, 8, 128, torch.float32)
    assert not amod.packed_kernel_ok(1024, 8, 96, torch.bfloat16)
    assert not amod.packed_kernel_ok(0, 8, 128, torch.bfloat16)
    assert not amod.packed_kernel_ok(amod.KERNEL_MAX_SEQ + 1, 8, 128,
                                     torch.bfloat16)


def test_fused_qkv_attention_rejects_mismatched_weights():
    x = torch.zeros((1, 8, 32))
    with pytest.raises(ValueError, match="w_qkv"):
        amod.fused_qkv_attention(x, torch.zeros((3 * 32, 16)), None,
                                 torch.zeros((32, 32)), 2, 2, 16, 0.25)
