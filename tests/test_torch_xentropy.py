"""Port parity: apex_tpu_torch's cross-entropy statistics and the tp=1
vocab-parallel cross-entropy against apex_tpu's, on the same inputs.

The reference's statistics run as its Pallas kernel in interpret mode
(``tests/test_ops.py``'s way); the port runs its plain version (CPU
tensors). fp32: statistics to 1e-6 relative (1e-5 for the sums, taken in
another order), losses and logit gradients to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.xentropy import xent_stats as j_xent_stats
from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    masked_mean as j_masked_mean)
from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as j_vce)
from apex_tpu_torch.ops.xentropy import xent_stats
from apex_tpu_torch.transformer.tensor_parallel import (
    masked_mean, vocab_parallel_cross_entropy)

TOL = dict(rtol=1e-5, atol=1e-5)


def test_xent_stats_matches_reference_kernel():
    rng = np.random.default_rng(0)
    n, v = 24, 256
    logits = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[:6] = [-5, -1, v, v + 100, 0, v - 1]  # outside [0, V) and edges
    want = j_xent_stats(jnp.asarray(logits), jnp.asarray(labels),
                        interpret=True)
    got = xent_stats(torch.tensor(logits), torch.tensor(labels))
    for name, g, w, rtol in zip(("max", "sumexp", "target", "rowsum"), got,
                                want, (1e-6, 1e-5, 1e-6, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-5, err_msg=name)
    assert not got[2][:4].any()  # out-of-range labels give target 0


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_cross_entropy_loss_and_grad_match_reference(label_smoothing, pallas,
                                                     monkeypatch):
    """Loss and d logits against the reference at tp=1, on its kernel
    branch (interpret) and its jnp branch (APEX_TPU_PALLAS=0)."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    rng = np.random.default_rng(1)
    b, s, v = 2, 8, 256
    logits = (rng.standard_normal((b, s, v)) * 2).astype(np.float32)
    target = rng.integers(0, v, (b, s)).astype(np.int32)
    dloss = rng.standard_normal((b, s)).astype(np.float32)

    loss_j, vjp = jax.vjp(
        lambda lg: j_vce(lg, jnp.asarray(target), label_smoothing, None),
        jnp.asarray(logits))
    (grad_j,) = vjp(jnp.asarray(dloss))

    lt = torch.tensor(logits, requires_grad=True)
    loss_t = vocab_parallel_cross_entropy(lt, torch.tensor(target),
                                          label_smoothing=label_smoothing)
    loss_t.backward(torch.tensor(dloss))
    np.testing.assert_allclose(loss_t.detach().numpy(), np.asarray(loss_j),
                               **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(grad_j), **TOL)


def test_cross_entropy_keeps_the_logits_dtype():
    """The gradient is cast to the logits' dtype (bf16 in the train step)
    and the bf16 logits are the residual, not an fp32 copy."""
    lt = torch.randn((4, 64)).bfloat16().requires_grad_()
    loss = vocab_parallel_cross_entropy(lt, torch.arange(4))
    assert loss.dtype == torch.float32
    loss.sum().backward()
    assert lt.grad.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="axis_name"):
        vocab_parallel_cross_entropy(lt, torch.arange(4), axis_name="tp")


@pytest.mark.parametrize("mask", ["none", "some", "zeros"])
def test_masked_mean_matches_reference(mask):
    rng = np.random.default_rng(2)
    losses = rng.standard_normal((3, 5)).astype(np.float32)
    m = {"none": None,
         "some": (rng.random((3, 5)) < 0.5).astype(np.float32),
         "zeros": np.zeros((3, 5), np.float32)}[mask]
    want = j_masked_mean(jnp.asarray(losses),
                         None if m is None else jnp.asarray(m))
    got = masked_mean(torch.tensor(losses),
                      None if m is None else torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if mask == "zeros":
        assert got.item() == 0.0
