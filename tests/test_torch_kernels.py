"""apex_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card (``gpu`` marker; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package, so the machine with the
card runs it without either (and without the JAX-importing conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: fp32 decode attention 1e-4 (fp32 sums in another order); bf16
decode attention 2e-2 (the kernel rounds the unnormalised p to bf16, the
plain version the normalised p: a few bf16 ulps at unit scale). Sampled
tokens must be identical except on rows whose two best perturbed scores
lie within 1e-5 relative (``log``/``exp`` and the top-p sums differ in the
last bits), and at most 1% of rows may be excluded so.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import decode_attention as dmod
from apex_tpu_torch.ops import sampling as smod

NEAR_TIE = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decode_case(h, h_kv, lengths, dev, dtype, d=128, bs=128, nb=8):
    rng = np.random.default_rng(len(lengths) + h_kv)
    b = len(lengths)
    num_blocks = b * nb + 1
    q = rng.standard_normal((b, h, d))
    pk = rng.standard_normal((num_blocks, h_kv, bs, d))
    pv = rng.standard_normal((num_blocks, h_kv, bs, d))
    ids = list(rng.permutation(np.arange(1, num_blocks)))
    tables = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // bs)):
            tables[i, j] = ids.pop()
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (t(q).to(dtype), t(pk).to(dtype), t(pv).to(dtype),
            t(np.asarray(lengths, np.int32)), t(tables))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,h_kv,lengths,d,bs", [
    (8, 8, [0, 1, 127, 128, 129, 300, 512, 1024], 128, 128),
    (8, 2, [5, 300, 0, 512], 128, 128),
    (8, 1, [77, 0, 384, 2], 64, 128),
    (4, 2, [40, 0, 17, 128], 64, 16),
    (16, 1, [300, 0, 5, 1000], 64, 128),
])
def test_paged_decode_kernel_matches_plain(cuda, dtype, tol, h, h_kv,
                                           lengths, d, bs):
    q, pk, pv, lens, tables = _decode_case(h, h_kv, lengths, cuda, dtype,
                                           d=d, bs=bs)
    before = dmod.paged_decode_attn_cuda.launches
    got = dmod.decode_attention(q, pk, pv, lens, block_tables=tables)
    assert dmod.paged_decode_attn_cuda.launches == before + 1
    want = dmod.decode_attention(q, pk, pv, lens, block_tables=tables,
                                 impl="torch")
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert not got[lens == 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,p", [(t, k, p) for t in (0.7, 1.3)
                                   for k in (0, 5, 50) for p in (1.0, 0.9)])
def test_fused_sample_kernel_matches_plain(cuda, dtype, t, k, p):
    g = torch.Generator(device=cuda).manual_seed(5)
    logits = (torch.randn((64, 32768), generator=g, device=cuda)
              * 3.0).to(dtype)
    u = torch.rand(logits.shape, generator=g, device=cuda).clamp_min(
        torch.finfo(torch.float32).tiny)
    before = smod.fused_sample_cuda.launches
    got = smod.fused_sample(logits, temperature=t, top_k=k, top_p=p, u=u)
    assert smod.fused_sample_cuda.launches == before + 1
    want = smod.fused_sample(logits, temperature=t, top_k=k, top_p=p, u=u,
                             impl="torch")
    s = smod.filtered_scaled(logits, temperature=t, top_k=k, top_p=p)
    x = (s - torch.log(-torch.log(u))).double()
    top2 = x.topk(2, dim=-1).values
    ties = (top2[:, 0] - top2[:, 1]).abs() <= NEAR_TIE * top2[:, 0].abs()
    assert ties.float().mean().item() <= 0.01
    assert not ((got != want) & ~ties).any().item()


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q, pk, pv, lens, tables = _decode_case(8, 8, [5], cuda, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dmod.decode_attention(q, pk, pv, lens, block_tables=tables)
    for h, h_kv, bs in ((6, 2, 128), (8, 8, 256)):  # group 3; 256-row block
        q, pk, pv, lens, tables = _decode_case(h, h_kv, [5], cuda,
                                               torch.bfloat16, bs=bs)
        with pytest.raises(ValueError, match="built for"):
            dmod.decode_attention(q, pk, pv, lens, block_tables=tables)
    logits = torch.zeros((2, smod.KERNEL_MAX_VOCAB + 1), device=cuda)
    with pytest.raises(ValueError, match="at most"):
        smod.fused_sample(logits, temperature=1.0)
