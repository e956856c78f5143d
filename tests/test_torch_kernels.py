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

The bf16 rule for the flash-attention kernels: the truth is the plain
version run in fp32 on the same bf16 inputs (upcast); the kernel's max
abs error against it must be at most twice the bf16 plain version's own
error plus 1e-3 (the kernel rounds p against a running max and sums in
another order). ``xent_stats``: fp32 statistics within 1e-5 relative of
the plain version's (sums in another order), target logits exact.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import attention as amod
from apex_tpu_torch.ops import decode_attention as dmod
from apex_tpu_torch.ops import sampling as smod
from apex_tpu_torch.ops import xentropy as xmod

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


def _flash_inputs(b, s, h, h_kv, d, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, (h + 2 * h_kv) * d), generator=g,
                      device=dev).bfloat16()
    do = torch.randn((b, s, h * d), generator=g, device=dev).bfloat16()
    return qkv, do


def _within_rule(got, plain, truth):
    """kernel error <= 2x the bf16 plain version's error + 1e-3"""
    err_k = (got.float() - truth.float()).abs().max().item()
    err_p = (plain.float() - truth.float()).abs().max().item()
    return err_k <= 2 * err_p + 1e-3, (err_k, err_p)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [128, 1000, 1024])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_flash_kernels_match_plain(cuda, s, d, group):
    b, h = 2, 8
    h_kv = h // group
    scale = d ** -0.5
    qkv, do = _flash_inputs(b, s, h, h_kv, d, cuda, seed=s + d + group)
    kw = dict(scale=scale, causal=True)
    before = (amod.flash_fwd_cuda.launches, amod.flash_bwd_dkv_cuda.launches,
              amod.flash_bwd_dq_cuda.launches)
    o, lse = amod.flash_fwd_packed(qkv, h, h_kv, d, **kw)
    o_p, lse_p = amod.flash_fwd_packed(qkv, h, h_kv, d, impl="torch", **kw)
    o_t, lse_t = amod.flash_fwd_packed(qkv.float(), h, h_kv, d, **kw,
                                       impl="torch")
    ok, errs = _within_rule(o, o_p, o_t)
    assert ok, f"flash fwd o: kernel/plain errors {errs}"
    ok, errs = _within_rule(lse, lse_p, lse_t)
    assert ok, f"flash fwd lse: kernel/plain errors {errs}"
    # the backward on one set of inputs: the plain forward's o and lse
    grads = amod.flash_bwd_packed(qkv, o_p, lse_p, do, h, h_kv, d, **kw)
    plain = amod.flash_bwd_packed(qkv, o_p, lse_p, do, h, h_kv, d,
                                  impl="torch", **kw)
    truth = amod.flash_bwd_packed(qkv.float(), o_p.float(), lse_p,
                                  do.float(), h, h_kv, d, impl="torch", **kw)
    torch.cuda.synchronize()
    assert (amod.flash_fwd_cuda.launches, amod.flash_bwd_dkv_cuda.launches,
            amod.flash_bwd_dq_cuda.launches) == tuple(n + 1 for n in before)
    for name, got, p, t in zip(("dq", "dk", "dv"), grads, plain, truth):
        assert torch.isfinite(got.float()).all()
        ok, errs = _within_rule(got, p, t)
        assert ok, f"flash bwd {name}: kernel/plain errors {errs}"


@pytest.mark.gpu
@pytest.mark.parametrize("s,causal", [(200, False), (1, True), (77, True),
                                      (77, False)])
def test_flash_kernels_short_and_non_causal(cuda, s, causal):
    b, h, h_kv, d = 2, 4, 2, 128
    qkv, do = _flash_inputs(b, s, h, h_kv, d, cuda, seed=9 + s)
    kw = dict(scale=d ** -0.5, causal=causal)
    o, lse = amod.flash_fwd_packed(qkv, h, h_kv, d, **kw)
    o_p, lse_p = amod.flash_fwd_packed(qkv, h, h_kv, d, impl="torch", **kw)
    o_t, lse_t = amod.flash_fwd_packed(qkv.float(), h, h_kv, d,
                                       impl="torch", **kw)
    assert _within_rule(o, o_p, o_t)[0]
    assert _within_rule(lse, lse_p, lse_t)[0]
    grads = amod.flash_bwd_packed(qkv, o_p, lse_p, do, h, h_kv, d, **kw)
    plain = amod.flash_bwd_packed(qkv, o_p, lse_p, do, h, h_kv, d,
                                  impl="torch", **kw)
    truth = amod.flash_bwd_packed(qkv.float(), o_p.float(), lse_p,
                                  do.float(), h, h_kv, d, impl="torch", **kw)
    for got, p, t in zip(grads, plain, truth):
        assert _within_rule(got, p, t)[0]


@pytest.mark.gpu
def test_train_step_kernel_path_matches_plain_path(cuda):
    """A small bf16 GPT's loss and gradients through the kernels against
    the plain versions on the same weights: loss within 1e-4 relative,
    each gradient leaf within 5e-2 relative norm (chip_smoke.py's bounds
    at full width). The k window of the qkv bias is left out: its exact
    gradient is 0, so both paths hold only rounding noise there."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, param_leaves

    cfg = GPTConfig(vocab_size=512, max_seq_len=256, hidden_size=256,
                    num_layers=2, num_heads=2, remat=False,
                    dtype=torch.bfloat16)
    model = GPTModel(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens, targets = (torch.randint(0, 512, (4, 256), generator=g,
                                     device=cuda) for _ in range(2))
    hd = cfg.num_heads * cfg.head_dim
    k_window = [t for t in leaves if t.shape == (cfg.qkv_features,)]
    out = []
    for impl in ("auto", "torch"):
        loss = model.loss_fn(params, tokens, targets, impl=impl)
        loss.backward()
        grads = []
        for t in leaves:
            gr = t.grad.float()
            if any(t is w for w in k_window):
                gr = torch.cat([gr[:hd], gr[2 * hd:]])
            grads.append(gr)
            t.grad = None
        out.append((loss.item(), grads))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        assert (a - b).norm() <= 5e-2 * b.norm()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
def test_xent_stats_kernel_matches_plain(cuda, dtype, label_dtype):
    n, V = 96, 32768
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn((n, V), generator=g, device=cuda) * 4.0).to(dtype)
    labels = torch.randint(0, V, (n,), generator=g, device=cuda)
    labels[::7] = -1
    labels[3::11] = V + 5
    labels = labels.to(label_dtype)
    before = xmod.xent_stats_cuda.launches
    got = xmod.xent_stats(x, labels)
    assert xmod.xent_stats_cuda.launches == before + 1
    want = xmod.xent_stats(x, labels, impl="torch")
    torch.cuda.synchronize()
    for name, a, w in zip(("max", "sumexp", "target", "rowsum"), got, want):
        tol = 1e-5 * (w.abs().max().item() + 1.0)
        if name == "rowsum":  # V terms summed in another order
            tol = 1e-5 * x.float().abs().sum(-1).max().item()
        assert (a - w).abs().max().item() <= tol, name
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])


@pytest.mark.gpu
def test_train_kernels_refuse_what_they_do_not_take(cuda):
    qkv, _ = _flash_inputs(1, 64, 2, 2, 128, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        amod.flash_fwd_packed(qkv.float(), 2, 2, 128, scale=1.0, causal=True)
    bad = torch.zeros((1, 64, 4 * 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        amod.flash_fwd_packed(bad, 2, 1, 96, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="h_kv"):
        amod.flash_fwd_packed(qkv, 3, 2, 128, scale=1.0, causal=True)
    o, lse = amod.flash_fwd_packed(qkv, 2, 2, 128, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="lse"):
        amod.flash_bwd_packed(qkv, o, lse[:, :1], o, 2, 2, 128, scale=1.0,
                              causal=True)
    x = torch.zeros((4, 100), dtype=torch.bfloat16, device=cuda)
    lab = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        xmod.xent_stats(x, lab)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        xmod.xent_stats(x[:, :96].half(), lab)
