"""apex_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card (``gpu`` marker; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package, so the machine with the
card runs it without either (and without the JAX-importing conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: fp32 decode attention 1e-4 (fp32 sums in another order); bf16
decode attention 2e-2 (the kernel rounds the unnormalised p to bf16, the
plain version the normalised p: a few bf16 ulps at unit scale). The paged
kernel's int8 and fp8 instances: within one bf16 ulp (2^-8 relative, plus
1e-5) of their fp32 function, and within the reference-order plain
version's own distance from that function plus one bf16 ulp of its
largest output (that version rounds the dequantized cells and p to bf16);
every scale at 1 refused. The decode kernels' bias instances (a seeded
causal table of 32 buckets): the bf16 tolerance against the plain version
with the bias; a zero table refused. The decode
kernels split a row's walk over a cluster of S CTAs: each S the plan picks
(1, 2, 4, 8) is checked at shapes that make it pick it, in both dtypes,
MHA and GQA, with the card's room for the plan's clusters, the output
bit-identical across two runs, length-0 rows zeros and one launch counted
a call; the kernel given lengths one block short must fail the bf16
tolerance against the plain version on the full lengths. Sampled
tokens must be identical except on rows whose two best perturbed scores
lie within 1e-5 relative (``log``/``exp`` and the top-p sums differ in the
last bits), and at most 1% of rows may be excluded so; the sampler splits
each row over a cluster of S CTAs: each S its plan reaches (8, 2, 1) with
every knob set, tokens bit-identical across two runs, one launch a call,
and two planted faults (the last rank left out of the merges, top-k run
with k + 1) must give mismatches. The layer-norm forward runs on every
planned shape (a row over each W warps; few rows, and many with the next
rows in flight) with y, mean and rstd bit-identical across two runs.

The bf16 rule for the flash-attention kernels: the truth is the plain
version run in fp32 on the same bf16 inputs (upcast); the kernel's max
abs error against it must be at most twice the bf16 plain version's own
error plus 1e-3 (the kernel rounds p against a running max and sums in
another order). ``xent_stats``: fp32 statistics within 1e-5 relative of
the plain version's (sums in another order), target logits exact.

The decode engine's kernels: the bshd flash forward under the same bf16
rule, and bit-identical to the packed kernel on views of one packed
buffer; the contiguous decode kernel at the paged kernel's tolerances;
the verify kernels' verdicts equal to the plain version's exactly in
greedy mode, and in sampled mode except on a batch row with a near-tie
(two best perturbed scores of a row, or an acceptance draw and its
probability, within 1e-5 relative), at most 1% of rows; each verify row
over a cluster of S CTAs: each S the plan takes (8, 4, 2, 1) in both
dtypes, with the card's room for the plan's clusters and its shared
memory, verdicts bit-identical across two runs, launches back to back on
one workspace each right (the counters reset), and two planted faults
(the last rank left out of the merges, row 0's slots never published)
refused at every batch row.

The bshd backward (BERT's padded train step) and the array bias of both
layouts: dq, dk, dv, o and lse under the same bf16 rule; dbias within
1e-3 relative norm of the plain version run in fp32 (the truth).

The flash backward pair's two variants (``wgmma``, the path's; ``sm80``,
the first mma.sync pair) at each family's call, the batch cut: dq, dk
and dv under the bf16 rule, the bucket-table gradient within 1e-3
relative norm of the fp32 truth; two planted faults (the last 64-row kv
tile dropped, the bias left out) must fail those rules on both
variants; dq, dk and dv on ``wgmma`` bit-identical across two runs. The
forward's two variants likewise at each family's call (o and lse under
the bf16 rule, the same two faults refused, ``wgmma`` bit-identical), and
dbias's at each dbias call (within 1e-3 relative norm of the fp32 truth;
the last group of sharing rows dropped and the bias left out refused on
both variants; ``wgmma``'s split sums bit-identical across two runs).

The layer-norm and softmax kernels: in bf16, y, dx and the softmax's
probabilities and dx under the same bf16 rule against the plain version
run in fp32 on the upcast inputs; mean and rstd within 1e-5 of the
truth's largest entry; dgamma and dbeta within 1e-5 of the largest entry
with fp32 parameters and within one bf16 ulp of it (2^-7) with bf16
ones (fp32 sums in another order, then one rounding). In fp32 every
output within 1e-5 of the plain version's largest entry. dgamma and dbeta
bit-identical across two runs on the same input. The wide norm kernels
(hidden 4097 to 65536) by the same rules, fp16 x by the fp16 rule with
dgamma and dbeta within 2^-10 of the largest entry, every output
bit-identical across two runs, and two planted faults (the row's last
16-byte chunk left out of the statistics, the last rank's partial not
merged) moving rstd and dx past 1e-5 on fp32 rows with a large tail. The softmax backward,
told the forward's mask, is also run with NaN in dy at the masked
entries of rows with a live entry: its dx finite, 0 there, the same bits
as on clean dy and across two runs; fully masked rows and a row whose
masked y is not 0 (live scores 16 above the fill) read whole; two
planted faults (those rows' dx zeroed, the masked entries' dy * y
counted) refused by the rule.

The matmul_bias_act kernel: in bf16, max abs error against the plain
version run in fp32 on the upcast inputs at most twice the bf16 plain
version's plus 1e-3 of the truth's largest entry (the scaled bf16 rule:
wgrad outputs summed over many rows sit far from unit scale; fp32 sums in
another order, then one rounding); two planted faults (the last 32-deep
K block dropped, the bias left out) must fail that rule, on both bf16
variants (wgmma, sm80) through the private launcher; a split-K result
bit-identical across two runs. In fp32 (exact
FFMA, no TF32) within 1e-5 of the plain version's largest entry. The
fused-dense and MLP autograd paths: outputs and every gradient within
2e-2 of the plain path's largest entry in bf16 (one rounding of each
intermediate on either side).

The batch-norm kernels (``csrc/batch_norm.cu``) against the plain
version run in fp32 on the upcast inputs (the truth): y, dx and
dresidual by the norm rule (bf16: twice the bf16 plain version's max abs
error + 1e-3; fp16: twice the fp16 plain version's + 2^-13 × max(1, the
largest); fp32: 1e-5 of the largest), the backward given the kernel's own
y for the ReLU's mask; mean and rstd within 1e-5 of the largest; dscale and
dbias within 2^-7 (bf16 parameters), 2^-10 (fp16) or 1e-5 (fp32) of the
largest; y, the statistics and every gradient bit-identical across two
runs; two planted faults (the last row chunk out of the statistics; dx
without its x̂ term) refused.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import attention as amod
from apex_tpu_torch.ops import batch_norm as bnmod
from apex_tpu_torch.ops import decode_attention as dmod
from apex_tpu_torch.ops import fused_verify as vmod
from apex_tpu_torch.ops import layer_norm as lnmod
from apex_tpu_torch.ops import matmul as mmmod
from apex_tpu_torch.ops import sampling as smod
from apex_tpu_torch.ops import softmax as smxmod
from apex_tpu_torch.ops import xentropy as xmod
from apex_tpu_torch.ops.fused_dense import fused_dense, fused_dense_gelu_dense
from apex_tpu_torch.ops.mlp import mlp

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


# --- the sampler: each row over a cluster of S CTAs ---------------------------

def _sample_case(b, V, dev, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + b + V)
    logits = (torch.randn((b, V), generator=g, device=dev) * 3.0).to(dtype)
    u = torch.rand((b, V), generator=g, device=dev).clamp_min(
        torch.finfo(torch.float32).tiny)
    return logits, u


def _sample_mismatches(got, logits, u, t, k, p):
    """Rows whose token differs from the plain version's outside a
    near-tie (module docstring), and the near-tie rows."""
    want = smod.fused_sample(logits, temperature=t, top_k=k, top_p=p, u=u,
                             impl="torch")
    s = smod.filtered_scaled(logits, temperature=t, top_k=k, top_p=p)
    x = (s - torch.log(-torch.log(u))).double()
    top2 = x.topk(2, dim=-1).values
    ties = (top2[:, 0] - top2[:, 1]).abs() <= NEAR_TIE * top2[:, 0].abs()
    return int(((got != want) & ~ties).sum()), int(ties.sum())


# (b, V) at each split the plan reaches: S 8 (b 1, 8; V 30592 and 1000
# too), S 2 (b 64, 256), S 1 (b 256, V 1000)
SAMPLE_CASES = [(1, 32768), (8, 32768), (64, 32768), (256, 32768),
                (8, 30592), (64, 30592), (8, 1000), (256, 1000)]
SAMPLE_KNOBS = [(0.8, 0, 1.0), (0.8, 50, 1.0), (0.8, 0, 0.9),
                (0.8, 50, 0.9), (1.3, 1, 1.0), (0.7, "V", 0.5)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,V", SAMPLE_CASES)
def test_fused_sample_every_split_matches_plain(cuda, dtype, b, V):
    """Each knob set at the plan's split: no token mismatch outside
    near-ties (at most 1% of rows excluded), tokens bit-identical across
    two runs, one launch a call, and room on the card for the plan's
    clusters."""
    from apex_tpu_torch.ops.matmul import _sm_count

    plan = smod._sample_plan(b, V, _sm_count(torch.cuda.current_device()))
    assert smod.max_active_clusters(plan, dtype, V) > 0
    logits, u = _sample_case(b, V, cuda, dtype)
    bad = ties = 0
    for t, k, p in SAMPLE_KNOBS:
        k = V if k == "V" else k
        before = smod.fused_sample_cuda.launches
        got = smod.fused_sample(logits, temperature=t, top_k=k, top_p=p,
                                u=u)
        again = smod.fused_sample(logits, temperature=t, top_k=k, top_p=p,
                                  u=u)
        assert smod.fused_sample_cuda.launches == before + 2
        assert torch.equal(got, again), (t, k, p)
        n_bad, n_ties = _sample_mismatches(got, logits, u, t, k, p)
        bad += n_bad
        ties += n_ties
    assert bad == 0
    assert ties <= 0.01 * b * len(SAMPLE_KNOBS)


@pytest.mark.gpu
@pytest.mark.parametrize("b,V", [(16, 32768), (64, 32768)])
@pytest.mark.parametrize("fault,t,k,p", [("drop_last_rank", 0.8, 50, 0.9),
                                         ("top_k_plus_one", 1.3, 1, 1.0)])
def test_fused_sample_planted_faults_fail_the_check(cuda, b, V, fault, t, k,
                                                    p):
    """The last rank's share left out of every merge, and top-k run with
    k + 1, must give token mismatches outside near-ties."""
    logits, u = _sample_case(b, V, cuda, seed=3)
    got = smod.fused_sample_cuda(logits, u, temperature=t, top_k=k,
                                 top_p=p, planted_fault=fault)
    assert _sample_mismatches(got, logits, u, t, k, p)[0] > 0
    sound = smod.fused_sample_cuda(logits, u, temperature=t, top_k=k,
                                   top_p=p)
    assert _sample_mismatches(sound, logits, u, t, k, p)[0] == 0


@pytest.mark.gpu
def test_fused_sample_refuses_what_it_does_not_take(cuda):
    logits, u = _sample_case(2, 1024, cuda)
    with pytest.raises(ValueError, match="planted fault"):
        smod.fused_sample_cuda(logits, u, temperature=1.0, top_k=0,
                               top_p=1.0, planted_fault="other")
    with pytest.raises(ValueError, match="top_k"):
        smod.fused_sample_cuda(logits, u, temperature=1.0, top_k=1025,
                               top_p=1.0)
    with pytest.raises(ValueError, match="float32 noise"):
        smod.fused_sample_cuda(logits, u.double(), temperature=1.0,
                               top_k=0, top_p=1.0)


# --- the split decode kernels: one cluster of S CTAs a row -----------------

def _split_lengths(b, nb, bs):
    """Ragged lengths cycling through the full table, a block edge and its
    neighbours, 1, 0, a middle length and one past the table."""
    full = nb * bs
    cycle = [full, bs + 1, 1, 0, bs, bs - 1, full // 2 + 3, full + 100]
    return [cycle[i % len(cycle)] for i in range(b)]


def _split_paged_case(b, h, h_kv, nb, dev, dtype, seed, d=128, bs=128):
    """q, (num_blocks, h_kv, bs, d) pools with each slot's live blocks at
    permuted ids (unused entries the dead block 0), tables, lengths."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = _split_lengths(b, nb, bs)
    nblocks = b * nb + 1
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    pk = torch.randn((nblocks, h_kv, bs, d), generator=g,
                     device=dev).to(dtype)
    pv = torch.randn((nblocks, h_kv, bs, d), generator=g,
                     device=dev).to(dtype)
    ids = list(np.random.default_rng(seed).permutation(
        np.arange(1, nblocks)))
    tables = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lengths):
        for j in range(min(-(-n // bs), nb)):
            tables[i, j] = ids.pop()
    return (q, pk, pv, torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(tables, device=dev))


# (b, h, h_kv, nb, the split the plan must pick at 132 SMs): the serve
# leg's 64 rows, 32 rows, the spec leg's 16 and fewer, the decode leg's
# 128 and one block
SPLIT_CASES = [
    pytest.param(8, 8, 8, 8, 2, id="serve-S2"),
    pytest.param(32, 8, 2, 8, 2, id="gqa-S2"),
    pytest.param(4, 8, 8, 8, 4, id="S4"),
    pytest.param(16, 8, 2, 8, 4, id="gqa-S4"),
    pytest.param(2, 8, 8, 8, 8, id="S8"),
    pytest.param(8, 8, 2, 8, 8, id="gqa-S8"),
    pytest.param(16, 8, 8, 8, 1, id="decode-S1"),
    pytest.param(8, 8, 8, 1, 1, id="S1-one-block"),
]


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,h_kv,nb,splits", SPLIT_CASES)
def test_paged_decode_split_matches_plain(cuda, dtype, tol, b, h, h_kv, nb,
                                          splits):
    q, pk, pv, lens, tables = _split_paged_case(b, h, h_kv, nb, cuda, dtype,
                                                seed=b + nb)
    qg = q.reshape(b * h_kv, h // h_kv, 128)
    plan = dmod._plan_for(qg, nb, 128)
    assert plan.splits == splits
    assert dmod.max_active_clusters(plan, dtype, 128, h // h_kv, 128,
                                    paged=True) >= 1
    before = dmod.paged_decode_attn_cuda.launches
    got = dmod.decode_attention(q, pk, pv, lens, block_tables=tables)
    assert dmod.paged_decode_attn_cuda.launches == before + 1
    again = dmod.decode_attention(q, pk, pv, lens, block_tables=tables)
    want = dmod.decode_attention(q, pk, pv, lens, block_tables=tables,
                                 impl="torch")
    torch.cuda.synchronize()
    assert _max_err(got, want) <= tol
    assert torch.equal(got, again), "not bit-identical across two runs"
    assert not got[lens == 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,h_kv,nb,splits", SPLIT_CASES)
def test_contiguous_decode_split_matches_plain(cuda, dtype, tol, b, h, h_kv,
                                               nb, splits):
    g = torch.Generator(device=cuda).manual_seed(b + nb)
    max_s, d = nb * 128, 128
    q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, h_kv, max_s, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, h_kv, max_s, d), generator=g, device=cuda).to(dtype)
    lens = torch.tensor(_split_lengths(b, nb, 128), dtype=torch.int32,
                        device=cuda)
    plan = dmod._plan_for(q.reshape(b * h_kv, h // h_kv, d), nb, 128)
    assert plan.splits == splits
    assert dmod.max_active_clusters(plan, dtype, d, h // h_kv, 128,
                                    paged=False) >= 1
    before = dmod.decode_attn_cuda.launches
    got = dmod.decode_attention(q, k, v, lens)
    assert dmod.decode_attn_cuda.launches == before + 1
    again = dmod.decode_attention(q, k, v, lens)
    want = dmod.decode_attention(q, k, v, lens, impl="torch")
    torch.cuda.synchronize()
    assert _max_err(got, want) <= tol
    assert torch.equal(got, again), "not bit-identical across two runs"
    assert not got[lens == 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_contiguous_decode_kernel_takes_batch_lengths(cuda, dtype, tol):
    """decode_attn_cuda with (b,) lengths at GQA (2 kv heads): each batch
    row at its own length, read by both of its kv heads' rows."""
    g = torch.Generator(device=cuda).manual_seed(7)
    b, h_kv, group, max_s, d = 6, 2, 4, 512, 128
    q = torch.randn((b * h_kv, group, d), generator=g,
                    device=cuda).to(dtype)
    k = torch.randn((b * h_kv, max_s, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b * h_kv, max_s, d), generator=g, device=cuda).to(dtype)
    lens = torch.tensor([3, 0, 128, 129, 511, 512], dtype=torch.int32,
                        device=cuda)
    got = dmod.decode_attn_cuda(q, k, v, lens, scale=d ** -0.5)
    want = dmod._torch_decode(q.reshape(b, h_kv, group, d),
                              k.reshape(b, h_kv, max_s, d),
                              v.reshape(b, h_kv, max_s, d), lens,
                              d ** -0.5).reshape(b * h_kv, group, d)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= tol
    assert not got.reshape(b, h_kv, group, d)[1].any()


def _quant_case(b, h, h_kv, nb, dev, kv, seed, d=128, bs=128):
    """The split case's q, tables and lengths with its pools quantized
    row by row as the serving engine writes them (``_quant_rows``):
    (q, k cells, v cells, lengths, tables, k_scale, v_scale)."""
    from apex_tpu_torch.serving.engine import KV_QUANT_SPECS, _quant_rows

    q, pk, pv, lens, tables = _split_paged_case(b, h, h_kv, nb, dev,
                                                torch.bfloat16, seed, d=d,
                                                bs=bs)
    qmax, qdtype = KV_QUANT_SPECS[kv]
    out = []
    for pool in (pk, pv):
        cells, scales = _quant_rows(pool.float().transpose(1, 2) * 3.0,
                                    (2, 3), qmax=qmax, qdtype=qdtype)
        out += [cells.transpose(1, 2).contiguous(), scales.contiguous()]
    return q, out[0], out[2], lens, tables, out[1], out[3]


def _one_bf16_ulp(got, want32):
    """got (bf16) within one bf16 ulp of the fp32 function (2^-8
    relative) plus 1e-5: the bf16 output rounding of fp32 sums taken in
    another order."""
    return bool(((got.float() - want32).abs()
                 <= 2.0 ** -8 * want32.abs() + 1e-5).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("b,h,h_kv,nb,splits", SPLIT_CASES)
def test_quant_decode_matches_fp32_function(cuda, kv, d, b, h, h_kv, nb,
                                            splits):
    """The int8 and fp8 instances at every split: within one bf16 ulp of
    their fp32 function (:func:`quant_decode_fp32`), within the
    reference-order plain version's (cells and p rounded to bf16) own
    distance from that function plus one bf16 ulp, bit-identical across
    two runs, one launch counted by its format, and every scale at 1
    refused."""
    q, kc, vc, lens, tables, ks, vs = _quant_case(b, h, h_kv, nb, cuda, kv,
                                                  seed=b + nb + d, d=d)
    qg = q.reshape(b * h_kv, h // h_kv, d)
    plan = dmod._plan_for(qg, nb, 128, kc.dtype)
    assert plan.splits == splits
    assert dmod.max_active_clusters(plan, torch.bfloat16, d, h // h_kv, 128,
                                    True, kc.dtype) >= 1
    counter = "int8_launches" if kv == "int8" else "fp8_launches"
    before = getattr(dmod.paged_decode_attn_cuda, counter)
    kw = dict(block_tables=tables, k_scale=ks, v_scale=vs)
    got = dmod.decode_attention(q, kc, vc, lens, **kw)
    assert getattr(dmod.paged_decode_attn_cuda, counter) == before + 1
    again = dmod.decode_attention(q, kc, vc, lens, **kw)
    want32 = dmod.quant_decode_fp32(q.float(), kc, vc, lens, tables, ks, vs)
    plain = dmod.decode_attention(q, kc, vc, lens, impl="torch", **kw)
    bad = dmod.paged_decode_attn_cuda(
        qg, kc, vc, lens, tables, scale=d ** -0.5, k_scale=ks, v_scale=vs,
        planted_fault="unit_scales").reshape(b, h, d)
    torch.cuda.synchronize()
    # the reference-order plain version rounds the dequantized cells and p
    # to bf16: the kernel lies within that version's own distance from the
    # fp32 function plus one bf16 ulp of the largest output
    gap = _max_err(plain, want32) + 2.0 ** -8 * want32.abs().max().item()
    assert _one_bf16_ulp(got, want32), _max_err(got, want32)
    assert _max_err(got, plain) <= gap
    assert torch.equal(got, again), "not bit-identical across two runs"
    assert not got[lens == 0].any()
    assert not _one_bf16_ulp(bad, want32) and _max_err(bad, plain) > gap


@pytest.mark.gpu
def test_quant_decode_refuses_what_it_does_not_take(cuda):
    q, kc, vc, lens, tables, ks, vs = _quant_case(8, 8, 8, 8, cuda, "int8",
                                                  seed=1)
    qg = q.reshape(64, 1, 128)
    kw = dict(scale=0.1, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="bfloat16 q"):
        dmod.paged_decode_attn_cuda(qg.float(), kc, vc, lens, tables, **kw)
    with pytest.raises(ValueError, match="multiple of 4"):
        dmod.paged_decode_attn_cuda(qg, kc[:, :, :126], vc[:, :, :126], lens,
                                    tables, scale=0.1,
                                    k_scale=ks[:, :126].contiguous(),
                                    v_scale=vs[:, :126].contiguous())
    with pytest.raises(ValueError, match="no bias"):
        dmod.paged_decode_attn_cuda(qg, kc, vc, lens, tables, **kw,
                                    rel_bias=_table_bias(8, True, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("b,h,h_kv,nb,splits", SPLIT_CASES)
def test_rel_decode_matches_plain(cuda, paged, b, h, h_kv, nb, splits):
    """The bias instances of both entries at every split (bf16, a seeded
    causal table of 32 buckets, max distance 128): within the bf16 decode
    tolerance of the plain version with the bias, bit-identical across
    two runs, one launch counted in ``.rel_launches``; a zero table fails
    the tolerance against the biased plain version."""
    q, pk, pv, lens, tables = _split_paged_case(b, h, h_kv, nb, cuda,
                                                torch.bfloat16, seed=b + nb)
    bias = _table_bias(h, True, cuda)
    bias.table.mul_(4.0)  # visible against the unit-scale scores
    if paged:
        kw, fn = dict(block_tables=tables), dmod.paged_decode_attn_cuda
    else:  # the same rows laid out as each slot's contiguous cache
        pk, pv = (dmod._gather_blocks(p_, tables).contiguous()
                  for p_ in (pk, pv))
        kw, fn = {}, dmod.decode_attn_cuda
    plan = dmod._plan_for(q.reshape(b * h_kv, h // h_kv, 128), nb, 128,
                          None, 128)
    assert plan.splits == splits
    assert dmod.max_active_clusters(plan, torch.bfloat16, 128, h // h_kv,
                                    128, paged, None, 128) >= 1
    before = fn.rel_launches
    got = dmod.decode_attention(q, pk, pv, lens, bias=bias, **kw)
    assert fn.rel_launches == before + 1
    again = dmod.decode_attention(q, pk, pv, lens, bias=bias, **kw)
    want = dmod.decode_attention(q, pk, pv, lens, bias=bias, impl="torch",
                                 **kw)
    zero = dmod.decode_attention(
        q, pk, pv, lens, bias=amod.BucketedBias(
            torch.zeros_like(bias.table), max_distance=128), **kw)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 2e-2
    assert torch.equal(got, again), "not bit-identical across two runs"
    assert not got[lens == 0].any()
    assert _max_err(zero, want) > 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("b,h,h_kv,nb,splits", SPLIT_CASES[:7])
def test_decode_split_planted_fault_fails_the_rule(cuda, paged, b, h, h_kv,
                                                   nb, splits):
    """The kernel given lengths one block short, the plain version the
    full lengths: a lost split's block must fail the bf16 tolerance."""
    q, pk, pv, lens, tables = _split_paged_case(b, h, h_kv, nb, cuda,
                                                torch.bfloat16, seed=b + 3)
    short = (lens - 128).clamp_min(0)
    hit = (lens > 128) & (lens < nb * 128 + 100)
    if paged:
        got = dmod.decode_attention(q, pk, pv, short, block_tables=tables)
        want = dmod.decode_attention(q, pk, pv, lens, block_tables=tables,
                                     impl="torch")
    else:
        k = dmod._gather_blocks(pk, tables)
        v = dmod._gather_blocks(pv, tables)
        got = dmod.decode_attention(q, k, v, short)
        want = dmod.decode_attention(q, k, v, lens, impl="torch")
    torch.cuda.synchronize()
    assert _max_err(got[hit], want[hit]) > 2e-2


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
                    dtype=torch.bfloat16, attention_impl="flash")
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
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        amod.flash_fwd_packed(qkv.float(), 2, 2, 128, scale=1.0, causal=True)
    # fp16: the packed entry's wgmma kernels without dropout only
    half = qkv.half()
    with pytest.raises(ValueError, match="sm80"):
        amod.flash_fwd_cuda(half, 2, 2, 128, scale=1.0, causal=True,
                            variant="sm80")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        amod.flash_fwd_cuda(half, 2, 2, 128, scale=1.0, causal=True,
                            dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(ValueError, match="fp16 instances plant"):
        amod.flash_fwd_cuda(half, 2, 2, 128, scale=1.0, causal=True,
                            planted_fault="drop_last_kv_tile")
    q4 = half[..., :256].unflatten(-1, (2, 128))
    with pytest.raises(ValueError, match="ROADMAP queue 2"):
        amod.flash_attention(q4, q4, q4, causal=True, layout="bshd")
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
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        xmod.xent_stats(x[:, :96].double(), lab)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,h_kv,d,causal", [
    (2, 512, 512, 8, 8, 128, True),
    (4, 300, 300, 8, 2, 128, True),
    (2, 77, 200, 4, 1, 64, True),
    (2, 200, 77, 4, 2, 128, False),
])
def test_flash_bshd_kernel_matches_plain(cuda, b, sq, sk, h, h_kv, d,
                                         causal):
    g = torch.Generator(device=cuda).manual_seed(sq + sk + h_kv)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    k = torch.randn((b, sk, h_kv, d), generator=g, device=cuda).bfloat16()
    v = torch.randn((b, sk, h_kv, d), generator=g, device=cuda).bfloat16()
    kw = dict(scale=d ** -0.5, causal=causal)
    before = amod.flash_fwd_bshd_cuda.launches
    o, lse = amod.flash_fwd_bshd(q, k, v, **kw)
    assert amod.flash_fwd_bshd_cuda.launches == before + 1
    o_p, lse_p = amod.flash_fwd_bshd(q, k, v, impl="torch", **kw)
    o_t, lse_t = amod.flash_fwd_bshd(q.float(), k.float(), v.float(),
                                     impl="torch", **kw)
    torch.cuda.synchronize()
    ok, errs = _within_rule(o, o_p, o_t)
    assert ok, f"bshd o: kernel/plain errors {errs}"
    ok, errs = _within_rule(lse, lse_p, lse_t)
    assert ok, f"bshd lse: kernel/plain errors {errs}"


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,h_kv,d", [(512, 8, 8, 128), (300, 8, 2, 64)])
def test_flash_bshd_on_packed_views_equals_packed_kernel(cuda, s, h, h_kv,
                                                         d):
    """The prefill hands the kernel views of the packed projection: the
    bshd entry must give the packed entry's results bit for bit."""
    qkv, _ = _flash_inputs(2, s, h, h_kv, d, cuda, seed=s)
    b = qkv.shape[0]
    q = qkv[..., :h * d].reshape(b, s, h, d)
    k = qkv[..., h * d:(h + h_kv) * d].reshape(b, s, h_kv, d)
    v = qkv[..., (h + h_kv) * d:].reshape(b, s, h_kv, d)
    kw = dict(scale=d ** -0.5, causal=True)
    o_p, lse_p = amod.flash_fwd_cuda(qkv, h, h_kv, d, **kw)
    o_b, lse_b = amod.flash_fwd_bshd_cuda(q, k, v, **kw)
    o_c, lse_c = amod.flash_fwd_bshd_cuda(q.contiguous(), k.contiguous(),
                                          v.contiguous(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(o_b.reshape(o_p.shape), o_p)
    assert torch.equal(lse_b, lse_p)
    assert torch.equal(o_c, o_b) and torch.equal(lse_c, lse_b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,h_kv,lengths,d,max_s", [
    (8, 8, [0, 1, 127, 128, 129, 640, 1000, 1024], 128, 1024),
    (8, 2, [5, 300, 0, 512], 128, 512),
    (16, 1, [300, 0, 5, 256], 64, 256),
])
def test_contiguous_decode_kernel_matches_plain(cuda, dtype, tol, h, h_kv,
                                                lengths, d, max_s):
    g = torch.Generator(device=cuda).manual_seed(h_kv + d)
    b = len(lengths)
    q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, h_kv, max_s, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, h_kv, max_s, d), generator=g, device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = dmod.decode_attn_cuda.launches
    got = dmod.decode_attention(q, k, v, lens)
    assert dmod.decode_attn_cuda.launches == before + 1
    want = dmod.decode_attention(q, k, v, lens, impl="torch")
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert not got[lens == 0].any()


def _verify_case(dev, dtype, b, n1, V, seed, tree):
    """Logits with a forced argmax tie in row 1, drafts that mostly follow
    their parent row's argmax (so some rounds accept), one random draft
    (usually outside top-k), and uniform noise."""
    from apex_tpu_torch.spec.tree import draft_tree

    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((b, n1, V), generator=g, device=dev) * 4.0
    logits[:, 1, 7] = logits[:, 1].amax(-1) + 1.0
    logits[:, 1, 3] = logits[:, 1, 7]  # a tie: the lower index wins
    logits = logits.to(dtype)
    cand = vmod.row_argmax(logits.float())
    if tree:
        topo = draft_tree(2, (n1 - 1) // 2)
        parents, anc = (torch.as_tensor(a, device=dev)
                        for a in topo.operands(b))
        tokens = cand.gather(-1, parents.long())
        tokens[:, -1] = torch.randint(0, V, (b,), generator=g, device=dev)
        tokens[:, 2] = (tokens[:, 2] + 1) % V  # a wrong sibling
        extra = (tokens, parents, anc)
    else:
        drafted = cand[:, :-1].clone()
        drafted[:, -1] = torch.randint(0, V, (b,), generator=g, device=dev)
        extra = (drafted,)
    u_acc = torch.rand((b, n1), generator=g, device=dev)
    u_gum = torch.rand((b, n1, V), generator=g, device=dev).clamp_min(
        torch.finfo(torch.float32).tiny)
    return logits, extra, u_acc.clamp_min(torch.finfo(torch.float32).tiny), \
        u_gum


def _verify_near_ties(logits, extra, u_acc, u_gum, kw, tree):
    """Batch rows on which a near-tie could flip the sampled verdict."""
    s = smod.filtered_scaled(logits, **dict(dict(top_p=1.0), **kw))
    n1, V = s.shape[-2], s.shape[-1]
    if tree:
        tokens, parents, _ = extra
        tokens = tokens.clone()
        tokens[:, 0] = vmod.NO_DRAFT
    else:
        tokens = torch.cat([torch.full_like(extra[0][:, :1], vmod.NO_DRAFT),
                            extra[0]], dim=1)
        parents = (torch.arange(n1, device=s.device) - 1).clamp_min(0)
        parents = parents.expand_as(tokens)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    p = vmod._token_mass(e, tokens) / e.sum(-1)[..., None]   # (b, r, c)
    ratio = p.gather(1, parents.long()[:, None, :])[:, 0]     # (b, c)
    ua = u_acc if tree else torch.cat([u_acc[:, -1:], u_acc[:, :-1]], 1)
    tie = ((ua - ratio).abs() <= NEAR_TIE * ratio) & (tokens >= 0)
    drop = torch.zeros_like(s, dtype=torch.bool)
    for c in range(1, n1):
        t = tokens[:, c]
        ok = t >= 0
        drop[ok, parents[ok, c].long(), t[ok].long()] = True
    x = (torch.where(drop, smod.FILTERED, s)
         - torch.log(-torch.log(u_gum))).double()
    top2 = x.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).abs() <= NEAR_TIE * top2[..., 0].abs()
    return tie.any(-1) | gap.any(-1)


# (b, n1, V) whose plans take each split: S 8 (the spec leg's shapes), 4,
# 2, and 1; a V that is no multiple of 8 (element loads)
VERIFY_SPLITS = [(1, 5, 32768, 8), (1, 9, 32768, 8), (4, 5, 32768, 4),
                 (4, 9, 32768, 2), (16, 9, 1000, 1), (2, 5, 1001, 4)]


def _verify_verdicts(tree, logits, extra, kw):
    fn = vmod.fused_verify_tree if tree else vmod.fused_verify
    return fn(logits, *extra, **kw)


def _verify_bad(got, want):
    bad = torch.zeros_like(got[0], dtype=torch.bool)
    for x, y in zip(got, want):
        bad |= x != y
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n1,V,splits", VERIFY_SPLITS)
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 50),
                                               (1.3, 0)])
def test_verify_kernels_match_plain(cuda, dtype, b, n1, V, splits, tree,
                                   temperature, top_k):
    """Each cluster size the plan takes, in both dtypes: verdicts equal to
    the plain version's (sampled: outside near-ties), bit-identical across
    two runs, one launch a call; the card holds the plan's clusters and
    the kernel's shared memory is the plan's."""
    plan = vmod._plan_for(torch.empty((b, n1, V), device=cuda))
    assert plan.splits == splits
    clusters, smem = vmod.verify_occupancy(plan, dtype, V, tree)
    assert clusters > 0 and smem == plan.smem
    logits, extra, u_acc, u_gum = _verify_case(cuda, dtype, b, n1, V,
                                               seed=b * n1 + V, tree=tree)
    kw = dict(temperature=temperature, top_k=top_k)
    if temperature:
        kw.update(u_acc=u_acc, u_gum=u_gum)
    counter = vmod.fused_verify_tree_cuda if tree else vmod.fused_verify_cuda
    before = counter.launches
    got = _verify_verdicts(tree, logits, extra, kw)
    again = _verify_verdicts(tree, logits, extra, kw)
    assert counter.launches == before + 2
    want = _verify_verdicts(tree, logits, extra, dict(kw, impl="torch"))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    bad = _verify_bad(got, want)
    if temperature:
        bad &= ~_verify_near_ties(logits, extra, u_acc, u_gum,
                                  dict(temperature=temperature,
                                       top_k=top_k), tree)
    assert not bad.any(), f"verdicts {got} vs plain {want}"


@pytest.mark.gpu
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_verify_back_to_back_launches_reset_the_counters(cuda, tree,
                                                         temperature):
    """Launches back to back on one workspace, on different inputs and
    shapes: each verdict right, so each launch's last arriver left its
    counters at 0 and no slot of an earlier call was read as its own."""
    V = 32768
    cases = [_verify_case(cuda, torch.bfloat16, b, n1, V, seed=s, tree=tree)
             for b, n1, s in ((1, 9, 1), (1, 9, 2), (4, 5, 3), (1, 5, 4),
                              (4, 9, 5))]
    kws = []
    for logits, extra, u_acc, u_gum in cases:
        kw = dict(temperature=temperature, top_k=50)
        if temperature:
            kw.update(u_acc=u_acc, u_gum=u_gum)
        kws.append(kw)
    got = [_verify_verdicts(tree, c[0], c[1], kw)
           for c, kw in zip(cases, kws)]
    for (logits, extra, u_acc, u_gum), kw, g in zip(cases, kws, got):
        want = _verify_verdicts(tree, logits, extra, dict(kw, impl="torch"))
        bad = _verify_bad(g, want)
        if temperature:
            bad &= ~_verify_near_ties(logits, extra, u_acc, u_gum,
                                      dict(temperature=temperature,
                                           top_k=50), tree)
        assert not bad.any()


@pytest.mark.gpu
@pytest.mark.parametrize("b,n1", [(1, 5), (1, 9), (4, 9)])
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("fault", ("drop_last_rank", "no_publish"))
def test_verify_planted_faults_are_refused(cuda, b, n1, tree, temperature,
                                           fault):
    """Row 0's largest logit, 30 above the rest, in the last rank's share,
    its children drafting other tokens with draws near 1: the sound kernel
    emits that token at every batch row; with the last rank left out of
    the merges, or row 0's slots never published, no batch row does."""
    V = 32768
    logits, extra, u_acc, u_gum = _verify_case(cuda, torch.bfloat16, b, n1,
                                               V, seed=5, tree=tree)
    logits[:, 0, V - 5] = logits[:, 0].float().amax(-1).bfloat16() + 30.0
    if tree:
        tokens = extra[0].clone()
        tokens[:, 0] = vmod.NO_DRAFT
        tokens[:, 1], tokens[:, 1 + (n1 - 1) // 2] = 11, 12
        args = (logits, tokens, *extra[1:])
        kern = vmod.fused_verify_tree_cuda
    else:
        pad = torch.cat([extra[0], torch.full_like(extra[0][:, :1],
                                                   vmod.NO_DRAFT)], 1)
        pad[:, 0] = 11
        args = (logits, pad)
        kern = vmod.fused_verify_cuda
    noise = (torch.full_like(u_acc, 0.999), u_gum) if temperature \
        else (None, None)
    kw = dict(temperature=temperature, top_k=50)
    sound = kern(*args, *noise, **kw)
    assert (sound[-1] == V - 5).all()
    got = kern(*args, *noise, **kw, planted_fault=fault)
    assert _verify_bad(got, sound).all()
    again = kern(*args, *noise, **kw)  # a sound launch after the fault
    assert all(torch.equal(x, y) for x, y in zip(again, sound))


def _top_p_near_ties(logits, extra, u_acc, u_gum, kw, tree):
    """Batch rows on which a near-tie could flip a top-p verdict: those of
    :func:`_verify_near_ties` on the top-p filtered target, and rows whose
    nucleus boundary is near a tie (a cumulative mass of the top-k
    survivors, best first, within 1e-5 relative of top_p times their
    total)."""
    t, k, p = kw["temperature"], kw["top_k"], kw["top_p"]
    near = _verify_near_ties(logits, extra, u_acc, u_gum,
                             dict(temperature=t, top_k=k, top_p=p), tree)
    s = smod.filtered_scaled(logits, temperature=t, top_k=k,
                             top_p=1.0).double()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    cum = e.sort(dim=-1, descending=True).values.cumsum(-1)
    target = p * cum[..., -1:]
    edge = ((cum - target).abs() <= NEAR_TIE * target).any(-1)  # (b, r)
    return near | edge.any(-1)


# the serve's shapes (8 slots: chain k 4, tree depth 4 x branching 2), the
# spec leg's, and (16, 9): 288 CTAs at S 2, more than one wave
VERIFY_TOP_P_SHAPES = [(1, 5), (1, 9), (8, 5), (8, 9), (16, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n1", VERIFY_TOP_P_SHAPES)
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("top_k,top_p", [(50, 0.9), (0, 0.9), (50, 0.5),
                                         (0, 0.5)])
def test_verify_top_p_matches_plain(cuda, b, n1, tree, top_k, top_p):
    """Top-p after top-k (the gathered survivors at top_k 50, the mass
    rounds at top_k 0) at the serve's shapes and past one wave: verdicts
    equal to the plain version's outside near-ties, bit-identical across
    two runs, each launch counted as a top-p launch; the card holds the
    top-p instance's clusters, whose shared memory is its own."""
    V = 32768
    plan = vmod._plan_for(torch.empty((b, n1, V), device=cuda))
    clusters, smem = vmod.verify_occupancy(plan, torch.bfloat16, V, tree,
                                           top_p=True)
    assert clusters > 0 and smem == vmod.VERIFY_TOP_P_SMEM
    logits, extra, u_acc, u_gum = _verify_case(cuda, torch.bfloat16, b, n1,
                                               V, seed=b * n1 + top_k,
                                               tree=tree)
    kw = dict(temperature=0.8, top_k=top_k, top_p=top_p, u_acc=u_acc,
              u_gum=u_gum)
    counter = vmod.fused_verify_tree_cuda if tree else vmod.fused_verify_cuda
    before = counter.top_p_launches
    got = _verify_verdicts(tree, logits, extra, kw)
    again = _verify_verdicts(tree, logits, extra, kw)
    assert counter.top_p_launches == before + 2
    want = _verify_verdicts(tree, logits, extra, dict(kw, impl="torch"))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    bad = _verify_bad(got, want)
    bad &= ~_top_p_near_ties(logits, extra, u_acc, u_gum, kw, tree)
    assert not bad.any(), f"verdicts {got} vs plain {want}"


@pytest.mark.gpu
@pytest.mark.parametrize("b,n1", [(1, 9), (8, 9)])
@pytest.mark.parametrize("tree", [False, True])
def test_verify_top_p_ties_past_the_gather(cuda, b, n1, tree):
    """Ties at the k-th value push top-k's survivors past the 256 rank 0
    gathers (40 logits above each row's largest, then 300 equal ones 1
    below it, the 50th value): the kernel takes the mass rounds instead,
    with the same verdicts as the plain version."""
    V = 32768
    logits, extra, u_acc, u_gum = _verify_case(cuda, torch.bfloat16, b, n1,
                                               V, seed=n1, tree=tree)
    top = logits.float().amax(-1, keepdim=True)
    steps = 0.25 * torch.arange(1, 41, device=cuda)
    logits[..., 1000:1040] = (top + steps).to(logits.dtype)
    logits[..., 2000:2300] = (top - 1.0).expand(b, n1, 300).to(logits.dtype)
    kw = dict(temperature=0.8, top_k=50, top_p=0.9, u_acc=u_acc,
              u_gum=u_gum)
    got = _verify_verdicts(tree, logits, extra, kw)
    want = _verify_verdicts(tree, logits, extra, dict(kw, impl="torch"))
    bad = _verify_bad(got, want)
    bad &= ~_top_p_near_ties(logits, extra, u_acc, u_gum, kw, tree)
    assert not bad.any()


@pytest.mark.gpu
@pytest.mark.parametrize("b,n1", [(1, 5), (8, 5), (1, 9), (8, 9)])
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("top_k", [0, 50])
def test_verify_no_top_p_fault_is_refused(cuda, b, n1, tree, top_k):
    """Row 0 puts 0.95 of its mass on token 100 and row 0's first child
    drafts the runner-up (p 0.047), inside top-k but outside the 0.9
    nucleus, with an acceptance draw of 1e-3: the sound kernel rejects it
    at every batch row (p = 0), the kernel with top-p skipped accepts it.
    The row's top 50 are distinct (the gathered path at top_k 50)."""
    V = 32768
    logits, extra, u_acc, u_gum = _verify_case(cuda, torch.bfloat16, b, n1,
                                               V, seed=3, tree=tree)
    logits[:, 0] = -30.0
    logits[:, 0, 300:348] = (-10.0 + 0.125 * torch.arange(
        48, device=cuda)).to(logits.dtype)
    logits[:, 0, 100] = 8.0
    logits[:, 0, 200] = 5.6
    if tree:
        tokens = extra[0].clone()
        tokens[:, 0] = vmod.NO_DRAFT
        tokens[:, 1] = 200
        tokens[:, 1 + (n1 - 1) // 2] = 300
        args = (logits, tokens, *extra[1:])
        kern = vmod.fused_verify_tree_cuda
    else:
        pad = torch.cat([extra[0], torch.full_like(extra[0][:, :1],
                                                   vmod.NO_DRAFT)], 1)
        pad[:, 0] = 200
        args = (logits, pad)
        kern = vmod.fused_verify_cuda
    noise = (torch.full_like(u_acc, 1e-3), u_gum)
    kw = dict(temperature=0.8, top_k=top_k, top_p=0.9)
    sound = kern(*args, *noise, **kw)
    assert (sound[0] == 0).all() and (sound[-1] == 100).all()
    got = kern(*args, *noise, **kw, planted_fault="no_top_p")
    assert (got[0] >= 1).all()
    again = kern(*args, *noise, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, sound))


@pytest.mark.gpu
def test_verify_kernels_refuse_what_they_do_not_take(cuda):
    V = vmod.KERNEL_MAX_VOCAB + 8
    logits = torch.zeros((1, 5, V), dtype=torch.bfloat16, device=cuda)
    pad = torch.full((1, 5), vmod.NO_DRAFT, dtype=torch.int32, device=cuda)
    u = torch.full((1, 5), 0.5, device=cuda)
    with pytest.raises(ValueError, match="registers"):
        vmod.fused_verify_cuda(logits, pad, u, u[..., None].expand(
            1, 5, V).contiguous(), temperature=0.8, top_k=50)
    a, nxt = vmod.fused_verify_cuda(logits, pad, None, None,
                                    temperature=0.0, top_k=0)
    assert int(a) == 0 and int(nxt) == 0  # greedy takes any V
    with pytest.raises(ValueError, match="no planted fault"):
        vmod.fused_verify_cuda(logits, pad, None, None, temperature=0.0,
                               top_k=0, planted_fault="drop_bias")
    with pytest.raises(ValueError, match="verify rows"):
        vmod.fused_verify_cuda(logits[:, :1], pad[:, :1], None, None,
                               temperature=0.0, top_k=0)


@pytest.mark.gpu
def test_decode_engine_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 128, 2, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        amod.flash_fwd_bshd(q, q, q, scale=1.0, causal=True)
    q = torch.zeros((1, 8, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 8, 200, 64), dtype=torch.bfloat16, device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        dmod.decode_attention(q, k, k, lens)
    logits = torch.zeros((1, 200, 64), device=cuda)
    with pytest.raises(ValueError, match="verify rows"):
        vmod.fused_verify(logits, torch.zeros((1, 199), dtype=torch.int32,
                                              device=cuda))


# --- the bh-flat flash kernels (T5 train step) --------------------------------

def _flat_inputs(b, h, h_kv, sq, sk, d, dev, seed, views):
    """bf16 q (b, h, sq, d), k/v (b, h_kv, sk, d), do: with ``views`` the
    transposed (b, h, s, d) views of (b, s, heads·d) projection buffers,
    as the T5 blocks pass them; else contiguous (b·h, s, d) rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731,E501
    if views:
        q = rnd(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
        kv = rnd(b, sk, 2 * h_kv * d)
        k, v = (t.view(b, sk, h_kv, d).transpose(1, 2)
                for t in kv.split(h_kv * d, -1))
        do = rnd(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
        return q, k, v, do
    return (rnd(b * h, sq, d), rnd(b * h_kv, sk, d), rnd(b * h_kv, sk, d),
            rnd(b * h, sq, d))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal,lens,rel,views", [
    # the T5 step's three calls at small batch: encoder self (bidirectional
    # buckets, padded keys), decoder self (causal buckets, tail 114),
    # cross (114 x 512, padded keys, no bias)
    (2, 4, 4, 512, 512, 64, False, [300, 512], (True, 128, 0, 0), True),
    (2, 4, 4, 114, 114, 64, True, None, (False, 128, 0, 0), True),
    (2, 4, 4, 114, 512, 64, False, [256, 512], None, True),
    # the encoder self and cross calls of an unpadded batch, as the timed
    # train steps make them: no kv_lens (and no bias on the cross call)
    (2, 4, 4, 512, 512, 64, False, None, (True, 128, 0, 0), True),
    (2, 4, 4, 114, 512, 64, False, None, None, True),
    # a kv tile wholly past every length, a row of length 0, GQA, d 128
    (2, 8, 2, 128, 256, 128, False, [0, 60], (True, 32, 0, 0), False),
    # nonzero offsets past max_distance, causal sq < sk
    (1, 4, 4, 100, 300, 64, True, None, (True, 40, 500, 320), True),
    (3, 2, 1, 77, 77, 128, False, [77, 1, 40], (False, 40, 0, 0), False),
])
def test_flash_flat_kernels_match_plain(cuda, b, h, h_kv, sq, sk, d, causal,
                                        lens, rel, views):
    q, k, v, do = _flat_inputs(b, h, h_kv, sq, sk, d, cuda, seed=sq + sk + d,
                               views=views)
    kv_lens = (None if lens is None else torch.tensor(
        np.repeat(lens, h), dtype=torch.int32, device=cuda))
    bias = None
    if rel is not None:
        g = torch.Generator(device=cuda).manual_seed(3)
        table = torch.randn((32, h), generator=g, device=cuda) * 0.5
        bias = amod.BucketedBias(table, *rel)
    kw = dict(scale=d ** -0.5, causal=causal, kv_lens=kv_lens, rel_bias=bias)
    up = lambda ts: [t.float() for t in ts]  # noqa: E731
    before = (amod.flash_fwd_flat_cuda.launches,
              amod.flash_bwd_flat_dkv_cuda.launches,
              amod.flash_bwd_flat_dkv_cuda.table_launches,
              amod.flash_bwd_flat_dq_cuda.launches)
    o, lse = amod.flash_fwd(q, k, v, **kw)
    o_p, lse_p = amod.flash_fwd(q, k, v, impl="torch", **kw)
    o_t, lse_t = amod.flash_fwd(*up((q, k, v)), impl="torch", **kw)
    assert o.shape == q.shape and lse.shape == lse_p.shape
    for name, got, p, t in (("o", o, o_p, o_t), ("lse", lse, lse_p, lse_t)):
        ok, errs = _within_rule(got, p, t)
        assert ok, f"flat fwd {name}: kernel/plain errors {errs}"
    if lens is not None and 0 in lens:
        dead = (kv_lens == 0)
        assert not o.reshape(b * h, sq, d)[dead].float().any()
        assert not lse[dead].any()
    grads = amod.flash_bwd(q, k, v, o_p, lse_p, do, **kw)
    plain = amod.flash_bwd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
    truth = amod.flash_bwd(*up((q, k, v, o_p)), lse_p, do.float(),
                           impl="torch", **kw)
    torch.cuda.synchronize()
    after = (amod.flash_fwd_flat_cuda.launches,
             amod.flash_bwd_flat_dkv_cuda.launches,
             amod.flash_bwd_flat_dkv_cuda.table_launches,
             amod.flash_bwd_flat_dq_cuda.launches)
    assert after == (before[0] + 1, before[1] + 1,
                     before[2] + (bias is not None), before[3] + 1)
    for name, got, p, t in zip(("dq", "dk", "dv"), grads, plain, truth):
        assert got.shape == p.shape and torch.isfinite(got.float()).all()
        ok, errs = _within_rule(got, p, t)
        assert ok, f"flat bwd {name}: kernel/plain errors {errs}"
    if bias is None:
        assert grads[3] is None
    else:
        err = (grads[3] - plain[3]).norm() / plain[3].norm()
        assert err <= 1e-3, f"dtable rel norm err {err}"


@pytest.mark.gpu
def test_flash_flat_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((2, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        amod.flash_fwd(q, q, q, scale=1.0, causal=False)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="max_distance"):
        amod.flash_fwd(qb, qb, qb, scale=1.0, causal=False,
                       rel_bias=amod.BucketedBias(
                           torch.zeros((32, 2), device=cuda),
                           max_distance=5000))
    with pytest.raises(ValueError, match="kv_lens"):
        amod.flash_fwd(qb, qb, qb, scale=1.0, causal=False,
                       kv_lens=torch.ones(2, dtype=torch.int64, device=cuda))


# --- the bshd backward and the array bias (BERT, T5 materialized) -------------

DBIAS_TOL = 1e-3  # dbias: relative norm error against the fp32 truth


def _bshd_inputs(b, sq, sk, h, h_kv, d, dev, seed, packed):
    """bf16 q (b, sq, h, d), k/v (b, sk, h_kv, d), do: with ``packed``
    views of one (b, s, (h + 2·h_kv)·d) projection buffer, as BERT passes
    them (sq == sk), else separate contiguous tensors."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731,E501
    do = rnd(b, sq, h, d)
    if packed:
        y = rnd(b, sq, (h + 2 * h_kv) * d)
        return (y[..., :h * d].view(b, sq, h, d),
                y[..., h * d:(h + h_kv) * d].view(b, sq, h_kv, d),
                y[..., (h + h_kv) * d:].view(b, sq, h_kv, d), do)
    return rnd(b, sq, h, d), rnd(b, sk, h_kv, d), rnd(b, sk, h_kv, d), do


def _bias_input(hb, sq, sk, dev, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((hb, sq, sk), generator=g, device=dev)


def _counts(*fns):
    return tuple(getattr(f, a) for f in fns
                 for a in ("launches", "bias_launches") if hasattr(f, a))


def _check_dbias(got, truth):
    assert got.dtype == torch.float32 and got.shape == truth.shape
    err = ((got - truth).norm() / truth.norm()).item()
    assert err <= DBIAS_TOL, f"dbias rel norm err {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,h_kv,d,causal,lens,hb,packed", [
    # BERT-large's heads at a small batch: a row of length 0, a full row
    (4, 512, 512, 16, 16, 64, False, [512, 0, 64, 300], None, True),
    # GQA, causal, d 128, no padding
    (2, 300, 300, 8, 2, 128, True, None, None, True),
    # sq != sk, ragged tails, a bias shared by head pairs (hb 2 | h 4)
    (3, 77, 200, 4, 4, 128, False, [1, 200, 130], 2, False),
    # GQA with a broadcast bias (hb 1), causal and padded
    (2, 114, 114, 8, 2, 64, True, [114, 50], 1, True),
    # one bias row per head (hb = h), a kv tile past every length
    (2, 128, 256, 4, 4, 64, False, [60, 0], 4, False),
])
def test_flash_bshd_backward_kernels_match_plain(cuda, b, sq, sk, h, h_kv, d,
                                                 causal, lens, hb, packed):
    q, k, v, do = _bshd_inputs(b, sq, sk, h, h_kv, d, cuda, sq + sk + h,
                               packed)
    kv_lens = (None if lens is None else
               torch.tensor(lens, dtype=torch.int32, device=cuda))
    bias = None if hb is None else _bias_input(hb, sq, sk, cuda)
    kw = dict(scale=d ** -0.5, causal=causal, kv_lens=kv_lens, bias=bias)
    up = lambda ts: [t.float() for t in ts]  # noqa: E731
    fns = (amod.flash_fwd_bshd_cuda, amod.flash_bwd_bshd_dkv_cuda,
           amod.flash_bwd_bshd_dq_cuda, amod.flash_bwd_dbias_cuda)
    before = _counts(*fns)
    o, lse = amod.flash_fwd_bshd(q, k, v, **kw)
    o_p, lse_p = amod.flash_fwd_bshd(q, k, v, impl="torch", **kw)
    o_t, lse_t = amod.flash_fwd_bshd(*up((q, k, v)), impl="torch", **kw)
    for name, got, p, t in (("o", o, o_p, o_t), ("lse", lse, lse_p, lse_t)):
        ok, errs = _within_rule(got, p, t)
        assert ok, f"bshd fwd {name}: kernel/plain errors {errs}"
    if lens is not None and 0 in lens:
        dead = kv_lens == 0
        assert not o[dead].float().any() and not lse[dead].any()
    grads = amod.flash_bwd_bshd(q, k, v, o_p, lse_p, do, **kw)
    plain = amod.flash_bwd_bshd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
    truth = amod.flash_bwd_bshd(*up((q, k, v, o_p)), lse_p, do.float(),
                                impl="torch", **kw)
    torch.cuda.synchronize()
    b_ = bias is not None
    assert _counts(*fns) == tuple(n + i for n, i in zip(
        before, (1, b_, 1, b_, 1, b_, b_)))
    for name, got, p, t in zip(("dq", "dk", "dv"), grads, plain, truth):
        assert got.shape == p.shape and torch.isfinite(got.float()).all()
        ok, errs = _within_rule(got, p, t)
        assert ok, f"bshd bwd {name}: kernel/plain errors {errs}"
    if bias is None:
        assert grads[3] is None
    else:
        _check_dbias(grads[3], truth[3])


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal,lens,hb,views", [
    # T5's encoder call at a small batch: one bias row per head, padded
    (2, 4, 4, 512, 512, 64, False, [300, 512], 4, True),
    # T5's decoder self-attention: causal, a tail of 114
    (2, 4, 4, 114, 114, 64, True, None, 4, True),
    # a broadcast bias (hb 1), GQA, d 128, a row of length 0
    (2, 8, 2, 128, 256, 128, False, [0, 60], 1, False),
    # one bias row per q-head row (hb = b·h), causal sq < sk
    (3, 2, 1, 77, 100, 128, True, [100, 1, 40], 6, False),
])
def test_flash_flat_array_bias_kernels_match_plain(cuda, b, h, h_kv, sq, sk,
                                                   d, causal, lens, hb,
                                                   views):
    q, k, v, do = _flat_inputs(b, h, h_kv, sq, sk, d, cuda, seed=sq + hb,
                               views=views)
    kv_lens = (None if lens is None else torch.tensor(
        np.repeat(lens, h), dtype=torch.int32, device=cuda))
    bias = _bias_input(hb, sq, sk, cuda)
    kw = dict(scale=d ** -0.5, causal=causal, kv_lens=kv_lens, bias=bias)
    up = lambda ts: [t.float() for t in ts]  # noqa: E731
    fns = (amod.flash_fwd_flat_cuda, amod.flash_bwd_flat_dkv_cuda,
           amod.flash_bwd_flat_dq_cuda, amod.flash_bwd_dbias_cuda)
    before = _counts(*fns)
    table_before = amod.flash_bwd_flat_dkv_cuda.table_launches
    o, lse = amod.flash_fwd(q, k, v, **kw)
    o_p, lse_p = amod.flash_fwd(q, k, v, impl="torch", **kw)
    o_t, lse_t = amod.flash_fwd(*up((q, k, v)), impl="torch", **kw)
    for name, got, p, t in (("o", o, o_p, o_t), ("lse", lse, lse_p, lse_t)):
        ok, errs = _within_rule(got, p, t)
        assert ok, f"flat bias fwd {name}: kernel/plain errors {errs}"
    grads = amod.flash_bwd(q, k, v, o_p, lse_p, do, **kw)
    plain = amod.flash_bwd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
    truth = amod.flash_bwd(*up((q, k, v, o_p)), lse_p, do.float(),
                           impl="torch", **kw)
    torch.cuda.synchronize()
    assert _counts(*fns) == tuple(n + 1 for n in before)
    assert amod.flash_bwd_flat_dkv_cuda.table_launches == table_before
    for name, got, p, t in zip(("dq", "dk", "dv"), grads, plain, truth):
        assert got.shape == p.shape and torch.isfinite(got.float()).all()
        ok, errs = _within_rule(got, p, t)
        assert ok, f"flat bias bwd {name}: kernel/plain errors {errs}"
    _check_dbias(grads[3], truth[3])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_attention_bias_cotangent_in_its_dtype(cuda, layout):
    """flash_attention with a bf16 array bias: the kernel path's bias
    gradient comes back in bf16 and agrees with the plain path's."""
    b, h, s, d = 2, 4, 128, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda).bfloat16()
                   for _ in range(4))
    lens = torch.tensor([100, 128], dtype=torch.int32, device=cuda)
    if layout == "bhsd":
        lens = lens[:, None].expand(b, h)
    out = []
    for impl in ("auto", "torch"):
        bias = _bias_input(h, s, s, cuda).bfloat16().requires_grad_()
        o = amod.flash_attention(q, k, v, kv_lens=lens, bias=bias,
                                 layout=layout, impl=impl)
        o.backward(do)
        out.append(bias.grad)
    assert out[0].dtype == torch.bfloat16
    err = ((out[0].float() - out[1].float()).norm()
           / out[1].float().norm()).item()
    assert err <= 1e-2, f"bias cotangent kernel vs plain: {err}"


@pytest.mark.gpu
def test_bshd_backward_and_bias_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((2, 64, 4, 64), dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros((2, 4, 64), device=cuda)
    kw = dict(scale=1.0, causal=False)
    with pytest.raises(ValueError, match="per batch"):
        amod.flash_bwd_bshd_dq_cuda(q, q, q, q, lse, q, **kw,
                                    kv_lens=torch.ones((8,), dtype=torch.int32,
                                                       device=cuda))
    with pytest.raises(ValueError, match="hb dividing"):
        amod.flash_fwd_bshd_cuda(q, q, q, **kw,
                                 bias=torch.zeros((3, 64, 64), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        amod.flash_bwd_dbias_cuda(q, q, q, q, lse, q,
                                  torch.zeros((4, 64, 64), device=cuda,
                                              dtype=torch.bfloat16),
                                  **kw, layout="bshd")
    qf = q.transpose(1, 2)
    with pytest.raises(ValueError, match="not both"):
        amod.flash_fwd_flat_cuda(
            qf, qf, qf, **kw, bias=torch.zeros((4, 64, 64), device=cuda),
            rel_bias=amod.BucketedBias(torch.zeros((32, 4), device=cuda)))


# --- the backward pair's two variants (wgmma, sm80) ---------------------------

# (name, layout, b, h, h_kv, sq, sk, d, causal, lens, bias): each family's
# backward call at its widths, the batch cut. lens: per batch (expanded
# over the heads on bhsd); bias: "rel" (T5's bucketed table), "arr" (one
# bias row per head) or "arr1" (hb 1)
BWD_FAMILIES = [
    ("gpt_packed_d128", "packed", 2, 8, 8, 1024, 1024, 128, True, None, None),
    ("packed_gqa_d64", "packed", 2, 8, 2, 1000, 1000, 64, True, None, None),
    ("t5_encoder_table", "bhsd", 4, 12, 12, 512, 512, 64, False,
     [300, 512, 256, 400], "rel"),
    ("t5_decoder_table", "bhsd", 4, 12, 12, 114, 114, 64, True, None, "rel"),
    ("t5_cross", "bhsd", 4, 12, 12, 114, 512, 64, False, [256, 512, 300, 1],
     None),
    ("t5_encoder_bias", "bhsd", 2, 12, 12, 512, 512, 64, False, None, "arr"),
    ("t5_decoder_bias_114", "bhsd", 4, 12, 12, 114, 114, 64, True, None,
     "arr"),
    ("bert_kv_lens", "bshd", 4, 16, 16, 512, 512, 64, False,
     [512, 0, 64, 300], None),
    ("bshd_bias_hb1", "bshd", 2, 16, 16, 512, 512, 64, False, None, "arr1"),
    ("gqa_d128_bias_lens", "bhsd", 2, 8, 4, 300, 300, 128, True, [300, 77],
     "arr"),
    ("gqa_d128_table", "bhsd", 2, 8, 2, 256, 256, 128, False, [256, 100],
     "rel"),
    # the bucketed table on the seq-major layout (queue 2, item 3)
    ("bshd_table_lens", "bshd", 4, 16, 16, 512, 512, 64, False,
     [512, 0, 64, 300], "rel"),
    ("bshd_table_gqa_causal", "bshd", 2, 8, 2, 256, 256, 128, True, None,
     "rel"),
]
_BWD_IDS = [f[0] for f in BWD_FAMILIES]


def _table_bias(h, causal, dev):
    """T5's bucketed bias: a seeded (32, h) table, max distance 128,
    bidirectional unless causal."""
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((32, h), generator=g, device=dev) * 0.5
    return amod.BucketedBias(table, bidirectional=not causal,
                             max_distance=128)


def _bwd_family(fam, dev):
    """(pair, plain, truth, fns): ``pair(variant, fault)`` runs the
    family's dQ then dK/dV wrapper and returns (dq, dk, dv, dtable or
    None); plain and truth are the plain backward's in bf16 and in fp32
    on the plain forward's o and lse; fns the two wrappers."""
    _, layout, b, h, hkv, sq, sk, d, causal, lens, bias = fam
    seed = sq + sk + h + d
    up = lambda ts: [t.float() for t in ts]  # noqa: E731
    if layout == "packed":
        qkv, do = _flash_inputs(b, sq, h, hkv, d, dev, seed=seed)
        kw = dict(scale=d ** -0.5, causal=causal)
        o, lse = amod.flash_fwd_packed(qkv, h, hkv, d, impl="torch", **kw)
        plain = amod.flash_bwd_packed(qkv, o, lse, do, h, hkv, d,
                                      impl="torch", **kw)
        truth = amod.flash_bwd_packed(qkv.float(), o.float(), lse,
                                      do.float(), h, hkv, d, impl="torch",
                                      **kw)

        def pair(variant, fault=None):
            dq, delta = amod.flash_bwd_dq_cuda(
                qkv, o, lse, do, h, hkv, d, variant=variant,
                planted_fault=fault, **kw)
            dk, dv = amod.flash_bwd_dkv_cuda(
                qkv, o, lse, do, h, hkv, d, delta=delta, variant=variant,
                planted_fault=fault, **kw)
            return dq, dk, dv, None
        fns = (amod.flash_bwd_dq_cuda, amod.flash_bwd_dkv_cuda)
        return pair, (*plain, None), (*truth, None), fns
    lens_t = None
    if lens is not None:
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    if layout == "bhsd":
        q, k, v, do = _flat_inputs(b, h, hkv, sq, sk, d, dev, seed, True)
        if lens_t is not None:
            lens_t = lens_t.repeat_interleave(h)
        kw = dict(scale=d ** -0.5, causal=causal, kv_lens=lens_t)
        if bias == "rel":
            g = torch.Generator(device=dev).manual_seed(3)
            table = torch.randn((32, h), generator=g, device=dev) * 0.5
            kw["rel_bias"] = amod.BucketedBias(table, bidirectional=not causal,
                                               max_distance=128)
        elif bias is not None:
            kw["bias"] = _bias_input(h, sq, sk, dev)
        fwd, bwd = amod.flash_fwd, amod.flash_bwd
        fns = (amod.flash_bwd_flat_dq_cuda, amod.flash_bwd_flat_dkv_cuda)
    else:
        q, k, v, do = _bshd_inputs(b, sq, sk, h, hkv, d, dev, seed, sq == sk)
        kw = dict(scale=d ** -0.5, causal=causal, kv_lens=lens_t)
        if bias == "rel":
            kw["rel_bias"] = _table_bias(h, causal, dev)
        elif bias is not None:
            kw["bias"] = _bias_input(1 if bias == "arr1" else h, sq, sk, dev)
        fwd, bwd = amod.flash_fwd_bshd, amod.flash_bwd_bshd
        fns = (amod.flash_bwd_bshd_dq_cuda, amod.flash_bwd_bshd_dkv_cuda)
    o, lse = fwd(q, k, v, impl="torch", **kw)
    plain = bwd(q, k, v, o, lse, do, impl="torch", **kw)
    truth = bwd(*up((q, k, v, o)), lse, do.float(), impl="torch", **kw)

    def pair(variant, fault=None):
        dq, delta = fns[0](q, k, v, o, lse, do, variant=variant,
                           planted_fault=fault, **kw)
        out = fns[1](q, k, v, o, lse, do, delta=delta, variant=variant,
                     planted_fault=fault, **kw)
        return (dq, *out) if len(out) == 3 else (dq, *out, None)
    if bias != "rel":  # dbias comes from its own kernel, not the pair
        plain, truth = (*plain[:3], None), (*truth[:3], None)
    return pair, plain, truth, fns


def _pair_within_rules(got, plain, truth):
    """(ok, errors): dq, dk, dv by the bf16 rule, the table by 1e-3 rel
    norm."""
    errs, ok = {}, True
    for name, g_, p_, t_ in zip(("dq", "dk", "dv"), got, plain, truth):
        good, e = _within_rule(g_, p_, t_)
        good = good and bool(torch.isfinite(g_.float()).all())
        errs[name] = e
        ok &= good
    if truth[3] is not None:
        rel = ((got[3] - truth[3]).norm() / truth[3].norm()).item()
        errs["dtable"] = rel
        ok &= rel <= DTABLE_TOL
    return ok, errs


DTABLE_TOL = 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["wgmma", "sm80"])
@pytest.mark.parametrize("fam", BWD_FAMILIES, ids=_BWD_IDS)
def test_flash_bwd_variants_match_plain(cuda, fam, variant):
    pair, plain, truth, fns = _bwd_family(fam, cuda)
    before = [(f.launches, getattr(f, f"{variant}_launches")) for f in fns]
    got = pair(variant)
    torch.cuda.synchronize()
    assert [(f.launches, getattr(f, f"{variant}_launches"))
            for f in fns] == [(n + 1, m + 1) for n, m in before]
    ok, errs = _pair_within_rules(got, plain, truth)
    assert ok, f"{fam[0]} on {variant}: {errs}"


@pytest.mark.gpu
@pytest.mark.parametrize("fam", BWD_FAMILIES, ids=_BWD_IDS)
def test_flash_bwd_wgmma_is_bit_identical_across_runs(cuda, fam):
    pair, _, _, _ = _bwd_family(fam, cuda)
    first = pair("wgmma")
    second = pair("wgmma")
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), f"{fam[0]}: {name} differs between runs"


@pytest.mark.gpu
@pytest.mark.parametrize("fam", BWD_FAMILIES, ids=_BWD_IDS)
def test_flash_bwd_planted_faults_are_refused(cuda, fam):
    """The last 64-row kv tile dropped, and (where the call has one) the
    bias left out: each must fail the rules on both variants."""
    pair, plain, truth, _ = _bwd_family(fam, cuda)
    faults = ["drop_last_kv_tile"] + (["drop_bias"] if fam[-1] else [])
    for variant in ("wgmma", "sm80"):
        for fault in faults:
            ok, errs = _pair_within_rules(pair(variant, fault), plain, truth)
            assert not ok, f"{fam[0]} {variant}: {fault} passed: {errs}"


@pytest.mark.gpu
def test_flash_bwd_runs_on_a_fresh_thread(cuda):
    """The pair from a thread whose first CUDA call is the dQ entry (as an
    autograd worker's can be): the tensor maps' encoder needs the
    device's context bound on that thread."""
    import threading

    q, k, v, do = _bshd_inputs(2, 128, 128, 4, 4, 64, cuda, 1, True)
    kw = dict(scale=0.125, causal=False)
    o, lse = amod.flash_fwd_bshd(q, k, v, **kw)
    want = amod.flash_bwd_bshd(q, k, v, o, lse, do, **kw)
    got, errors = [], []

    def run():
        try:
            got.append(amod.flash_bwd_bshd(q, k, v, o, lse, do, **kw))
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    for a, b_ in zip(got[0][:3], want[:3]):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_flash_bwd_dkv_wgmma_needs_the_dq_delta(cuda):
    qkv, do = _flash_inputs(1, 128, 2, 2, 64, cuda)
    kw = dict(scale=0.125, causal=True)
    o, lse = amod.flash_fwd_packed(qkv, 2, 2, 64, **kw)
    with pytest.raises(ValueError, match="delta"):
        amod.flash_bwd_dkv_cuda(qkv, o, lse, do, 2, 2, 64, **kw)
    _, delta = amod.flash_bwd_dq_cuda(qkv, o, lse, do, 2, 2, 64, **kw)
    with pytest.raises(ValueError, match="delta"):
        amod.flash_bwd_dkv_cuda(qkv, o, lse, do, 2, 2, 64, delta=delta[:1],
                                **kw)
    with pytest.raises(ValueError, match="variant"):
        amod.flash_bwd_dq_cuda(qkv, o, lse, do, 2, 2, 64, variant="sm90",
                               **kw)
    dk, dv = amod.flash_bwd_dkv_cuda(qkv, o, lse, do, 2, 2, 64, variant="sm80",
                                     **kw)
    assert dk.shape == dv.shape == (1, 128, 128)


# --- the forward's and dbias's two variants (wgmma, sm80) ---------------------

# (name, layout, b, h, h_kv, sq, sk, d, causal, lens, bias): each family's
# forward call at its widths, the batch cut (as BWD_FAMILIES, with the
# decode prefill's and the ragged GQA bshd calls)
FWD_FAMILIES = BWD_FAMILIES + [
    ("prefill_bshd_d128", "bshd", 2, 8, 8, 512, 512, 128, True, None, None),
    ("gqa_bshd_ragged_300", "bshd", 2, 8, 2, 300, 300, 128, True, None,
     None),
]
_FWD_IDS = [f[0] for f in FWD_FAMILIES]


def _fwd_family(fam, dev):
    """(run, plain, truth, fn): ``run(variant, fault)`` calls the family's
    forward wrapper and returns (o, lse); plain and truth are the plain
    forward's in bf16 and in fp32 on the same bf16 inputs."""
    _, layout, b, h, hkv, sq, sk, d, causal, lens, bias = fam
    seed = sq + sk + h + d + 1
    up = lambda ts: [t.float() for t in ts]  # noqa: E731
    if layout == "packed":
        qkv, _ = _flash_inputs(b, sq, h, hkv, d, dev, seed=seed)
        kw = dict(scale=d ** -0.5, causal=causal)
        plain = amod.flash_fwd_packed(qkv, h, hkv, d, impl="torch", **kw)
        truth = amod.flash_fwd_packed(qkv.float(), h, hkv, d, impl="torch",
                                      **kw)

        def run(variant, fault=None):
            return amod.flash_fwd_cuda(qkv, h, hkv, d, variant=variant,
                                       planted_fault=fault, **kw)
        return run, plain, truth, amod.flash_fwd_cuda
    lens_t = None
    if lens is not None:
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    if layout == "bhsd":
        q, k, v, _ = _flat_inputs(b, h, hkv, sq, sk, d, dev, seed, True)
        if lens_t is not None:
            lens_t = lens_t.repeat_interleave(h)
        kw = dict(scale=d ** -0.5, causal=causal, kv_lens=lens_t)
        if bias == "rel":
            g = torch.Generator(device=dev).manual_seed(3)
            table = torch.randn((32, h), generator=g, device=dev) * 0.5
            kw["rel_bias"] = amod.BucketedBias(table, bidirectional=not causal,
                                               max_distance=128)
        elif bias is not None:
            kw["bias"] = _bias_input(h, sq, sk, dev)
        fwd, fn = amod.flash_fwd, amod.flash_fwd_flat_cuda
    else:
        q, k, v, _ = _bshd_inputs(b, sq, sk, h, hkv, d, dev, seed, sq == sk)
        kw = dict(scale=d ** -0.5, causal=causal, kv_lens=lens_t)
        if bias == "rel":
            kw["rel_bias"] = _table_bias(h, causal, dev)
        elif bias is not None:
            kw["bias"] = _bias_input(1 if bias == "arr1" else h, sq, sk, dev)
        fwd, fn = amod.flash_fwd_bshd, amod.flash_fwd_bshd_cuda
    plain = fwd(q, k, v, impl="torch", **kw)
    truth = fwd(*up((q, k, v)), impl="torch", **kw)

    def run(variant, fault=None):
        return fn(q, k, v, variant=variant, planted_fault=fault, **kw)
    return run, plain, truth, fn


def _fwd_within_rules(got, plain, truth):
    errs, ok = {}, True
    for name, g_, p_, t_ in zip(("o", "lse"), got, plain, truth):
        good, e = _within_rule(g_, p_, t_)
        errs[name] = e
        ok &= good and bool(torch.isfinite(g_.float()).all())
    return ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["wgmma", "sm80"])
@pytest.mark.parametrize("fam", FWD_FAMILIES, ids=_FWD_IDS)
def test_flash_fwd_variants_match_plain(cuda, fam, variant):
    run, plain, truth, fn = _fwd_family(fam, cuda)
    before = (fn.launches, getattr(fn, f"{variant}_launches"))
    got = run(variant)
    torch.cuda.synchronize()
    assert (fn.launches, getattr(fn, f"{variant}_launches")) == (
        before[0] + 1, before[1] + 1)
    ok, errs = _fwd_within_rules(got, plain, truth)
    assert ok, f"{fam[0]} on {variant}: {errs}"


@pytest.mark.gpu
@pytest.mark.parametrize("fam", FWD_FAMILIES, ids=_FWD_IDS)
def test_flash_fwd_wgmma_is_bit_identical_across_runs(cuda, fam):
    run, _, _, _ = _fwd_family(fam, cuda)
    first, second = run("wgmma"), run("wgmma")
    for name, a, b_ in zip(("o", "lse"), first, second):
        assert torch.equal(a, b_), f"{fam[0]}: {name} differs between runs"


@pytest.mark.gpu
@pytest.mark.parametrize("fam", FWD_FAMILIES, ids=_FWD_IDS)
def test_flash_fwd_planted_faults_are_refused(cuda, fam):
    """The last 64-row kv tile dropped, and (where the call has one) the
    bias left out: each must fail the rule on both variants."""
    run, plain, truth, _ = _fwd_family(fam, cuda)
    faults = ["drop_last_kv_tile"] + (["drop_bias"] if fam[-1] else [])
    for variant in ("wgmma", "sm80"):
        for fault in faults:
            ok, errs = _fwd_within_rules(run(variant, fault), plain, truth)
            assert not ok, f"{fam[0]} {variant}: {fault} passed: {errs}"


# (name, layout, b, h, h_kv, sq, sk, d, causal, lens, hb): each dbias call
# at its widths, the batch cut
DBIAS_FAMILIES = [
    ("t5_encoder_bias", "bhsd", 2, 12, 12, 512, 512, 64, False, None, 12),
    ("t5_encoder_bias_padded", "bhsd", 2, 12, 12, 512, 512, 64, False,
     [300, 512], 12),
    ("t5_decoder_bias_114", "bhsd", 4, 12, 12, 114, 114, 64, True, None, 12),
    ("bshd_bias_hb1", "bshd", 2, 16, 16, 512, 512, 64, False, [512, 77], 1),
    ("gqa_d128_bias_lens", "bhsd", 2, 8, 4, 300, 300, 128, True, [300, 77],
     8),
]
_DBIAS_IDS = [f[0] for f in DBIAS_FAMILIES]


def _dbias_family(fam, dev):
    """(run, truth, delta): ``run(variant, fault, delta)`` calls the dbias
    wrapper on the plain forward's o and lse; truth is the fp32 plain
    version's dbias; delta the dQ kernel's, as the dispatch hands it."""
    _, layout, b, h, hkv, sq, sk, d, causal, lens, hb = fam
    seed = sq + sk + hb
    lens_t = None
    if lens is not None:
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    if layout == "bhsd":
        q, k, v, do = _flat_inputs(b, h, hkv, sq, sk, d, dev, seed, True)
        if lens_t is not None:
            lens_t = lens_t.repeat_interleave(h)
        fwd, bwd, dq = amod.flash_fwd, amod.flash_bwd, \
            amod.flash_bwd_flat_dq_cuda
    else:
        q, k, v, do = _bshd_inputs(b, sq, sk, h, hkv, d, dev, seed, sq == sk)
        fwd, bwd, dq = amod.flash_fwd_bshd, amod.flash_bwd_bshd, \
            amod.flash_bwd_bshd_dq_cuda
    bias = _bias_input(hb, sq, sk, dev, seed=seed)
    kw = dict(scale=d ** -0.5, causal=causal, kv_lens=lens_t, bias=bias)
    o, lse = fwd(q, k, v, impl="torch", **kw)
    truth = bwd(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                impl="torch", **kw)[3]
    _, delta = dq(q, k, v, o, lse, do, **kw)

    def run(variant, fault=None, delta=delta):
        return amod.flash_bwd_dbias_cuda(
            q, k, v, o, lse, do, bias, scale=kw["scale"], causal=causal,
            kv_lens=lens_t, layout=layout, delta=delta, variant=variant,
            planted_fault=fault)
    return run, truth, delta


def _dbias_err(got, truth):
    return ((got - truth).norm() / truth.norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["wgmma", "sm80"])
@pytest.mark.parametrize("fam", DBIAS_FAMILIES, ids=_DBIAS_IDS)
def test_flash_dbias_variants_match_plain(cuda, fam, variant):
    run, truth, _ = _dbias_family(fam, cuda)
    fn = amod.flash_bwd_dbias_cuda
    before = (fn.launches, getattr(fn, f"{variant}_launches"))
    got = run(variant)
    torch.cuda.synchronize()
    assert (fn.launches, getattr(fn, f"{variant}_launches")) == (
        before[0] + 1, before[1] + 1)
    _check_dbias(got, truth)


@pytest.mark.gpu
@pytest.mark.parametrize("fam", DBIAS_FAMILIES, ids=_DBIAS_IDS)
def test_flash_dbias_wgmma_is_bit_identical_across_runs(cuda, fam):
    """The split fixed-order sums: two runs give the same bits, and the
    wrapper's own delta (computed once by the plain version when none is
    given) the same dbias as the dQ kernel's within the rule."""
    run, truth, _ = _dbias_family(fam, cuda)
    first, second = run("wgmma"), run("wgmma")
    assert torch.equal(first, second), f"{fam[0]}: dbias differs"
    _check_dbias(run("wgmma", delta=None), truth)


@pytest.mark.gpu
@pytest.mark.parametrize("fam", DBIAS_FAMILIES, ids=_DBIAS_IDS)
def test_flash_dbias_planted_faults_are_refused(cuda, fam):
    """The last group of sharing rows dropped, and the bias left out of p:
    each must fail the 1e-3 rule on both variants."""
    run, truth, _ = _dbias_family(fam, cuda)
    for variant in ("wgmma", "sm80"):
        for fault in amod.DBIAS_FAULTS:
            err = _dbias_err(run(variant, fault), truth)
            assert err > DBIAS_TOL, f"{fam[0]} {variant}: {fault} passed"


# --- the layer-norm and softmax kernels ----------------------------------------

def _close_to_largest(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    return err <= rel * want.float().abs().max().item() + 1e-30, err


def _ln_case(rows, hidden, dtype, wdtype, affine, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((rows, hidden), generator=g, device=dev) * 2 + 0.5)
    dy = torch.randn((rows, hidden), generator=g, device=dev)
    w = 1 + 0.3 * torch.randn((hidden,), generator=g, device=dev)
    b = 0.2 * torch.randn((hidden,), generator=g, device=dev)
    return (x.to(dtype), dy.to(dtype),
            w.to(wdtype) if "w" in affine else None,
            b.to(wdtype) if "b" in affine else None)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,hidden", [(64, 1024), (37, 1000), (5, 768),
                                         (9, 4096), (3, 33), (600, 64)])
@pytest.mark.parametrize("dtype,wdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("rms,affine", [(False, "wb"), (False, "w"),
                                        (False, ""), (True, "w"),
                                        (True, "")])
def test_layer_norm_kernels_match_plain(cuda, rows, hidden, dtype, wdtype,
                                        rms, affine):
    _check_ln(cuda, rows, hidden, dtype, wdtype, rms, affine)


def _check_ln(cuda, rows, hidden, dtype, wdtype, rms, affine, wide=False):
    """Both kernels (``layer_norm.cu``'s, or with ``wide``
    ``layer_norm_wide.cu``'s) on one call against the plain version by the
    rules of the module docstring (the fp16 rule for fp16 x), one launch
    each and none of the other pair's."""
    x, dy, w, b = _ln_case(rows, hidden, dtype, wdtype, affine, cuda,
                           seed=rows + hidden)
    f32 = lambda t: None if t is None else t.float()  # noqa: E731
    pairs = [(lnmod.ln_fwd_cuda, lnmod.ln_bwd_cuda),
             (lnmod.ln_fwd_wide_cuda, lnmod.ln_bwd_wide_cuda)]
    fwd, bwd = pairs[wide]
    before = [f.launches for pair in pairs for f in pair]
    y, mean, rstd = fwd(x, w, b, 1e-5, rms)
    dx, dw, db = bwd(dy, x, mean, rstd, w, rms)
    torch.cuda.synchronize()
    want = [0, 0, 1, 1] if wide else [1, 1, 0, 0]
    assert [f.launches - n for f, n in zip(
        [f for pair in pairs for f in pair], before)] == want
    yp, mp, rp = lnmod._torch_fwd(x, w, b, 1e-5, rms)
    dxp, dwp, dbp = lnmod._torch_bwd(dy, x, mp, rp, w, rms)
    yt, mt, rt = lnmod._torch_fwd(x.float(), f32(w), f32(b), 1e-5, rms)
    dxt, dwt, dbt = lnmod._torch_bwd(dy.float(), x.float(), mt, rt, f32(w),
                                     rms)
    assert y.dtype == dtype and dx.dtype == dtype
    for name, got, want_ in (("mean", mean, mt), ("rstd", rstd, rt)):
        ok, err = _close_to_largest(got, want_, 1e-5)
        assert ok, f"{name}: {err}"
    rule = {torch.bfloat16: _within_rule, torch.float16: _f16_rule}
    for name, got, plain, truth in (("y", y, yp, yt),
                                    ("dx", dx, dxp, dxt)):
        if dtype in rule:
            ok, errs = rule[dtype](got, plain, truth)
        else:
            ok, errs = _close_to_largest(got, plain, 1e-5)
        assert ok, f"{name}: kernel/plain errors {errs}"
    if w is None:
        assert dw is None and db is None
        return
    assert dw.dtype == wdtype and db.dtype == wdtype
    rel = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(
        wdtype, 1e-5)
    for name, got, want_ in (("dgamma", dw, dwt), ("dbeta", db, dbt)):
        ok, err = _close_to_largest(got, want_, rel)
        assert ok, f"{name}: {err}"


# every launch shape of the backward's row kernel, by dtype: (16-byte
# chunks a thread, warps a row) -> a hidden size that takes it
LN_BWD_SHAPES = {
    torch.bfloat16: {(1, 1): 64, (1, 2): 384, (1, 3): 768, (1, 4): 1000,
                     (1, 6): 1536, (1, 8): 2048, (2, 6): 3072,
                     (2, 8): 4096},
    torch.float32: {(1, 1): 100, (1, 2): 256, (1, 3): 384, (1, 4): 512,
                    (1, 6): 768, (1, 8): 1024, (2, 6): 1536, (2, 8): 2048,
                    (4, 6): 3000, (4, 8): 4096}}
_LN_BWD_CASES = [(dtype, hidden) for dtype, shapes in LN_BWD_SHAPES.items()
                 for hidden in shapes.values()] + [(torch.bfloat16, 1024),
                                                   (torch.bfloat16, 33)]


@pytest.mark.gpu
def test_layer_norm_bwd_launch_shapes(cuda):
    """The row kernel's shape from the hidden size: at most 16 elements a
    thread, the fewest warps that cover the row — 768 in bf16 exactly (3
    warps of one chunk a lane), 1024 on 4, 4096 on 8 of two chunks — and
    as many whole rows as fit in 16 warps a CTA at one chunk a thread (8
    warps at more)."""
    for dtype, shapes in LN_BWD_SHAPES.items():
        for shape, hidden in shapes.items():
            c, w, threads = lnmod.bwd_launch_shape(hidden, dtype)
            assert (c, w) == shape, (dtype, hidden)
            cta_warps = 16 if c == 1 else 8
            assert threads == 32 * w * max(1, cta_warps // w)
    assert lnmod.bwd_launch_shape(1024, torch.bfloat16)[:2] == (1, 4)
    assert lnmod.bwd_launch_shape(33, torch.bfloat16)[:2] == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hidden", _LN_BWD_CASES,
                         ids=[f"{str(d)[6:]}-{h}" for d, h in _LN_BWD_CASES])
@pytest.mark.parametrize("rms,affine", [(False, "wb"), (True, "w"),
                                        (False, ""), (True, "")])
@pytest.mark.parametrize("rows", [7, 3001])
def test_layer_norm_bwd_every_launch_shape_matches_plain(cuda, dtype, hidden,
                                                         rms, affine, rows):
    """Every (chunks, warps) shape, RMSNorm and no affine, at 7 rows (one
    row a CTA) and 3001 (12 a CTA: the cp.async ring wraps)."""
    _check_ln(cuda, rows, hidden, dtype, dtype, rms, affine)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,hidden", [(20480, 1024), (14592, 768),
                                         (1000, 1000), (16384, 1024),
                                         (65536, 768)])
def test_layer_norm_param_grads_are_bit_reproducible(cuda, rows, hidden):
    x, dy, w, b = _ln_case(rows, hidden, torch.bfloat16, torch.bfloat16,
                           "wb", cuda, seed=3)
    y, mean, rstd = lnmod.ln_fwd_cuda(x, w, b, 1e-5, False)
    first = lnmod.ln_bwd_cuda(dy, x, mean, rstd, w, False)
    second = lnmod.ln_bwd_cuda(dy, x, mean, rstd, w, False)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


# the forward's planned shapes: each (chunks, warps) of LN_BWD_SHAPES at 7
# rows (one row a CTA) and 3001 (resident CTAs walking their rows, the
# next row's loads in flight), and the GPT train call
_LN_FWD_CASES = [(dtype, hidden, rows)
                 for dtype, shapes in LN_BWD_SHAPES.items()
                 for hidden in shapes.values() for rows in (7, 3001)] + [
    (torch.bfloat16, 1024, 20480), (torch.bfloat16, 768, 14592),
    (torch.bfloat16, 1024, 16), (torch.bfloat16, 1000, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hidden,rows", _LN_FWD_CASES,
                         ids=[f"{str(d)[6:]}-{h}-{r}"
                              for d, h, r in _LN_FWD_CASES])
@pytest.mark.parametrize("rms,affine,wdtype", [
    (False, "wb", None), (False, "w", torch.float32), (False, "", None),
    (True, "w", None)])
def test_layer_norm_fwd_every_plan_matches_plain(cuda, dtype, hidden, rows,
                                                 rms, affine, wdtype):
    """The forward on each planned shape against the plain version (the
    module docstring's rules: y by the bf16 rule, mean and rstd within
    1e-5 of the largest), y, mean and rstd bit-identical across two runs,
    one launch a call."""
    x, _, w, b = _ln_case(rows, hidden, dtype, wdtype or dtype, affine,
                          cuda, seed=rows + hidden)
    f32 = lambda t: None if t is None else t.float()  # noqa: E731
    before = lnmod.ln_fwd_cuda.launches
    got = lnmod.ln_fwd_cuda(x, w, b, 1e-5, rms)
    again = lnmod.ln_fwd_cuda(x, w, b, 1e-5, rms)
    assert lnmod.ln_fwd_cuda.launches == before + 2
    torch.cuda.synchronize()
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    y, mean, rstd = got
    yp, _, _ = lnmod._torch_fwd(x, w, b, 1e-5, rms)
    yt, mt, rt = lnmod._torch_fwd(x.float(), f32(w), f32(b), 1e-5, rms)
    for name, g, want in (("mean", mean, mt), ("rstd", rstd, rt)):
        ok, err = _close_to_largest(g, want, 1e-5)
        assert ok, f"{name}: {err}"
    if dtype == torch.bfloat16:
        ok, errs = _within_rule(y, yp, yt)
    else:
        ok, errs = _close_to_largest(y, yp, 1e-5)
    assert ok, f"y: {errs}"


@pytest.mark.gpu
def test_layer_norm_fwd_plan_mirrors_the_backward_shape(cuda):
    """The forward plan's row shape is the one ``apex_ln_bwd_shape`` gives,
    and the entry refuses a plan that does not cover the row."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.matmul import _sm_count

    sms = _sm_count(torch.cuda.current_device())
    for dtype, shapes in LN_BWD_SHAPES.items():
        for shape, hidden in shapes.items():
            plan = lnmod._fwd_plan(4096, hidden, dtype, sms)
            assert (plan.chunks, plan.warps) == shape
            assert (plan.chunks, plan.warps) == lnmod.bwd_launch_shape(
                hidden, dtype)[:2]
    x = torch.ones((4, 1024), device=cuda, dtype=torch.bfloat16)
    y, m, r = (torch.empty_like(x), torch.empty((4, 1), device=cuda),
               torch.empty((4, 1), device=cuda))
    lib = _build.library()
    for plan in ((1, 2, 1, 4, 16), (1, 4, 0, 4, 32), (3, 4, 1, 4, 32),
                 (1, 4, 1, 4, 0), (1, 4, 16, 4, 512)):
        rc = lib.apex_ln_fwd(x.data_ptr(), None, None, y.data_ptr(),
                             m.data_ptr(), r.data_ptr(), 1, 0, 0, 0, 4,
                             1024, 1e-5, *plan,
                             torch.cuda.current_stream().cuda_stream)
        assert rc != 0, plan


@pytest.mark.gpu
def test_fused_layer_norm_autograd_runs_the_kernels(cuda):
    """The op on a CUDA tensor: one forward and one backward launch, and
    the same values as ``impl="torch"`` within the bf16 rule."""
    x, dy, w, b = _ln_case(48, 1024, torch.bfloat16, torch.bfloat16, "wb",
                           cuda, seed=4)
    out = []
    for impl in ("auto", "torch"):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        before = (lnmod.ln_fwd_cuda.launches, lnmod.ln_bwd_cuda.launches)
        y = lnmod.fused_layer_norm(*leaves, impl=impl)
        y.backward(dy)
        n = (lnmod.ln_fwd_cuda.launches - before[0],
             lnmod.ln_bwd_cuda.launches - before[1])
        assert n == ((1, 1) if impl == "auto" else (0, 0))
        out.append([y.detach()] + [t.grad for t in leaves])
    for a, c in zip(*out):
        err = (a.float() - c.float()).abs().max().item()
        assert err <= 2.0 ** -7 * c.float().abs().max().item()


def _within_softmax_rule(got, plain, truth):
    """chip_smoke.py's SOFTMAX_SLACK rule: max abs error <= 2x the bf16
    plain version's + 1e-3 of the truth's largest entry, and relative norm
    error <= 2x the plain version's + 1e-3."""
    t = truth.float()
    d_k, d_p = got.float() - t, plain.float() - t
    norm = t.norm().item() + 1e-30
    errs = (d_k.abs().max().item(), d_p.abs().max().item(),
            d_k.norm().item() / norm, d_p.norm().item() / norm)
    ok = (errs[0] <= 2 * errs[1] + 1e-3 * t.abs().max().item()
          and errs[2] <= 2 * errs[3] + 1e-3)
    return ok, errs


def _softmax_case(shape, mask_kind, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 4).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    b, sq, sk = shape[0], shape[-2], shape[-1]
    mask = None
    if mask_kind == "key":  # (b, 1, 1, sk), batch row 1 fully masked
        lens = torch.tensor([sk * 3 // 4, 0] + [sk] * (b - 2), device=dev)
        mask = (torch.arange(sk, device=dev)[None, :]
                >= lens[:, None])[:, None, None, :]
    elif mask_kind == "full":  # (b, 1, sq, sk) with one fully masked row
        mask = torch.rand((b, 1, sq, sk), generator=g, device=dev) < 0.3
        mask[0, 0, 1] = True
    return x, dy, mask


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mask_kind", [
    ((2, 3, 16, 128), "key"), ((2, 3, 16, 512), "full"),
    ((2, 2, 114, 114), "causal"), ((3, 2, 16, 114), "key"),
    ((4, 2, 64, 1024), "causal"), ((2, 2, 8, 2048), "full"),
    ((2, 2, 4, 2050), "key"), ((1, 2, 40, 3000), "causal"),
    ((2, 2, 16, 100), None), ((2, 1, 4, 5000), None),
    ((2, 2, 3, 16, 128), "key")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_softmax_kernels_match_plain(cuda, shape, mask_kind, dtype):
    x, dy, mask = _softmax_case(shape, mask_kind, dtype, cuda,
                                seed=shape[-1])
    causal = mask_kind == "causal"
    scale = 0.125
    before = (smxmod.softmax_fwd_cuda.launches,
              smxmod.softmax_bwd_cuda.launches)
    y = smxmod.softmax_fwd_cuda(x, mask, scale, causal)
    yp = smxmod._torch_fwd(x, mask, scale, causal)
    yt = smxmod._torch_fwd(x.float(), mask, scale, causal)
    dx = smxmod.softmax_bwd_cuda(dy, yp, scale)
    # told the forward's mask, as the autograd core calls it
    dxm = smxmod.softmax_bwd_cuda(dy, yp, scale, causal=causal, mask=mask)
    dxp = smxmod._torch_bwd(dy, yp, scale)
    dxt = smxmod._torch_bwd(dy.float(), yp.float(), scale)
    torch.cuda.synchronize()
    assert (smxmod.softmax_fwd_cuda.launches,
            smxmod.softmax_bwd_cuda.launches) == (before[0] + 1,
                                                  before[1] + 2)
    if dtype == torch.bfloat16:
        for name, got, plain, truth in (("y", y, yp, yt),
                                        ("dx", dx, dxp, dxt),
                                        ("dx masked", dxm, dxp, dxt)):
            ok, errs = _within_softmax_rule(got, plain, truth)
            assert ok, f"{name}: kernel/plain errors {errs}"
        # the rule refuses planted faults: 10% off, the dropped - sum term
        for name, bad, plain, truth in (
                ("y", y.float() * 1.1, yp, yt),
                ("dx", dx.float() * 1.1, dxp, dxt),
                ("dx", scale * yp.float() * dy.float(), dxp, dxt)):
            assert not _within_softmax_rule(bad.to(dtype), plain, truth)[0], \
                f"planted fault in {name} passed the rule"
    else:
        for name, got, want in (("y", y, yp), ("dx", dx, dxp),
                                ("dx masked", dxm, dxp)):
            ok, err = _close_to_largest(got, want, 1e-5)
            assert ok, f"{name}: {err}"
    if mask_kind in ("key", "full"):  # fully masked rows: uniform
        full = torch.broadcast_to(mask, shape).all(-1)
        assert full.any()
        sk = shape[-1]
        torch.testing.assert_close(y[full].float(),
                                   torch.full_like(y[full].float(), 1 / sk),
                                   rtol=1e-2, atol=0)


@pytest.mark.gpu
def test_softmax_ops_autograd_run_the_kernels(cuda):
    """Both ops on a CUDA tensor: one forward and one backward launch each,
    and the same values as ``impl="torch"`` under the bf16 rule."""
    x, dy, mask = _softmax_case((2, 4, 64, 256), "key", torch.bfloat16,
                                cuda, seed=1)
    for op in (lambda t, impl: smxmod.scaled_masked_softmax(
                   t, mask, 0.3, impl=impl),
               lambda t, impl: smxmod.scaled_upper_triang_masked_softmax(
                   t.reshape(8, 64, 256)[:, :, :64].contiguous(), 0.3,
                   impl=impl)):
        out = []
        for impl in ("auto", "torch"):
            leaf = x.clone().requires_grad_()
            before = (smxmod.softmax_fwd_cuda.launches,
                      smxmod.softmax_bwd_cuda.launches)
            y = op(leaf, impl)
            y.backward(torch.ones_like(y) * 0.5 + dy.reshape(-1)[
                :y.numel()].reshape(y.shape))
            n = (smxmod.softmax_fwd_cuda.launches - before[0],
                 smxmod.softmax_bwd_cuda.launches - before[1])
            assert n == ((1, 1) if impl == "auto" else (0, 0))
            out.append((y.detach().float(), leaf.grad.float()))
        for a, c in zip(*out):
            assert (a - c).abs().max().item() <= 2e-2 * c.abs().max().item()


def _check_softmax_fwd(x, mask, causal, scale=0.125):
    """softmax_fwd with the masked entries of x poisoned (NaN): the rule
    against the plain version (fp32: 1e-5 of the largest), masked entries
    exactly 0 on rows with a live entry, fully masked rows uniform."""
    shape, sk = x.shape, x.shape[-1]
    if causal:
        dead = ~torch.ones(shape[-2:], dtype=torch.bool,
                           device=x.device).tril()
    else:
        dead = torch.broadcast_to(mask, shape)
    x = x.masked_fill(dead, float("nan"))
    y = smxmod.softmax_fwd_cuda(x, mask, scale, causal)
    yp = smxmod._torch_fwd(x, mask, scale, causal)
    yt = smxmod._torch_fwd(x.float(), mask, scale, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    if x.dtype == torch.bfloat16:
        ok, errs = _within_softmax_rule(y, yp, yt)
        assert ok, f"kernel/plain errors {errs}"
    else:
        ok, err = _close_to_largest(y, yp, 1e-5)
        assert ok, err
    dead = torch.broadcast_to(dead, shape)
    full = dead.all(-1)
    live_rows = ~full
    assert (y.float()[dead & live_rows[..., None]] == 0).all()
    if full.any():
        torch.testing.assert_close(y[full].float(),
                                   torch.full_like(y[full].float(), 1 / sk),
                                   rtol=1e-2, atol=0)
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2, 114, 114), (2, 2, 64, 1024),
                                   (1, 3, 130, 200), (1, 2, 257, 257),
                                   (2, 1, 512, 512), (1, 1, 33, 2048),
                                   (1, 1, 7, 60)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_softmax_fwd_causal_skip(cuda, shape, dtype):
    """The causal forward never reads past the diagonal (those entries are
    NaN here) and gets every row right: the first (one live entry, y 1),
    the last, rows whose diagonal falls inside a chunk, a tail sk (114,
    257) and sq < sk."""
    x, _, _ = _softmax_case(shape, None, dtype, cuda, seed=shape[-1])
    y = _check_softmax_fwd(x, None, True)
    assert (y[..., 0, 0].float() == 1).all()
    sq, sk = shape[-2:]
    last = y[..., sq - 1, :].float()
    torch.testing.assert_close(last.sum(-1), torch.ones_like(last[..., 0]),
                               rtol=2e-2, atol=0)
    assert (last[..., sq:] == 0).all()


def _skip_mask(kind, shape, dev, seed):
    """Masks (True = masked) for the forward's load skipping: "chunks",
    a (b, 1, 1, sk) key mask with whole masked chunks in the middle and at
    the end and one fully masked batch row; "holes", a full-shape mask
    with interior holes and two fully masked rows; "strided", a key mask
    read through a key stride of 2; "tril", T5's (1, 1, sq, sk) triangle
    whose rows start unaligned."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, sq, sk = shape
    if kind == "chunks":
        keys = torch.arange(sk, device=dev)
        m = (keys >= sk * 3 // 4) | ((keys >= 64) & (keys < 192))
        m = m[None].repeat(b, 1)
        m[1] = True
        return m[:, None, None, :]
    if kind == "holes":
        m = torch.rand(shape, generator=g, device=dev) < 0.5
        m[0, 0, 1] = True
        m[-1, -1, -1] = True
        return m
    if kind == "strided":
        wide = torch.rand((b, 1, 1, 2 * sk), generator=g, device=dev) < 0.4
        wide[0, ..., :2 * sk // 3] = True
        return wide[..., ::2]
    return ~torch.ones((sq, sk), dtype=torch.bool,
                       device=dev).tril()[None, None]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", [
    ("chunks", (4, 2, 16, 512)), ("chunks", (3, 2, 8, 1024)),
    ("chunks", (3, 2, 8, 114)), ("chunks", (3, 1, 5, 114)),
    ("holes", (2, 3, 16, 512)),
    ("holes", (2, 2, 9, 200)), ("strided", (3, 2, 8, 512)),
    ("tril", (2, 3, 114, 114))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_softmax_fwd_mask_skip(cuda, kind, shape, dtype):
    """The masked forward never reads a masked entry's x (NaN here): whole
    masked chunks, interior holes, fully masked rows (uniform), a strided
    key mask and unaligned mask rows."""
    x, _, _ = _softmax_case(shape, None, dtype, cuda, seed=shape[-1] + 1)
    mask = _skip_mask(kind, shape, cuda, seed=shape[-1])
    _check_softmax_fwd(x, mask, False)


def _check_softmax_bwd(x, dy, mask, causal, scale=0.125):
    """softmax_bwd told the forward's mask, with NaN in dy at the masked
    entries of every row with a live entry: dx finite and exactly 0 there,
    the same bits across two runs and as on clean dy, within the rule of
    the plain version on clean dy (fp32: 1e-5 of the largest); in bf16
    two planted faults refused: the guard ignored (the fully masked rows'
    dx zeroed, where the call has such rows) and the masked entries'
    dy * y counted (NaN on the poisoned dy)."""
    shape = x.shape
    if causal:
        dead = ~torch.ones(shape[-2:], dtype=torch.bool,
                           device=x.device).tril()
    else:
        dead = mask
    dead = torch.broadcast_to(dead, shape)
    full = dead.all(-1)
    poison = dead & ~full[..., None]
    y = smxmod.softmax_fwd_cuda(x, mask, scale, causal)
    bad = dy.masked_fill(poison, float("nan"))
    kw = dict(causal=causal, mask=mask)
    dx = smxmod.softmax_bwd_cuda(bad, y, scale, **kw)
    again = smxmod.softmax_bwd_cuda(bad, y, scale, **kw)
    clean = smxmod.softmax_bwd_cuda(dy, y, scale, **kw)
    dxp = smxmod._torch_bwd(dy, y, scale)
    dxt = smxmod._torch_bwd(dy.float(), y.float(), scale)
    torch.cuda.synchronize()
    assert torch.isfinite(dx).all()
    assert torch.equal(dx, again) and torch.equal(dx, clean)
    assert (dx.float()[poison] == 0).all()
    if x.dtype == torch.bfloat16:
        ok, errs = _within_softmax_rule(dx, dxp, dxt)
        assert ok, f"kernel/plain errors {errs}"
        faults = {"masked dy * y counted": smxmod._torch_bwd(bad, y, scale)}
        if full.any():
            faults["guard ignored"] = dx.masked_fill(full[..., None], 0)
        for name, wrong in faults.items():
            assert not _within_softmax_rule(wrong, dxp, dxt)[0], \
                f"planted fault '{name}' passed the rule"
    else:
        ok, err = _close_to_largest(dx, dxp, 1e-5)
        assert ok, err
    return y, dx


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", [
    ("causal", (1, 2, 114, 114)), ("causal", (2, 2, 64, 1024)),
    ("causal", (1, 3, 130, 200)), ("causal", (1, 2, 257, 257)),
    ("causal", (2, 1, 512, 512)), ("causal", (1, 1, 33, 2048)),
    ("causal", (1, 1, 7, 60)),
    ("chunks", (4, 2, 16, 512)), ("chunks", (3, 2, 8, 1024)),
    ("chunks", (3, 2, 8, 114)), ("chunks", (3, 1, 5, 114)),
    ("holes", (2, 3, 16, 512)),
    ("holes", (2, 2, 9, 200)), ("strided", (3, 2, 8, 512)),
    ("tril", (2, 3, 114, 114))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_softmax_bwd_skip(cuda, kind, shape, dtype):
    """The backward told the forward's mask never lets a masked entry's dy
    (NaN here) reach a row with a live entry, and gets every row right:
    the causal forward's rows (the first, rows whose diagonal falls inside
    a chunk, a tail sk, sq < sk) and the masks of the forward's skip test
    (whole masked chunks, interior holes, fully masked rows, read whole, a
    strided key mask, T5's unaligned triangle rows)."""
    x, dy, _ = _softmax_case(shape, None, dtype, cuda, seed=shape[-1] + 2)
    mask = None if kind == "causal" else _skip_mask(kind, shape, cuda,
                                                    seed=shape[-1])
    y, dx = _check_softmax_bwd(x, dy, mask, kind == "causal")
    if kind in ("chunks", "holes"):  # fully masked rows: read whole
        full = torch.broadcast_to(mask, shape).all(-1)
        assert full.any()
        want = smxmod._torch_bwd(dy, y, 0.125)[full].float()
        got = dx[full].float()
        assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("sk", [114, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_softmax_bwd_reads_pathological_rows_whole(cuda, sk, dtype):
    """A row whose live scaled scores all lie 16 above MASK_FILL: its
    masked y is about e^-16 of a live one, not 0, so the guard sends it
    down the whole-row read. Its masked entries' dx are then not 0, and
    the row is within the rule of the plain version."""
    shape = (2, 2, 8, sk)
    x, dy, _ = _softmax_case(shape, None, dtype, cuda, seed=sk)
    mask = torch.zeros((2, 1, 1, sk), dtype=torch.bool, device=cuda)
    mask[..., sk * 3 // 4:] = True
    x[1, 0, 3] = -79872  # scaled by 0.125: -9984, exact in bf16
    y = smxmod.softmax_fwd_cuda(x, mask, 0.125, False)
    dx = smxmod.softmax_bwd_cuda(dy, y, 0.125, mask=mask)
    dxp = smxmod._torch_bwd(dy, y, 0.125)
    dxt = smxmod._torch_bwd(dy.float(), y.float(), 0.125)
    torch.cuda.synchronize()
    assert (y[1, 0, 3, sk * 3 // 4:] > 0).all()
    assert (y[0, 0, 3, sk * 3 // 4:] == 0).all()
    assert (dx[1, 0, 3, sk * 3 // 4:] != 0).any()
    assert (dx[0, 0, 3, sk * 3 // 4:] == 0).all()
    if dtype == torch.bfloat16:
        ok, errs = _within_softmax_rule(dx, dxp, dxt)
        assert ok, f"kernel/plain errors {errs}"
    else:
        ok, err = _close_to_largest(dx, dxp, 1e-5)
        assert ok, err
    row, prow = dx[1, 0, 3].float(), dxp[1, 0, 3].float()
    assert (row - prow).abs().max() <= 2e-2 * prow.abs().max()


@pytest.mark.gpu
def test_norm_and_softmax_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((4, 5000), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="impl='torch'"):
        lnmod.fused_layer_norm(x)
    with pytest.raises(ValueError, match="impl='torch'"):
        lnmod.fused_rms_norm(x[:, :64].double())
    with pytest.raises(ValueError, match="impl='torch'"):
        lnmod.fused_layer_norm(x[:, :64].half(), torch.ones(
            64, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError, match="ROADMAP queue 2"):
        smxmod.scaled_masked_softmax(x.half(), None)
    with pytest.raises(ValueError, match="causal takes no mask"):
        smxmod.softmax_fwd_cuda(x, x > 0, 1.0, True)
    with pytest.raises(ValueError, match="causal takes no mask"):
        smxmod.softmax_bwd_cuda(x, x, 1.0, causal=True, mask=x > 0)
    assert lnmod.fused_layer_norm(x, impl="torch").shape == x.shape


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["gpt", "bert", "t5"])
def test_softmax_route_step_kernel_path_matches_plain_path(cuda, which):
    """A small bf16 model on its softmax route (GPT causal; BERT with an
    interior pad mask; T5 learned, padded): loss within 1e-4 relative and
    each gradient leaf within 5e-2 relative norm of the plain path on the
    same weights (chip_smoke.py's bounds at full width). The k window of a
    qkv bias is left out (its exact gradient is 0)."""
    from apex_tpu_torch.models import bert as B, gpt as G, t5 as T

    gen = torch.Generator(device=cuda).manual_seed(1)
    rand = lambda *s: torch.randint(0, 512, s, generator=gen,  # noqa: E731
                                    device=cuda)
    if which == "gpt":
        model = G.GPTModel(G.GPTConfig(
            vocab_size=512, max_seq_len=256, hidden_size=256, num_layers=2,
            num_heads=2, remat=False, dtype=torch.bfloat16))
        tok, tgt = rand(4, 256), rand(4, 256)
        run = lambda p, impl: model.loss_fn(p, tok, tgt,  # noqa: E731
                                            impl=impl)
    elif which == "bert":
        model = B.BertModel(B.BertConfig(
            vocab_size=512, max_seq_len=128, hidden_size=256, num_layers=2,
            num_heads=4, dtype=torch.bfloat16))
        tok, tgt = rand(4, 128), rand(4, 128)
        pad = torch.zeros((4, 128), dtype=torch.bool, device=cuda)
        pad[0, 100:] = True
        pad[1, 10:20] = True
        lmask = (~pad).float()
        run = lambda p, impl: model.mlm_loss(  # noqa: E731
            p, tok, tgt, lmask, None, pad, impl=impl)
    else:
        model = T.EncoderDecoderModel(T.T5Config(
            vocab_size=512, max_seq_len=128, hidden_size=256,
            num_encoder_layers=1, num_decoder_layers=1, num_heads=4,
            dtype=torch.bfloat16))
        enc, dec, tgt = rand(4, 128), rand(4, 114), rand(4, 114)
        lens = torch.tensor([128, 100, 77, 128], device=cuda)
        run = lambda p, impl: model.loss_fn(  # noqa: E731
            p, enc, dec, tgt, enc_pad_lens=lens, impl=impl)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    leaves = G.param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    H = model.config.hidden_size
    out = []
    for impl in ("auto", "torch"):
        loss = run(params, impl)
        loss.backward()
        grads = []
        for t in leaves:
            if t.grad is None:
                continue
            gr = t.grad.float()
            if t.shape == (3 * H,):  # a packed qkv bias: drop the k window
                gr = torch.cat([gr[:H], gr[2 * H:]])
            grads.append(gr)
            t.grad = None
        out.append((loss.item(), grads))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, c in zip(gk, gp):
        assert (a - c).norm() <= 5e-2 * c.norm()


# --- the matmul_bias_act kernel -----------------------------------------------

def _mm_operands(M, K, N, layout, dtype, dev, seed, bias, pad=0):
    """x (M, K) and w (K, N) in ``layout`` — "fwd" (x K-, w K-contiguous:
    ``weight.t()``), "dgrad" (x K-, w N-contiguous), "wgrad" (x M-, w
    N-contiguous: ``dy.t()``), "am_bk" (x M-, w K-contiguous) — as views,
    each row ``pad`` elements wider than it needs (a row stride that is no
    multiple of 8 when pad is odd); bias (N,) or None. x is scaled by
    1/sqrt(K) so the pre-activations sit near unit scale (a saturated
    sigmoid would hide a fault)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dtype)

    xs = 1.0 / max(K, 1) ** 0.5
    x_k = layout in ("fwd", "dgrad")
    w_k = layout in ("fwd", "am_bk")
    x = (rnd(M, K + pad, scale=xs)[:, :K] if x_k
         else rnd(K, M + pad, scale=xs)[:, :M].t())
    w = rnd(N, K + pad)[:, :K].t() if w_k else rnd(K, N + pad)[:, :N]
    return x, w, rnd(N, scale=0.5) if bias else None


def _mm_rule(got, plain, truth):
    t = truth.float()
    err = (got.float() - t).abs().max().item()
    err_plain = (plain.float() - t).abs().max().item()
    return err <= 2 * err_plain + 1e-3 * t.abs().max().item(), err


def _mm_check(x, w, b, act, out_dtype=None, variant=None):
    """The kernel (the planned variant, or ``variant`` through the private
    launcher) against the plain version by the rule, both planted faults
    refused; the call counted once, under its variant."""
    fn = mmmod.matmul_bias_act_cuda
    want = variant or mmmod._plan(x, w, b, act).variant
    before = (fn.launches, getattr(fn, f"{want}_launches"))
    y = mmmod._launch(x, w, b, act, out_dtype, variant)
    torch.cuda.synchronize()
    assert (fn.launches, getattr(fn, f"{want}_launches")) == (
        before[0] + 1, before[1] + 1)
    assert y.shape == (x.shape[0], w.shape[1]) and y.is_contiguous()
    assert y.dtype == (out_dtype or x.dtype)
    plain = mmmod._torch_matmul_bias_act(x, w, b, act, out_dtype)
    if x.dtype == torch.float32:  # a bf16 output: one rounding apart
        ok, err = _close_to_largest(
            y, plain, 1e-5 if y.dtype == torch.float32 else 2.0 ** -8)
        assert ok, err
        return y
    truth = mmmod._torch_matmul_bias_act(
        x.float(), w.float(), None if b is None else b.float(), act,
        torch.float32)
    ok, err = _mm_rule(y, plain, truth)
    assert ok, err
    faults = []
    K = x.shape[1]
    if K > 0:
        kk = (K - 1) // 32 * 32  # the last K block dropped
        faults.append(mmmod._launch(x[:, :kk], w[:kk], b, act, out_dtype,
                                    variant if kk else None))
    if b is not None:
        faults.append(mmmod._launch(x, w, None, act, out_dtype, variant))
    for bad in faults:
        assert not _mm_rule(bad, plain, truth)[0]
    return y


def _mm_aligned(M, K, N, layout, dev, seed, bias):
    """:func:`_mm_operands` with every row padded to a multiple of 8
    elements: operands a tensor map describes, so both variants take
    them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rows(outer, inner, scale=1.0):
        wide = -(-inner // 8) * 8
        return (torch.randn((outer, wide), generator=g, device=dev)
                * scale).bfloat16()[:, :inner]

    xs = 1.0 / K ** 0.5
    x = rows(M, K, xs) if layout in ("fwd", "dgrad") else rows(K, M, xs).t()
    w = rows(N, K).t() if layout in ("fwd", "am_bk") else rows(K, N)
    b = ((torch.randn(N, generator=g, device=dev) * 0.5).bfloat16()
         if bias else None)
    return x, w, b


MM_SHAPES = [(256, 128, 256), (200, 100, 130), (37, 480, 1), (33, 1, 65),
             (129, 257, 3), (1, 64, 300), (300, 40, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", MM_SHAPES)
@pytest.mark.parametrize("act", mmmod.ACTIVATIONS)
@pytest.mark.parametrize("bias", [True, False])
def test_matmul_forward_layout_epilogues_match_plain(cuda, M, K, N, act,
                                                     bias):
    x, w, b = _mm_operands(M, K, N, "fwd", torch.bfloat16, cuda, M + N,
                           bias)
    _mm_check(x, w, b, act)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", MM_SHAPES + [(4, 0, 9)])
@pytest.mark.parametrize("layout", ["fwd", "dgrad", "wgrad", "am_bk"])
@pytest.mark.parametrize("pad", [0, 3])
def test_matmul_layouts_and_ragged_edges_match_plain(cuda, M, K, N, layout,
                                                     pad):
    """Every operand layout without an epilogue, on aligned rows and on
    rows 3 elements wider than needed (a row stride that is no multiple of
    8: the element-by-element loader)."""
    x, w, _ = _mm_operands(M, K, N, layout, torch.bfloat16, cuda, K + pad,
                           False, pad)
    _mm_check(x, w, None, "none")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dgrad", "wgrad", "am_bk"])
def test_matmul_epilogue_on_other_layouts_and_misaligned_base(cuda, layout):
    """A bias and an activation with operands outside the forward layout
    (copied into it), a base off 16 bytes, and an fp32 output."""
    x, w, b = _mm_operands(70, 96, 50, layout, torch.bfloat16, cuda, 7, True)
    _mm_check(x, w, b, "gelu")
    _mm_check(x[1:, 1:], w[1:, 1:], b[1:], "relu", torch.float32)


# K not a multiple of 64 and K < 64, N = 1, M = 1, M and N tails, K = 1
MM_VARIANT_SHAPES = [(256, 128, 256), (200, 100, 136), (96, 40, 72),
                     (130, 480, 1), (1, 320, 300), (129, 257, 3),
                     (300, 1, 70), (333, 1000, 260)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", MM_VARIANT_SHAPES)
@pytest.mark.parametrize("layout", ["fwd", "dgrad", "wgrad", "am_bk"])
@pytest.mark.parametrize("variant", ["wgmma", "sm80"])
def test_matmul_variants_match_plain_in_every_layout(cuda, M, K, N, layout,
                                                     variant):
    """Both variants of the bf16 kernel, through the private launcher, on
    operands both take, in each (A, B) major pair: the rule, and both
    planted faults refused."""
    x, w, _ = _mm_aligned(M, K, N, layout, cuda, M + K + N, False)
    _mm_check(x, w, None, "none", variant=variant)


@pytest.mark.gpu
@pytest.mark.parametrize("act", mmmod.ACTIVATIONS)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("variant", ["wgmma", "sm80"])
def test_matmul_variants_forward_epilogues(cuda, act, bias, variant):
    x, w, b = _mm_aligned(300, 200, 264, "fwd", cuda, 11, bias)
    _mm_check(x, w, b, act, variant=variant)
    _mm_check(x, w, b, act, torch.float32, variant=variant)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,bias,act", [("fwd", True, "gelu"),
                                             ("dgrad", False, "none"),
                                             ("wgrad", False, "none"),
                                             ("am_bk", False, "none")])
def test_matmul_split_k_is_deterministic_and_matches_unsplit(cuda, layout,
                                                             bias, act):
    """A few output tiles over a deep K: the plan splits K; the split
    result is bit-identical across two runs, and it and the unsplit one
    both meet the rule."""
    x, w, b = _mm_aligned(300, 8192, 200, layout, cuda, 5, bias)
    plan = mmmod._plan(x, w, b, act)
    assert plan.variant == "wgmma" and plan.split > 1
    fn = mmmod.matmul_bias_act_cuda
    before = fn.split_launches
    y1 = _mm_check(x, w, b, act)  # and its planted faults, split too
    y2 = mmmod.matmul_bias_act_cuda(x, w, b, act)
    assert fn.split_launches == before + 3 + (b is not None)
    assert torch.equal(y1, y2)
    before = fn.split_launches
    y0 = mmmod._launch(x, w, b, act, split=1)
    assert fn.split_launches == before
    plain = mmmod._torch_matmul_bias_act(x, w, b, act)
    truth = mmmod._torch_matmul_bias_act(
        x.float(), w.float(), None if b is None else b.float(), act,
        torch.float32)
    assert _mm_rule(y0, plain, truth)[0]


@pytest.mark.gpu
def test_matmul_variant_counters(cuda):
    """Each call counted once in ``.launches`` and once under its variant;
    the wgmma variant refuses operands no tensor map describes."""
    fn = mmmod.matmul_bias_act_cuda
    names = ["launches", "wgmma_launches", "sm80_launches", "fp32_launches",
             "split_launches"]

    def counts():
        return [getattr(fn, n) for n in names]

    x, w, _ = _mm_aligned(64, 64, 64, "fwd", cuda, 1, False)
    before = counts()
    mmmod.matmul_bias_act_cuda(x, w)
    mmmod.matmul_bias_act_cuda(x[:, 1:], w[1:])  # a base off 16 bytes
    mmmod.matmul_bias_act_cuda(x.float(), w.float())
    mmmod._launch(x, w, variant="sm80")
    assert [a - c for a, c in zip(counts(), before)] == [4, 1, 2, 1, 0]
    with pytest.raises(ValueError, match="tensor map"):
        mmmod._launch(x[:, 1:], w[1:], variant="wgmma")
    with pytest.raises(ValueError, match="split"):
        mmmod._launch(x, w, split=2)  # one 64-deep K step


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(64, 48, 64), (100, 77, 1), (5, 300, 70),
                                   (3, 0, 4)])
@pytest.mark.parametrize("layout", ["fwd", "dgrad", "wgrad", "am_bk"])
@pytest.mark.parametrize("act", mmmod.ACTIVATIONS)
def test_matmul_fp32_kernel_matches_plain(cuda, M, K, N, layout, act):
    x, w, b = _mm_operands(M, K, N, layout, torch.float32, cuda, N, True, 1)
    _mm_check(x, w, b, act)
    _mm_check(x, w, None, act, torch.bfloat16)


def _grads(fn, leaves, dy):
    for t in leaves:
        t.grad = None
    y = fn()
    y.backward(dy)
    return [y.detach()] + [t.grad for t in leaves]


def _launches(fn):
    before = mmmod.matmul_bias_act_cuda.launches
    out = fn()
    return out, mmmod.matmul_bias_act_cuda.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["dense", "dense_nobias", "dgd", "mlp_relu",
                                "mlp_sigmoid", "mlp_none"])
def test_dense_and_mlp_autograd_run_the_kernel(cuda, op):
    """fused_dense (3 launches a step), fused_dense_gelu_dense (6) and mlp
    (2 layers: 2 forward, 4 backward; no-grad 2 with the activation in the
    epilogue) against the plain path in bf16: outputs and every gradient
    within 2e-2 of the plain path's largest entry."""
    g = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *s: (torch.randn(s, generator=g, device=cuda)  # noqa: E731
                      * 0.5).bfloat16().requires_grad_()
    x = rnd(3, 50, 96)
    if op.startswith("dense"):
        ps = [rnd(130, 96)] + ([rnd(130)] if op == "dense" else [])
        fn = lambda impl: fused_dense(  # noqa: E731
            x, ps[0], ps[1] if len(ps) > 1 else None, impl=impl)
        want, out_w = 3, 130
    elif op == "dgd":
        ps = [rnd(200, 96), rnd(200), rnd(72, 200), rnd(72)]
        fn = lambda impl: fused_dense_gelu_dense(  # noqa: E731
            x, *ps, impl=impl)
        want, out_w = 6, 72
    else:
        act = op.split("_")[1]
        ps = [rnd(80, 96), rnd(80), rnd(1, 80), rnd(1)]
        fn = lambda impl: mlp(x, ps[0::2], ps[1::2], act,  # noqa
                                     impl=impl)
        want, out_w = 6, 1
    dy = torch.randn((3, 50, out_w), generator=g, device=cuda).bfloat16()
    leaves = [x, *ps]
    got, n = _launches(lambda: _grads(lambda: fn("auto"), leaves, dy))
    assert n == want
    ref, n = _launches(lambda: _grads(lambda: fn("torch"), leaves, dy))
    assert n == 0
    for a, c in zip(got, ref):
        assert a.dtype == c.dtype
        ok, err = _close_to_largest(a, c, 2e-2)
        assert ok, err
    if op.startswith("mlp"):
        with torch.no_grad():
            y, n = _launches(lambda: fn("auto"))
            assert n == 2
            ok, err = _close_to_largest(y, fn("torch"), 2e-2)
            assert ok, err


@pytest.mark.gpu
def test_matmul_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.half, device=cuda)
    with pytest.raises(ValueError, match="impl='torch'"):
        mmmod.matmul_bias_act(x, x.t())
    with pytest.raises(ValueError, match="impl='torch'"):
        fused_dense(x, x)
    with pytest.raises(ValueError, match="unknown activation"):
        mmmod.matmul_bias_act(x.bfloat16(), x.t().bfloat16(),
                              activation="tanh")
    y = mmmod.matmul_bias_act(x, x.t(), impl="torch")
    assert y.shape == (4, 4) and y.dtype == torch.half


# --- dropout: the flash kernels' masks and the elementwise kernel -------------

DROP = 0.1


def _drop_case(kind, cuda):
    """(fwd, bwd, ins, do, kw) of one flash family with dropout inputs:
    ``fwd(ins, **kw)``, ``bwd(ins, o, lse, do, **kw)``."""
    g = torch.Generator(device=cuda).manual_seed(len(kind))
    rnd = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                 device=cuda).bfloat16()
    if kind in ("packed", "packed_gqa", "packed_d64"):
        h, h_kv, d, s = (8, 8 if kind == "packed" else 2,
                         64 if kind == "packed_d64" else 128, 300)
        qkv, do = rnd(2, s, (h + 2 * h_kv) * d), rnd(2, s, h * d)
        return (lambda x, **k: amod.flash_fwd_packed(x[0], h, h_kv, d, **k),
                lambda x, o, l, dy, **k: amod.flash_bwd_packed(
                    x[0], o, l, dy, h, h_kv, d, **k),
                (qkv,), do, dict(scale=d ** -0.5, causal=True))
    if kind == "bshd":
        q, k, v, do = rnd(3, 200, 4, 64), rnd(3, 200, 2, 64), \
            rnd(3, 200, 2, 64), rnd(3, 200, 4, 64)
        lens = torch.tensor([200, 77, 0], dtype=torch.int32, device=cuda)
        return (lambda x, **k_: amod.flash_fwd_bshd(*x, **k_),
                lambda x, o, l, dy, **k_: amod.flash_bwd_bshd(*x, o, l, dy,
                                                              **k_),
                (q, k, v), do, dict(scale=0.125, causal=False, kv_lens=lens))
    q, k, v, do = (rnd(2, 4, 256, 64) for _ in range(4))
    table = torch.randn((32, 4), generator=g, device=cuda) * 0.1
    bias = amod.BucketedBias(table, bidirectional=kind == "flat_enc",
                             max_distance=128)
    lens = (torch.tensor([256, 100], dtype=torch.int32, device=cuda)
            .repeat_interleave(4) if kind == "flat_enc" else None)
    return (lambda x, **k_: amod.flash_fwd(*x, **k_),
            lambda x, o, l, dy, **k_: amod.flash_bwd(*x, o, l, dy, **k_),
            (q, k, v), do, dict(scale=0.125, causal=kind == "flat_dec",
                                kv_lens=lens, rel_bias=bias))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["packed", "packed_gqa", "packed_d64",
                                  "bshd", "flat_enc", "flat_dec"])
def test_flash_dropout_kernels_match_plain(cuda, kind):
    """Every flash family with dropout 0.1 against its plain version on
    the same seed, under the bf16 rule (o, dq, dk, dv; the bucket table's
    gradient within 1e-3 relative norm beside the plain version's own
    error); lse bit-identical to the dropout-free kernel's."""
    fwd, bwd, ins, do, kw = _drop_case(kind, cuda)
    dk = dict(kw, dropout_rate=DROP, dropout_seed=-2 ** 31 + 5)
    up = [x.float() for x in ins]
    o, lse = fwd(ins, **dk)
    _, lse0 = fwd(ins, **kw)
    o_p, lse_p = fwd(ins, impl="torch", **dk)
    o_t, _ = fwd(up, impl="torch", **dk)
    assert torch.equal(lse, lse0)
    assert _within_rule(o, o_p, o_t)[0]
    got = bwd(ins, o_p, lse_p, do, **dk)
    plain = bwd(ins, o_p, lse_p, do, impl="torch", **dk)
    truth = bwd(up, o_p.float(), lse_p, do.float(), impl="torch", **dk)
    for name, a, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        ok, errs = _within_rule(a, p, t)
        assert ok, f"{kind} {name}: kernel/plain errors {errs}"
    if len(got) > 3 and got[3] is not None:
        nrm = truth[3].norm()
        assert (got[3] - truth[3]).norm() <= 2 * (
            plain[3].float() - truth[3]).norm() + 1e-3 * nrm


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(amod.DROPOUT_FAULTS))
def test_flash_dropout_planted_faults_are_refused(cuda, fault):
    """Each planted dropout fault, at a GQA case (a kv head's row is not
    a q head's), fails the rule on an output it touches or moves lse."""
    h, h_kv, d, b, s = 8, 2, 128, 2, 300
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((b, s, (h + 2 * h_kv) * d), generator=g,
                      device=cuda).bfloat16()
    do = torch.randn((b, s, h * d), generator=g, device=cuda).bfloat16()
    kw = dict(scale=d ** -0.5, causal=True, dropout_rate=DROP,
              dropout_seed=11)
    o_p, lse_p = amod.flash_fwd_packed(qkv, h, h_kv, d, impl="torch", **kw)
    o_t, _ = amod.flash_fwd_packed(qkv.float(), h, h_kv, d, impl="torch",
                                   **kw)
    plain = amod.flash_bwd_packed(qkv, o_p, lse_p, do, h, h_kv, d,
                                  impl="torch", **kw)
    truth = amod.flash_bwd_packed(qkv.float(), o_p.float(), lse_p,
                                  do.float(), h, h_kv, d, impl="torch", **kw)
    at = {"l_from_dropped": ("fwd",), "no_dkv_ds_mask": ("dkv",)}.get(
        fault, ("fwd", "dq", "dkv"))
    f = lambda k: fault if k in at else None  # noqa: E731
    o, lse = amod.flash_fwd_cuda(qkv, h, h_kv, d, planted_fault=f("fwd"),
                                 **kw)
    _, lse0 = amod.flash_fwd_cuda(qkv, h, h_kv, d, scale=kw["scale"],
                                  causal=True)
    dq, delta = amod.flash_bwd_dq_cuda(qkv, o_p, lse_p, do, h, h_kv, d,
                                       planted_fault=f("dq"), **kw)
    dk, dv = amod.flash_bwd_dkv_cuda(qkv, o_p, lse_p, do, h, h_kv, d,
                                     delta=delta, planted_fault=f("dkv"),
                                     **kw)
    refused = [not _within_rule(a, p, t)[0] for a, p, t in (
        (o, o_p, o_t), (dq, plain[0], truth[0]), (dk, plain[1], truth[1]),
        (dv, plain[2], truth[2]))]
    assert any(refused) or not torch.equal(lse, lse0)


@pytest.mark.gpu
def test_flash_dropout_refusals_and_counts(cuda):
    """Dropout on the sm80 variant raises ValueError naming ROADMAP's
    simplicity item (dbias's too), with an array bias it runs; a dropout
    launch counts in ``.dropout_launches``."""
    b, s, h, d = 1, 128, 2, 64
    qkv = torch.randn((b, s, 3 * h * d), device=cuda).bfloat16()
    kw = dict(scale=0.125, causal=True, dropout_rate=DROP, dropout_seed=1)
    with pytest.raises(ValueError, match="ROADMAP"):
        amod.flash_fwd_cuda(qkv, h, h, d, variant="sm80", **kw)
    q = torch.randn((b, s, h, d), device=cuda).bfloat16()
    bias = torch.zeros((1, s, s), device=cuda)
    n = amod.flash_fwd_bshd_cuda.dropout_launches
    o, lse = amod.flash_fwd_bshd_cuda(q, q, q, bias=bias, **kw)
    assert amod.flash_fwd_bshd_cuda.dropout_launches == n + 1
    with pytest.raises(ValueError, match="ROADMAP"):
        amod.flash_bwd_dbias_cuda(q, q, q, o, lse, q, bias, layout="bshd",
                                  variant="sm80", **kw)
    n = amod.flash_fwd_cuda.dropout_launches
    amod.flash_fwd_cuda(qkv, h, h, d, **kw)
    amod.flash_fwd_cuda(qkv, h, h, d, scale=0.125, causal=True)
    assert amod.flash_fwd_cuda.dropout_launches == n + 1


# --- dropout beside the array bias: the kArr x kDrop instances, dbias's mask --

def _bias_drop_case(kind, cuda):
    """(layout, q, k, v, do, kw) with an array bias and dropout 0.1: the
    bh-flat layout (hb 4 of 8 rows; d 128; GQA 4/2 causal), the
    key-padding route's head-major (h, b, s, d) views of (b, s, h, d)
    tensors with a (b, sq, sk) -1e9 bias (hb = b), and bshd with an (h,
    sq, sk) mask and per-batch lengths."""
    g = torch.Generator(device=cuda).manual_seed(len(kind) + 7)
    rnd = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                 device=cuda).bfloat16()
    kw = dict(scale=0.125, causal=False, dropout_rate=DROP,
              dropout_seed=-2 ** 31 + 9)
    if kind == "keypad":
        b, s, h, d = 3, 200, 4, 64
        q, k, v, do = (rnd(b, s, h, d).permute(2, 0, 1, 3)
                       for _ in range(4))
        pad = torch.zeros((b, s), dtype=torch.bool, device=cuda)
        pad[1, 150:] = True
        pad[2, 7:] = True
        bias = torch.where(pad[:, None, :], -1e9, 0.0).expand(
            b, s, s).contiguous()
        return "bhsd", q, k, v, do, dict(kw, bias=bias)
    if kind == "bshd":
        b, s, h, d = 2, 256, 4, 64
        q, k, v, do = (rnd(b, s, h, d) for _ in range(4))
        bias = torch.randn((h, s, s), generator=g, device=cuda) * 0.5
        lens = torch.tensor([256, 100], dtype=torch.int32, device=cuda)
        return "bshd", q, k, v, do, dict(kw, bias=bias, kv_lens=lens)
    d = 128 if kind == "flat_d128" else 64
    h_kv = 2 if kind == "flat_gqa" else 4
    q, do = rnd(2, 4, 200, d), rnd(2, 4, 200, d)
    k, v = rnd(2, h_kv, 200, d), rnd(2, h_kv, 200, d)
    bias = torch.randn((4, 200, 200), generator=g, device=cuda) * 0.5
    return "bhsd", q, k, v, do, dict(kw, bias=bias,
                                     causal=kind == "flat_gqa")


BIAS_DROP_KINDS = ["flat", "flat_d128", "flat_gqa", "keypad", "bshd"]


def _bias_drop_fns(layout):
    return ((amod.flash_fwd, amod.flash_bwd) if layout == "bhsd"
            else (amod.flash_fwd_bshd, amod.flash_bwd_bshd))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", BIAS_DROP_KINDS)
def test_flash_bias_dropout_kernels_match_plain(cuda, kind):
    """The kArr x kDrop forward, dQ and dK/dV instances and dbias's mask
    against their plain versions on the same seed: o, dq, dk, dv by the
    bf16 rule, dbias within 1e-3 relative norm of the fp32 truth, lse
    bit-identical to the dropout-free kernel call's, every output
    bit-identical across two runs, one dropout launch a kernel."""
    layout, q, k, v, do, kw = _bias_drop_case(kind, cuda)
    fwd, bwd = _bias_drop_fns(layout)
    up = [x.float() for x in (q, k, v)]
    counters = [amod.flash_bwd_dbias_cuda] + (
        [amod.flash_fwd_flat_cuda, amod.flash_bwd_flat_dq_cuda,
         amod.flash_bwd_flat_dkv_cuda] if layout == "bhsd" else
        [amod.flash_fwd_bshd_cuda, amod.flash_bwd_bshd_dq_cuda,
         amod.flash_bwd_bshd_dkv_cuda])
    before = [fn.dropout_launches for fn in counters]
    o, lse = fwd(q, k, v, **kw)
    got = bwd(q, k, v, o, lse, do, **kw)
    assert [fn.dropout_launches - n for fn, n in zip(counters, before)] \
        == [1, 1, 1, 1]
    _, lse0 = fwd(q, k, v, **dict(kw, dropout_rate=0.0, dropout_seed=None))
    o_p, lse_p = fwd(q, k, v, impl="torch", **kw)
    o_t, _ = fwd(*up, impl="torch", **kw)
    assert torch.equal(lse, lse0)
    assert _within_rule(o, o_p, o_t)[0]
    got = bwd(q, k, v, o_p, lse_p, do, **kw)
    again = bwd(q, k, v, o_p, lse_p, do, **kw)
    plain = bwd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
    truth = bwd(*up, o_p.float(), lse_p, do.float(), impl="torch", **kw)
    for name, a, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        ok, errs = _within_rule(a, p, t)
        assert ok, f"{kind} {name}: kernel/plain errors {errs}"
    _check_dbias(got[3], truth[3])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_softmax_cross_entropy_loss_runs_xent_stats(cuda, eps):
    """The loss's forward launches the xent_stats kernel once and equals
    its plain version within 1e-5 relative (the kernel's sum-exp rule);
    the backward (plain PyTorch, on either path's lse) within one bf16
    ulp of the plain path's gradient's largest entry."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (3 * torch.randn((96, 1000), generator=g, device=cuda)).bfloat16()
    lab = torch.randint(-5, 1005, (96,), generator=g, device=cuda)
    xk, xp = (x.clone().requires_grad_() for _ in range(2))
    n = xmod.xent_stats_cuda.launches
    got = xmod.softmax_cross_entropy_loss(xk, lab, eps, True)
    assert xmod.xent_stats_cuda.launches == n + 1
    want = xmod.softmax_cross_entropy_loss(xp, lab, eps, True, impl="torch")
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-5, atol=0)
    dl = torch.randn((96,), generator=g, device=cuda)
    got.backward(dl)
    want.backward(dl)
    ref = xp.grad.float()
    torch.testing.assert_close(xk.grad.float(), ref, rtol=0,
                               atol=2.0 ** -8 * ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(set(amod.DROPOUT_FAULTS)
                                         | set(amod.DBIAS_DROPOUT_FAULTS)))
def test_flash_bias_dropout_planted_faults_are_refused(cuda, fault):
    """Each planted dropout fault in the kArr x kDrop instances (and in
    dbias where it plants it), at the GQA case: an output it touches
    fails its rule, or lse moves."""
    layout, q, k, v, do, kw = _bias_drop_case("flat_gqa", cuda)
    up = [x.float() for x in (q, k, v)]
    o_p, lse_p = amod.flash_fwd(q, k, v, impl="torch", **kw)
    o_t, _ = amod.flash_fwd(*up, impl="torch", **kw)
    plain = amod.flash_bwd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
    truth = amod.flash_bwd(*up, o_p.float(), lse_p, do.float(),
                           impl="torch", **kw)
    at = {"l_from_dropped": ("fwd",), "no_dkv_ds_mask": ("dkv",),
          "no_dbias_dp_mask": ("dbias",)}.get(
        fault, ("fwd", "dq", "dkv", "dbias"))
    f = lambda w: fault if w in at else None  # noqa: E731
    o, lse = amod.flash_fwd_flat_cuda(q, k, v, planted_fault=f("fwd"), **kw)
    _, lse0 = amod.flash_fwd_flat_cuda(
        q, k, v, **dict(kw, dropout_rate=0.0, dropout_seed=None))
    dq, delta = amod.flash_bwd_flat_dq_cuda(q, k, v, o_p, lse_p, do,
                                            planted_fault=f("dq"), **kw)
    dk, dv, _ = amod.flash_bwd_flat_dkv_cuda(q, k, v, o_p, lse_p, do,
                                             delta=delta,
                                             planted_fault=f("dkv"), **kw)
    db = amod.flash_bwd_dbias_cuda(
        q, k, v, o_p, lse_p, do, kw["bias"], scale=kw["scale"],
        causal=kw["causal"], delta=delta, dropout_rate=DROP,
        dropout_seed=kw["dropout_seed"], planted_fault=f("dbias"))
    refused = [not _within_rule(a, p, t)[0] for a, p, t in (
        (o, o_p, o_t), (dq, plain[0], truth[0]), (dk, plain[1], truth[1]),
        (dv, plain[2], truth[2]))]
    refused.append(_dbias_err(db, truth[3]) > DBIAS_TOL)
    assert any(refused) or not torch.equal(lse, lse0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 1024), (7, 13), (3, 5, 96),
                                   (2, 8, 64, 64)])
def test_dropout_kernel_is_bit_identical_to_plain(cuda, dtype, shape):
    """The elementwise kernel against its plain version, forward and
    backward (one function), at the int32 seed edges; its fp32-scale
    fault refused in bf16; one launch counted a call."""
    from apex_tpu_torch.ops import dropout as dmod

    x = torch.randn(shape, device=cuda).to(dtype)
    for seed in (0, -1, 2 ** 31 - 1, -2 ** 31):
        n = dmod.dropout_cuda.launches
        assert torch.equal(dmod.dropout_cuda(x, DROP, seed),
                           dmod.dropout_plain(x, DROP, seed))
        assert torch.equal(dmod.dropout_cuda(x, DROP, seed, backward=True),
                           dmod.dropout_plain(x, DROP, seed))
        assert dmod.dropout_cuda.launches == n + 2
    if dtype == torch.bfloat16 and x.numel() > 1000:
        assert not torch.equal(
            dmod.dropout_cuda(x, DROP, 5, planted_fault="fp32_scale"),
            dmod.dropout_plain(x, DROP, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["flash", "softmax"])
def test_dropout_train_step_kernel_path_matches_plain_path(cuda, route):
    """A small bf16 GPT with dropout 0.1, one set of seeds: loss and
    gradients through the kernels against the plain versions, at
    test_train_step_kernel_path_matches_plain_path's bounds."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, param_leaves

    cfg = GPTConfig(vocab_size=512, max_seq_len=256, hidden_size=256,
                    num_layers=2, num_heads=2, remat=False, dropout=DROP,
                    dtype=torch.bfloat16, attention_impl=route)
    model = GPTModel(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens, targets = (torch.randint(0, 512, (4, 256), generator=g,
                                     device=cuda) for _ in range(2))
    seeds = model.dropout_seeds(torch.Generator().manual_seed(2))
    hd = cfg.num_heads * cfg.head_dim
    out = []
    for impl in ("auto", "torch"):
        loss = model.loss_fn(params, tokens, targets, dropout_seeds=seeds,
                             impl=impl)
        loss.backward()
        grads = []
        for t in leaves:
            gr = t.grad.float()
            if t.shape == (cfg.qkv_features,):
                gr = torch.cat([gr[:hd], gr[2 * hd:]])
            grads.append(gr)
            t.grad = None
        out.append((loss.item(), grads))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        assert (a - b).norm() <= 5e-2 * b.norm()


# --- fp16 instances (amp's strict-fp16 GPT step) ------------------------------
#
# The fp16 rule: the truth is the plain version run in fp32 on the same fp16
# inputs; the kernel's max abs error at most twice the fp16 plain version's
# plus 2^-13 of max(1, the truth's largest entry), and its relative norm
# error at most twice the plain version's plus 2^-13 (the bf16 rule's 1e-3
# slack scaled by fp16's three more mantissa bits, with the softmax rule's
# norm clause: at +1e-3 the forward with P rounded through bf16 passes).
# Overflow: the backward at a dO scaled by 2^14 (its entries clamped to
# +-6e4, so the input stays finite) until the outputs' sums pass 65504; an
# output non-finite in the fp16 plain version at 1 - 2^-6 of that
# scale (so no finite/inf call rests on the last bits of an fp32 sum) must
# be non-finite in the kernel's, and the all-finite flags agree at the
# scale. The forward with an inf in a q row and a k row: the same
# non-finite outputs (the plain version masks by a select, so nothing
# leaks through masked entries).

F16_SLACK = 2.0 ** -13


def _f16_rule(got, plain, truth):
    t = truth.float()
    err_k = (got.float() - t).abs().max().item()
    err_p = (plain.float() - t).abs().max().item()
    tn = t.norm().item() + 1e-30
    rel_k = (got.float() - t).norm().item() / tn
    rel_p = (plain.float() - t).norm().item() / tn
    ok = (err_k <= 2 * err_p + F16_SLACK * max(1.0, t.abs().max().item())
          and rel_k <= 2 * rel_p + F16_SLACK)
    return ok, (err_k, err_p, rel_k, rel_p)


def _f16_flash(b, s, h, h_kv, d, dev, fault=None, do=None):
    qkv32, do32 = _flash_inputs(b, s, h, h_kv, d, dev, seed=s + d + h_kv)
    qkv, do = qkv32.half(), (do32.half() if do is None else do)
    sc = d ** -0.5
    o, lse = amod.flash_fwd_cuda(qkv, h, h_kv, d, scale=sc, causal=True,
                                 planted_fault=fault)
    dq, delta = amod.flash_bwd_dq_cuda(qkv, o, lse, do, h, h_kv, d, scale=sc,
                                       causal=True, planted_fault=fault)
    dk, dv = amod.flash_bwd_dkv_cuda(qkv, o, lse, do, h, h_kv, d, scale=sc,
                                     causal=True, delta=delta,
                                     planted_fault=fault)
    return qkv, do, (o, lse, dq, dk, dv)


def _f16_plain(qkv, do, h, h_kv, d):
    sc = d ** -0.5
    o, lse = amod._torch_flash_fwd(qkv, h, h_kv, d, sc, True)
    return (o, lse, *amod._torch_flash_bwd(qkv, o, lse, do, h, h_kv, d, sc,
                                           True))


F16_FLASH_CALLS = [(2, 1024, 8, 8, 128), (1, 1000, 8, 2, 128),
                   (2, 512, 16, 16, 64), (1, 333, 4, 1, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,h_kv,d", F16_FLASH_CALLS)
def test_fp16_flash_packed_matches_plain(cuda, b, s, h, h_kv, d):
    """The packed entry's fp16 instances (forward, dQ, dK/dV) by the fp16
    rule against the fp32 truth, lse within 1e-5 of the truth's largest,
    every output bit-identical across two runs, one f16 launch each."""
    before = _counts(amod.flash_fwd_cuda, amod.flash_bwd_dq_cuda,
                     amod.flash_bwd_dkv_cuda)
    f16 = [f.f16_launches for f in (amod.flash_fwd_cuda,
                                    amod.flash_bwd_dq_cuda,
                                    amod.flash_bwd_dkv_cuda)]
    qkv, do, got = _f16_flash(b, s, h, h_kv, d, cuda)
    assert all(t.dtype == torch.float16 for i, t in enumerate(got) if i != 1)
    assert [f.f16_launches - n for f, n in zip(
        (amod.flash_fwd_cuda, amod.flash_bwd_dq_cuda,
         amod.flash_bwd_dkv_cuda), f16)] == [1, 1, 1]
    assert [a - n for a, n in zip(_counts(
        amod.flash_fwd_cuda, amod.flash_bwd_dq_cuda, amod.flash_bwd_dkv_cuda),
        before)] == [1, 1, 1]
    _, _, again = _f16_flash(b, s, h, h_kv, d, cuda)
    plain = _f16_plain(qkv, do, h, h_kv, d)
    truth = _f16_plain(qkv.float(), do.float(), h, h_kv, d)
    for name, g, p, t, a in zip(("o", "lse", "dq", "dk", "dv"), got, plain,
                                truth, again):
        assert torch.equal(g, a), name
        if name == "lse":
            ok, err = _close_to_largest(g, t, 1e-5)
        else:
            ok, err = _f16_rule(g, p, t)
        assert ok, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(amod.FP16_FAULTS))
@pytest.mark.parametrize("b,s,h,h_kv,d", F16_FLASH_CALLS[:3])
def test_fp16_flash_planted_faults_are_refused(cuda, b, s, h, h_kv, d,
                                               fault):
    """bf16_p (P and dS rounded through bf16) fails the fp16 rule in o,
    dq, dk and dv; satfinite (outputs clamped to +-65504) fails the
    overflow check: at the scaled dO the plain version's infs come back
    finite."""
    qkv, do, got = _f16_flash(b, s, h, h_kv, d, cuda, fault=fault)
    if fault == "bf16_p":
        plain = _f16_plain(qkv, do, h, h_kv, d)
        truth = _f16_plain(qkv.float(), do.float(), h, h_kv, d)
        for i in (0, 2, 3, 4):
            assert not _f16_rule(got[i], plain[i], truth[i])[0], i
        return
    ok, why = _f16_overflow_check(cuda, b, s, h, h_kv, d, fault)
    assert not ok, why


def _scaled_do(do, scale):
    """dO x scale in fp16, its entries kept finite (clamped to +-6e4): the
    outputs' sums pass 65504, the input does not."""
    return (do.float() * scale).clamp(-6e4, 6e4).half()


def _f16_overflow_check(dev, b, s, h, h_kv, d, fault=None):
    """The backward's overflow rule at dO x 2^14."""
    qkv, do = _flash_inputs(b, s, h, h_kv, d, dev, seed=s + d + h_kv)
    qkv = qkv.half()
    scale = 2.0 ** 14
    big, lower = _scaled_do(do, scale), _scaled_do(do, scale * (
        1 - 2.0 ** -6))
    _, _, got = _f16_flash(b, s, h, h_kv, d, dev, fault=fault, do=big)
    o, lse = amod._torch_flash_fwd(qkv, h, h_kv, d, d ** -0.5, True)
    plain = amod._torch_flash_bwd(qkv, o, lse, big, h, h_kv, d, d ** -0.5,
                                  True)
    robust = amod._torch_flash_bwd(qkv, o, lse, lower, h, h_kv, d,
                                   d ** -0.5, True)
    if all(torch.isfinite(r).all() for r in robust):
        return False, "the plain version overflows nowhere"
    for name, g, p, r in zip(("dq", "dk", "dv"), got[2:], plain, robust):
        inf_r = ~torch.isfinite(r)
        if (inf_r & torch.isfinite(g)).any():
            return False, (name, int((inf_r & torch.isfinite(g)).sum()))
        if bool(torch.isfinite(g).all()) != bool(torch.isfinite(p).all()):
            return False, (name, "all-finite flags differ")
    return True, None


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,h_kv,d", F16_FLASH_CALLS[:3])
def test_fp16_flash_overflow_reaches_the_output_as_inf(cuda, b, s, h, h_kv,
                                                       d):
    ok, why = _f16_overflow_check(cuda, b, s, h, h_kv, d)
    assert ok, why
    # the forward: an inf in a q row and in a k row
    qkv, _ = _flash_inputs(b, s, h, h_kv, d, cuda, seed=7)
    qkv = qkv.half()
    qkv[0, s // 3, :d] = float("inf")                 # q row, head 0
    qkv[0, s // 2, h * d:h * d + d] = float("inf")    # k row, kv head 0
    o, _ = amod.flash_fwd_cuda(qkv, h, h_kv, d, scale=d ** -0.5, causal=True)
    po, _ = amod._torch_flash_fwd(qkv, h, h_kv, d, d ** -0.5, True)
    assert (~torch.isfinite(po)).any()
    assert torch.equal(~torch.isfinite(o), ~torch.isfinite(po))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,hidden", [(16384, 1024), (37, 1000), (5, 768)])
@pytest.mark.parametrize("wdtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("rms,affine", [(False, "wb"), (True, "w"),
                                        (False, "")])
def test_fp16_layer_norm_matches_plain(cuda, rows, hidden, wdtype, rms,
                                       affine):
    """The norms' fp16 instances: y and dx by the fp16 rule, mean and rstd
    within 1e-5 of the truth's largest, dgamma/dbeta in the parameters'
    dtype within 2^-10 of the largest (one fp16 ulp; 1e-5 in fp32) and
    bit-identical across two runs; an inf in a row makes that row's y
    non-finite as in the plain version; dy scaled past fp16's range makes
    dx and dgamma overflow where the plain version's do."""
    x, dy, w, b = _ln_case(rows, hidden, torch.float16, wdtype, affine, cuda,
                           seed=rows + hidden)
    f16 = (lnmod.ln_fwd_cuda.f16_launches, lnmod.ln_bwd_cuda.f16_launches)
    y, mean, rstd = lnmod.ln_fwd_cuda(x, w, b, 1e-5, rms)
    dx, dw, db = lnmod.ln_bwd_cuda(dy, x, mean, rstd, w, rms, b is not None)
    assert (lnmod.ln_fwd_cuda.f16_launches - f16[0],
            lnmod.ln_bwd_cuda.f16_launches - f16[1]) == (1, 1)
    yp, mp, rp = lnmod._torch_fwd(x, w, b, 1e-5, rms)
    yt, mt, rt = lnmod._torch_fwd(x.float(), None if w is None else w.float(),
                                  None if b is None else b.float(), 1e-5, rms)
    dxp, _, _ = lnmod._torch_bwd(dy, x, mp, rp, w, rms)
    dxt, dwt, dbt = lnmod._torch_bwd(dy.float(), x.float(), mt, rt,
                                     None if w is None else w.float(), rms)
    assert y.dtype == dx.dtype == torch.float16
    for name, g, p, t in (("y", y, yp, yt), ("dx", dx, dxp, dxt)):
        ok, err = _f16_rule(g, p, t)
        assert ok, (name, err)
    for g, t in ((mean, mt), (rstd, rt)):
        assert _close_to_largest(g, t, 1e-5)[0]
    if w is not None:
        tol = 2.0 ** -10 if wdtype == torch.float16 else 1e-5
        assert dw.dtype == wdtype
        assert _close_to_largest(dw, dwt, tol)[0]
        if db is not None:
            assert _close_to_largest(db, dbt, tol)[0]
        _, dw2, _ = lnmod.ln_bwd_cuda(dy, x, mean, rstd, w, rms,
                                      b is not None)
        assert torch.equal(dw, dw2)
    xi = x.clone()
    xi[rows // 2, hidden // 3] = float("inf")
    yi, _, _ = lnmod.ln_fwd_cuda(xi, w, b, 1e-5, rms)
    ypi, _, _ = lnmod._torch_fwd(xi, w, b, 1e-5, rms)
    assert torch.equal(~torch.isfinite(yi), ~torch.isfinite(ypi))
    big = _scaled_do(dy, 2.0 ** 14)
    lower = _scaled_do(dy, 2.0 ** 14 * (1 - 2.0 ** -6))
    dxb, dwb, _ = lnmod.ln_bwd_cuda(big, x, mean, rstd, w, rms, False)
    dxr, dwr, _ = lnmod._torch_bwd(lower, x, mp, rp, w, rms)
    dxr = dxr.float()
    if w is not None:
        dwr = dwr.to(w.dtype)
        assert not (~torch.isfinite(dwr) & torch.isfinite(dwb)).any()
    assert not (~torch.isfinite(dxr) & torch.isfinite(dxb)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,V", [(2048, 32768), (5, 256)])
def test_fp16_xent_stats_matches_plain(cuda, n, V, label_dtype):
    """xent_stats's fp16 instance: max and target exact, the exp-sum within
    1e-5 relative, the row sum within 1e-5 of its scale; an inf logit
    gives the plain version's non-finite statistics."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = (3 * torch.randn((n, V), generator=g, device=cuda)).half()
    lab = torch.randint(-1, V + 1, (n,), generator=g, device=cuda).to(
        label_dtype)
    before = xmod.xent_stats_cuda.f16_launches
    got = xmod.xent_stats_cuda(x, lab)
    assert xmod.xent_stats_cuda.f16_launches - before == 1
    m, l, t, s = got
    mp, lp, tp, sp = xmod._torch_xent_stats(x, lab)
    assert torch.equal(m, mp) and torch.equal(t, tp)
    assert ((l - lp).abs() / lp).max().item() <= 1e-5
    assert ((s - sp).abs().max() <= 1e-5 * x.float().abs().sum(-1).max())
    x[1, 3] = float("inf")
    for a, b in zip(xmod.xent_stats_cuda(x, lab),
                    xmod._torch_xent_stats(x, lab)):
        assert torch.equal(~torch.isfinite(a), ~torch.isfinite(b))


# --- the wide layer-norm kernels (hidden 4097 to 65536) ------------------------

_WIDE_HIDDEN = [4097, 5000, 8192, 12288, 25600, 49152, 65536]
_WIDE_DTYPES = [(torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32),
                (torch.float32, torch.float32),
                (torch.float16, torch.float16),
                (torch.float16, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", _WIDE_HIDDEN)
@pytest.mark.parametrize("dtype,wdtype", _WIDE_DTYPES,
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("rms,affine", [(False, "wb"), (False, ""),
                                        (True, "w"), (True, "")])
@pytest.mark.parametrize("rows", [1, 300])
def test_layer_norm_wide_kernels_match_plain(cuda, rows, hidden, dtype,
                                             wdtype, rms, affine):
    _check_ln(cuda, rows, hidden, dtype, wdtype, rms, affine, wide=True)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,hidden", [(2048, 8192), (1000, 5000),
                                         (64, 65536), (333, 12288)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_wide_is_bit_reproducible(cuda, rows, hidden, dtype):
    """y, mean, rstd, dx, dgamma and dbeta the same bits across two runs."""
    x, dy, w, b = _ln_case(rows, hidden, dtype, dtype, "wb", cuda, seed=5)
    first = lnmod.ln_fwd_wide_cuda(x, w, b, 1e-5, False)
    again = lnmod.ln_fwd_wide_cuda(x, w, b, 1e-5, False)
    _, mean, rstd = first
    bwd = [lnmod.ln_bwd_wide_cuda(dy, x, mean, rstd, w, False)
           for _ in range(2)]
    for a, c in zip(first + bwd[0], again + bwd[1]):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", _WIDE_HIDDEN)
@pytest.mark.parametrize("fault", sorted(lnmod.WIDE_FAULTS))
def test_layer_norm_wide_planted_faults_are_refused(cuda, hidden, fault):
    """fp32 rows whose last 16-byte chunk is large: the tail left out of
    the statistics, or the last rank's (warp's) partial not merged, moves
    rstd, and dx's relative norm error past 1e-5 (the kernel's own is
    ~1e-7)."""
    x, dy, _, _ = _ln_case(64, hidden, torch.float32, torch.float32, "",
                           cuda, seed=hidden)
    x[:, -4:] += 6
    dy[:, -4:] += 6
    yt, mt, rt = lnmod._torch_fwd(x, None, None, 1e-5, False)
    dxt, _, _ = lnmod._torch_bwd(dy, x, mt, rt, None, False)
    _, _, r = lnmod.ln_fwd_wide_cuda(x, None, None, 1e-5, False,
                                     planted_fault=fault)
    dx, _, _ = lnmod.ln_bwd_wide_cuda(dy, x, mt, rt, None, False,
                                      planted_fault=fault)
    assert not _close_to_largest(r, rt, 1e-5)[0]
    assert ((dx - dxt).norm() / dxt.norm()).item() > 1e-5


@pytest.mark.gpu
def test_wide_norms_dispatch_past_4096(cuda):
    """fused_layer_norm, fused_rms_norm and contrib's FastLayerNorm at
    hidden 8192 launch the wide kernels (no ValueError, no register
    kernel); 0 rows launch nothing; past 65536 the entry refuses."""
    from apex_tpu_torch.contrib.layer_norm import FastLayerNorm

    fns = (lnmod.ln_fwd_wide_cuda, lnmod.ln_bwd_wide_cuda,
           lnmod.ln_fwd_cuda, lnmod.ln_bwd_cuda)
    mod = FastLayerNorm(8192, dtype=torch.bfloat16)
    x = torch.randn((2, 3, 8192), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.ones(8192, device=cuda, requires_grad=True)
    before = [f.launches for f in fns]
    mod(x).float().sum().backward()
    lnmod.fused_rms_norm(x, w).float().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [2, 2, 0, 0]
    empty = torch.empty((0, 8192), device=cuda, dtype=torch.bfloat16)
    assert mod(empty).shape == (0, 8192)
    with pytest.raises(ValueError, match="queue 2, item 7"):
        lnmod.fused_layer_norm(torch.zeros((1, 65540), device=cuda))


# --- batch norm (csrc/batch_norm.cu) ------------------------------------------

#: ResNet-50's batch-norm calls at batch 32 (rows, channels, residual,
#: ReLU), and a width that is no whole 16-byte vector
_BN_CALLS = [(401408, 64, False, True), (100352, 256, True, True),
             (100352, 256, False, False), (25088, 128, False, True),
             (1568, 2048, True, True), (1001, 13, True, True)]
_BN_DTYPES = [(torch.bfloat16, torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.float32, torch.float32),
              (torch.float16, torch.float16, torch.float32),
              (torch.float32, torch.bfloat16, torch.float32)]


def _bn_case(M, C, dtype, out_dtype, wdtype, residual, dev, seed=0):
    """Activations with per-channel offsets and scales and per-image
    shifts (so a left-out chunk moves the statistics), dy correlated with
    x̂ (so the x̂ term of dx is large), eval running statistics."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.rand(C, generator=g, device=dev) * 4 - 2
    s = torch.rand(C, generator=g, device=dev) * 1.5 + 0.5
    img = torch.arange(M, device=dev) * 32 // M
    a = torch.randn((32, C), generator=g, device=dev) * 0.5
    z = torch.randn((M, C), generator=g, device=dev)
    x = (m + s * (z + a[img])).to(dtype)
    xh = (x.float() - m) / s
    dy = (0.5 * torch.randn((M, C), generator=g, device=dev) + 0.5 * xh
          + 0.25).to(out_dtype)
    res = (torch.randn((M, C), generator=g, device=dev).to(out_dtype)
           if residual else None)
    sc = (torch.rand(C, generator=g, device=dev) + 0.5).to(wdtype)
    bi = (torch.randn(C, generator=g, device=dev) * 0.2).to(wdtype)
    return x, dy, res, sc, bi, (m + 0.1).float(), (s * s).float()


def _bn_run(x, dy, res, sc, bi, rm, rv, relu, training, fwd_fault=None,
            bwd_fault=None):
    y, st = bnmod.bn_fwd_cuda(x, sc, bi, training=training, eps=1e-5,
                              running_mean=rm, running_var=rv, residual=res,
                              relu=relu, out_dtype=dy.dtype,
                              planted_fault=fwd_fault)
    grads = bnmod.bn_bwd_cuda(dy, x, y, st, training=training,
                              residual=res is not None, relu=relu,
                              w_dtype=sc.dtype, planted_fault=bwd_fault)
    return y, st, grads


def _bn_plain(x, dy, res, sc, bi, rm, rv, relu, training, y_kernel,
              upcast):
    f = (lambda t: None if t is None else t.float()) if upcast else (
        lambda t: t)
    y, mean, var = bnmod.bn_plain(f(x), f(sc), f(bi), training=training,
                                  eps=1e-5, running_mean=rm,
                                  running_var=rv, residual=f(res),
                                  relu=relu,
                                  out_dtype=torch.float32 if upcast
                                  else dy.dtype)
    grads = bnmod.bn_backward_plain(
        f(dy), f(x), f(y_kernel), f(sc), f(bi), training=training, eps=1e-5,
        running_mean=rm, running_var=rv, residual=res is not None,
        relu=relu)
    return y, mean, torch.rsqrt(var + 1e-5), grads


def _bn_rule(got, plain, truth, dtype):
    err = (got.float() - truth.float()).abs().max().item()
    if dtype == torch.float32:
        return err <= 1e-5 * truth.abs().max().item(), err
    own = (plain.float() - truth.float()).abs().max().item()
    slack = (1e-3 if dtype == torch.bfloat16
             else 2 ** -13 * max(1.0, truth.abs().max().item()))
    return err <= 2 * own + slack, err


def _bn_checks(got, plain, truth, dtypes):
    """{output: (passes, error)} over y, mean, rstd, dx, dresidual, dscale
    and dbias."""
    dtype, out_dtype, wdtype = dtypes
    y, st, (dx, dres, ds, db) = got
    yp, _, _, (dxp, dresp, _, _) = plain
    yt, mt, rt, (dxt, drest, dst, dbt) = truth
    w_tol = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7,
             torch.float16: 2 ** -10}[wdtype]
    out = {"y": _bn_rule(y, yp, yt, out_dtype),
           "dx": _bn_rule(dx, dxp, dxt, dtype)}
    if dres is not None:
        out["dres"] = _bn_rule(dres, dresp, drest, out_dtype)
    for name, a, b, tol in (("mean", st[0], mt, 1e-5),
                            ("rstd", st[2], rt, 1e-5),
                            ("dscale", ds, dst, w_tol),
                            ("dbias", db, dbt, w_tol)):
        err = (a.float() - b.float()).abs().max().item()
        out[name] = (err <= tol * b.float().abs().max().item(), err)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtypes", _BN_DTYPES,
                         ids=lambda d: "-".join(str(t).split(".")[-1]
                                                for t in d))
@pytest.mark.parametrize("M,C,residual,relu", _BN_CALLS)
def test_batch_norm_kernels_match_plain(cuda, M, C, residual, relu, dtypes,
                                        training):
    case = _bn_case(M, C, *dtypes, residual, cuda)
    got = _bn_run(*case, relu, training)
    plain = _bn_plain(*case, relu, training, got[0], upcast=False)
    truth = _bn_plain(*case, relu, training, got[0], upcast=True)
    torch.cuda.synchronize()
    checks = _bn_checks(got, plain, truth, dtypes)
    assert all(ok for ok, _ in checks.values()), checks
    assert got[0].dtype == dtypes[1] and got[2][0].dtype == dtypes[0]
    assert got[2][2].dtype == dtypes[2]


@pytest.mark.gpu
@pytest.mark.parametrize("M,C,residual,relu", _BN_CALLS)
def test_batch_norm_is_bit_reproducible(cuda, M, C, residual, relu):
    case = _bn_case(M, C, torch.bfloat16, torch.bfloat16, torch.float32,
                    residual, cuda)
    a, b = (_bn_run(*case, relu, True) for _ in range(2))
    flat = lambda r: [r[0], r[1], *[t for t in r[2] if t is not None]]  # noqa: E731
    assert all(torch.equal(u, v) for u, v in zip(flat(a), flat(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("M,C,residual,relu", _BN_CALLS)
def test_batch_norm_planted_faults_are_refused(cuda, M, C, residual, relu):
    dtypes = (torch.bfloat16, torch.bfloat16, torch.float32)
    case = _bn_case(M, C, *dtypes, residual, cuda)
    got = _bn_run(*case, relu, True)
    truth = _bn_plain(*case, relu, True, got[0], upcast=True)
    plain = _bn_plain(*case, relu, True, got[0], upcast=False)
    for fwd, bwd in (("drop_last_chunk", None), (None, "drop_xhat_term")):
        bad = _bn_run(*case, relu, True, fwd_fault=fwd, bwd_fault=bwd)
        checks = _bn_checks(bad, plain, truth, dtypes)
        assert not all(ok for ok, _ in checks.values()), (fwd, bwd, checks)


@pytest.mark.gpu
def test_sync_batch_norm_autograd_on_the_kernels(cuda):
    """sync_batch_norm on a CUDA tensor runs the kernels (one forward and
    one backward launch, counted by epilogue) and matches impl="torch"
    (the plain path) under autograd; the running statistics too."""
    from apex_tpu_torch.parallel import BatchNormState, sync_batch_norm

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((8, 14, 14, 256), generator=g, device=cuda).bfloat16()
    r = torch.randn(x.shape, generator=g, device=cuda).bfloat16()
    sc = torch.rand(256, generator=g, device=cuda) + 0.5
    bi = torch.randn(256, generator=g, device=cuda)
    dy = torch.randn(x.shape, generator=g, device=cuda).bfloat16()
    outs = {}
    for impl in ("auto", "torch"):
        leaves = [t.clone().requires_grad_() for t in (x, sc, bi, r)]
        st = BatchNormState.create(256, device=cuda)
        before = (bnmod.bn_fwd_cuda.res_relu_launches,
                  bnmod.bn_bwd_cuda.res_relu_launches)
        y, new = sync_batch_norm(leaves[0], leaves[1], leaves[2], st,
                                 fuse_relu=True, residual=leaves[3],
                                 impl=impl)
        (y.float() * dy.float()).sum().backward()
        after = (bnmod.bn_fwd_cuda.res_relu_launches,
                 bnmod.bn_bwd_cuda.res_relu_launches)
        assert [b - a for a, b in zip(before, after)] == (
            [1, 1] if impl == "auto" else [0, 0])
        outs[impl] = (y.float(), new.running_var, *[t.grad.float()
                                                    for t in leaves])
    for a, b in zip(outs["auto"], outs["torch"]):
        assert (a - b).abs().max().item() <= 2e-2 * b.abs().max().item()
