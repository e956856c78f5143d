"""Packed-QKV flash attention: projections, kernels and the fused block.

Port of the packed path of ``apex_tpu/ops/attention.py``:

* :func:`bshd_qkv_projection` / :func:`bshd_output_projection`
  (``:406-429``): the ONE place the packed weight layout lives — features
  ordered q-heads | k-heads | v-heads, weights stored ``(out, in)``.
* :func:`flash_fwd_packed` / :func:`flash_bwd_packed`: causal attention
  reading q/k/v windows straight out of the packed projection buffer
  ``(b, s, (h + 2·h_kv)·d)``. A CUDA tensor launches the hand-written
  kernels that replace the Pallas ``flash_fwd_packed`` and
  ``flash_bwd_packed`` (``apex_tpu_torch/csrc/flash_attn_fwd.cu``,
  ``flash_attn_bwd.cu``); a CPU tensor (or ``impl="torch"``) runs the plain
  version beside them — :func:`masked_scores` and :func:`_xla_attention`
  (``:178-250``, dropout-free) and its backward, with the Pallas kernels'
  rounding points (fp32 scores, p rounded to v's dtype before PV, dS
  rounded to q's dtype before dQ/dK, kv-group sums in fp32).
* :func:`fused_qkv_attention` (``:544-644``): packed GEMM → flash forward
  → output GEMM as one ``torch.autograd.Function`` with the reference's
  hand-written VJP; a packed dqkv is never materialised.
* :func:`flash_attention` with ``layout="bshd"`` (``:647-778``), forward
  and backward: separate seq-major q (b, sq, h, d) and k/v (b, sk, h_kv, d)
  with bottom-right causal alignment, per-BATCH ``kv_lens`` (b,) and the
  array bias — the decode engine's prefill and BERT's padded train step. A
  CUDA tensor launches :func:`flash_fwd_bshd_cuda`,
  :func:`flash_bwd_bshd_dq_cuda` and :func:`flash_bwd_bshd_dkv_cuda` (the
  ``apex_flash_fwd_bshd`` entry of ``csrc/flash_attn_fwd.cu``, and the
  backward pair of ``flash_attn_bwd.cu`` on the operands' (b, h, s, d)
  views with per-batch lengths, replacing the Pallas ``flash_fwd_bshd``
  and ``flash_bwd_bshd``); a CPU tensor runs
  :func:`_torch_flash_fwd_bshd` and :func:`_torch_flash_bwd_bshd`, the
  flat plain versions on the (b·h, s, d) rows with the lengths expanded
  over the heads (the reference's XLA path, ``:466-486``, ``:518-527``).
  The reference's ``flash_auto_crossover`` is a TPU finding and is not
  ported: on CUDA the kernel always runs.

* :func:`flash_attention` with ``layout="bhsd"`` (``:779-844``), forward
  and backward: the bh-flat family, q (..., sq, d) and k/v (..., sk, d)
  flattened to rows, with per-row ``kv_lens`` and the bucketed T5
  relative bias (:class:`BucketedBias`, ``:48-130``). A CUDA tensor
  launches :func:`flash_fwd_flat_cuda`, :func:`flash_bwd_flat_dq_cuda`
  and :func:`flash_bwd_flat_dkv_cuda` (``apex_flash_fwd_flat`` of
  ``csrc/flash_attn_fwd.cu`` and the backward pair of
  ``flash_attn_bwd.cu``, replacing the Pallas ``flash_fwd``,
  ``flash_bwd`` and ``_dtable_pallas``: the dK/dV kernel also sums the
  bucket-table gradient); a CPU tensor runs :func:`_torch_flash_fwd_flat`
  and :func:`_torch_flash_bwd_flat`. The operands may be the transposed
  (b, h, s, d) views of a projection output: the kernels take batch, head
  and row strides, so no copy is made.

* The additive array ``bias`` (hb, sq, sk) of both layouts (``:709-724``):
  cast to fp32 once, added in the kernels to the scaled scores before the
  masks, row r reading bias row r % hb; its gradient, the unscaled dS
  summed over the rows that share a bias row, comes from a third backward
  kernel, :func:`flash_bwd_dbias_cuda` (``csrc/flash_attn_dbias.cu``,
  replacing the Pallas ``_dbias_pallas``).

Every path runs Hopper's ``wgmma``/TMA kernels, one body each for the
three layouts: the forward (:func:`_fwd_plan`: its maps, the bias's
staging, the tiles), the backward pair (:func:`_bwd_plan`) — the dQ kernel
first: it writes delta = rowsum(do·o) (:func:`bwd_delta` is its plain
version), which the dK/dV kernel and the dbias kernel read — and dbias
(:func:`_dbias_plan`: the sharing rows split into groups summed in a
fixed order). ``variant="sm80"`` on the ``_cuda`` wrappers, and only
there, runs the first ``mma.sync`` kernels instead
(``csrc/flash_attn_fwd_sm80.cu``, ``flash_attn_bwd_sm80.cu``,
``flash_attn_dbias_sm80.cu``), for the A/B timing and the tests.

Dropout (``:700-737``): every entry takes ``dropout_rate`` and a
``dropout_seed`` (an int32 value kept on the host). The mask is the
reference's counter hash, :func:`dropout_keep` (``pallas/attention.py:
56-96``), of (q-head row t = the flattened batch·head row, query row, key
column): a pure function of the seed, rebuilt by the backward and by a
recompute, never saved. The probabilities' normaliser stays un-dropped;
the kept probabilities are scaled by float32(1/(1 - rate)). On a CUDA
tensor the wgmma kernels evaluate it per score — the forward, dQ and
dK/dV with or without either bias, and dbias, whose dS takes the dropped
dP — and the plain versions materialise it (:func:`_dropout_keep_dense`).
It is refused on the sm80 variant. :func:`seed_from_key` draws a seed from
a ``torch.Generator`` (``apex_tpu/ops/attention.py:881``).

fp16 (amp's strict-fp16 GPT step): the packed entries' wgmma kernels have
fp16 instances (``apex_flash_fwd_f16``, ``apex_flash_bwd_dq_f16``,
``apex_flash_bwd_dkv_f16``) without dropout, ``kv_lens`` or a bias; the
plain versions run at fp16 as they are. The other entries refuse fp16
(:data:`FP16_FAMILY`), as do dropout and the sm80 variant; ``f16_launches``
counts the fp16 launches. :func:`flash_attention` applies the O1 cast
(``apply_op_rules("attention", ...)``) first.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch.amp.lists import apply_op_rules
from apex_tpu_torch.ops import _backend, _build
from apex_tpu_torch.ops.matmul import _sm_count

#: masked-score value (``apex_tpu/ops/pallas/attention.py:33``)
NEG_INF = -1e30

#: head dims the flash kernels are compiled for
KERNEL_HEAD_DIMS = (64, 128)
#: the longest sequence the kernels' grids cover (65535 tiles of 32 rows)
KERNEL_MAX_SEQ = 65535 * 32
#: the flash kernels' element types: bf16 on every entry and option; fp16
#: (the wgmma kernels' fp16 instances, for amp's strict-fp16 GPT step) on
#: the packed entry, without dropout, kv_lens or a bias
KERNEL_DTYPES = (torch.bfloat16, torch.float16)
#: where fp16 is refused, with the ROADMAP item that brings it
FP16_FAMILY = ("the bh-flat and bshd flash entries and dbias take bfloat16; "
               "fp16 runs on the packed entry (ROADMAP queue 2, item 6: fp16 "
               "on the bh-flat and bshd flash and dbias)")
FP16_DROPOUT = ("fp16 with dropout is not ported: the kDrop instances are "
                "bf16 (ROADMAP queue 2, item 6: fp16 in dropout.cu and the "
                "kDrop instances)")
SM80_FP16 = ("the sm80 variant has no fp16 instance (ROADMAP, Simplicity "
             "items: the sm80 kernels' deletion); use the wgmma variant")


def bshd_qkv_projection(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], h: int, h_kv: int,
                        d: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(b, s, H) through the packed ((h + 2·h_kv)·d, H) weight → q
    (b, s, h, d), k/v (b, s, h_kv, d)."""
    b, s = x.shape[0], x.shape[1]
    y = F.linear(x, weight, bias)
    q = y[..., :h * d].reshape(b, s, h, d)
    k = y[..., h * d:(h + h_kv) * d].reshape(b, s, h_kv, d)
    v = y[..., (h + h_kv) * d:].reshape(b, s, h_kv, d)
    return q, k, v


def bshd_output_projection(ctx: torch.Tensor, weight: torch.Tensor, h: int,
                           d: int) -> torch.Tensor:
    """(b, s, h, d) context through the (O, h·d) output weight → (b, s, O)."""
    b, s = ctx.shape[0], ctx.shape[1]
    return F.linear(ctx.reshape(b, s, h * d), weight)


def packed_kernel_ok(s: int, h: int, d: int, dtype: torch.dtype) -> bool:
    """What the CUDA flash kernels take — the port's counterpart of
    ``bshd_kernel_ok`` (``apex_tpu/ops/attention.py:394-403``): bf16 or
    fp16 (:data:`KERNEL_DTYPES`; fp16 on the packed entry only, without
    dropout), a head dim of 64 or 128, any sequence length up to
    :data:`KERNEL_MAX_SEQ` (the ragged last tile is masked in-kernel), any
    number of heads. The reference's gate refuses fp16 (Mosaic has no
    f16); Hopper's tensor cores take it."""
    return (dtype in KERNEL_DTYPES and d in KERNEL_HEAD_DIMS
            and 1 <= s <= KERNEL_MAX_SEQ and h >= 1)


# --- the bucketed relative position bias --------------------------------------

#: the most buckets a table may have (``ops/attention.py:140-153``)
MAX_BUCKETS = 128
#: the longest max_distance the kernels take: each keeps one fp32 value per
#: clamped offset, 2·max_distance + 1 of them, in shared memory
KERNEL_MAX_DISTANCE = 4096


@functools.lru_cache(maxsize=None)
def _log_thresholds(num_buckets: int, max_exact: int,
                    max_distance: int) -> Tuple[int, ...]:
    """The smallest distance n of each log-spaced bucket past the first:
    bucket ``max_exact + j`` (j = 1 .. R - 1, R = num_buckets − max_exact)
    starts where ``floor(R · log(n / max_exact) / log(max_distance /
    max_exact)) >= j``, i.e. ``n^R >= max_distance^j · max_exact^(R − j)``
    — decided in Python's exact integers, so no log rounds a bucket
    boundary either way."""
    r = num_buckets - max_exact
    out = []
    for j in range(1, r):
        rhs = max_distance ** j * max_exact ** (r - j)
        n = max(max_exact, int(round(rhs ** (1.0 / r))) - 2)
        while n ** r < rhs:
            n += 1
        while n > max_exact and (n - 1) ** r >= rhs:
            n -= 1
        out.append(n)
    return tuple(out)


def _check_bucketing(bidirectional: bool, num_buckets: int,
                     max_distance: int) -> None:
    nb = num_buckets // 2 if bidirectional else num_buckets
    if nb < 2:
        raise ValueError(
            f"num_buckets={num_buckets} (bidirectional={bidirectional}) "
            f"leaves fewer than 2 buckets per side: no exact range")
    if max_distance <= nb // 2:
        raise ValueError(
            f"max_distance ({max_distance}) must exceed the exact range "
            f"({nb // 2} buckets per side for num_buckets={num_buckets}, "
            f"bidirectional={bidirectional}): the log-spaced buckets span "
            f"log(max_distance / {nb // 2}), which must be positive")


def relative_position_bucket(rel_pos: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's relative-position bucketing (``ops/pallas/attention.py:119-145``)
    on an integer tensor ``rel_pos = key_pos - query_pos``: half the
    buckets hold exact small offsets, the other half log-spaced larger
    ones up to ``max_distance``; bidirectional tables split the range by
    sign, causal ones clamp the future to bucket 0. The log range is
    decided by exact integer thresholds (:func:`_log_thresholds`); the
    reference's float32 ``log`` gives the same buckets wherever
    ``max_distance`` exceeds the exact range (the tests hold both at every
    offset), which this function requires."""
    _check_bucketing(bidirectional, num_buckets, max_distance)
    n = -rel_pos.long()
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    thr = torch.tensor(_log_thresholds(num_buckets, max_exact, max_distance),
                       dtype=torch.long, device=n.device)
    large = max_exact + (n[..., None] >= thr).sum(-1)
    return (ret + torch.where(n < max_exact, n, large)).to(rel_pos.dtype)


@functools.lru_cache(maxsize=None)
def _offset_buckets(bidirectional: bool, num_buckets: int,
                    max_distance: int, device: torch.device) -> torch.Tensor:
    """(2·max_distance + 1,) int32: the bucket of each clamped offset
    −max_distance .. max_distance; from max_distance on every offset falls
    into its side's last bucket, so these cover all offsets."""
    rel = torch.arange(-max_distance, max_distance + 1, dtype=torch.int32)
    return relative_position_bucket(
        rel, bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance).to(device)


@dataclasses.dataclass
class BucketedBias:
    """T5's bucketed relative position bias as an attention operand
    (``apex_tpu/ops/attention.py:48-130``): the ``(num_buckets, heads)``
    table and its bucketing, recomputed per score tile inside the flash
    kernels, never as an (heads, sq, sk) array. ``q_offset``/``k_offset``
    are the global positions of query row 0 and key row 0 (0 unless the
    sequence is cut into pieces). ``bidirectional=True`` is the encoder's
    sign-split bucketing, False the decoder's (the future clamps to bucket
    0). Differentiable in ``table``: the flash backward returns its
    (num_buckets, heads) cotangent."""

    table: torch.Tensor          # (num_buckets, heads)
    bidirectional: bool = False
    max_distance: int = 128
    q_offset: int = 0
    k_offset: int = 0
    # the kernels' lookup and buckets, kept while the table is unchanged
    # (its storage and version counter): the decode engines make one bias
    # a step and hand it to every layer's kernel
    _operands: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def num_buckets(self) -> int:
        return self.table.shape[0]

    @property
    def heads(self) -> int:
        return self.table.shape[1]

    def buckets(self, sq: int, sk: int) -> torch.Tensor:
        """(sq, sk) bucket of each score at these offsets."""
        dev = self.table.device
        rel = ((self.k_offset + torch.arange(sk, device=dev))[None, :]
               - (self.q_offset + torch.arange(sq, device=dev))[:, None])
        return relative_position_bucket(
            rel, bidirectional=self.bidirectional,
            num_buckets=self.num_buckets, max_distance=self.max_distance)

    def materialize(self, sq: int, sk: int) -> torch.Tensor:
        """The (heads, sq, sk) fp32 bias this operand stands for — the
        plain versions' form; the kernels never build it."""
        return self.table.float()[self.buckets(sq, sk)].permute(2, 0, 1)

    def kernel_operands(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """The kernels' operands: the per-head lookup (heads, 2·max_distance
        + 1) fp32 of the table's value at each clamped offset, the
        offsets' buckets (2·max_distance + 1,) int32, and ``k_offset −
        q_offset``."""
        t = self.table
        key = (t.data_ptr(), t._version, t.device, t.dtype, tuple(t.shape),
               self.bidirectional, self.max_distance)
        if self._operands is None or self._operands[0] != key:
            bucket = _offset_buckets(self.bidirectional, self.num_buckets,
                                     self.max_distance, t.device)
            lut = t.detach().float().t()[:, bucket.long()].contiguous()
            self._operands = (key, lut, bucket)
        _, lut, bucket = self._operands
        return lut, bucket, int(self.k_offset - self.q_offset)


def _validate_bucketed(bias: BucketedBias) -> None:
    if not isinstance(bias.table, torch.Tensor) or bias.table.ndim != 2:
        raise ValueError(
            f"BucketedBias.table must be (num_buckets, heads); got "
            f"{getattr(bias.table, 'shape', type(bias.table))}")
    nb = bias.num_buckets
    if not 2 <= nb <= MAX_BUCKETS:
        raise ValueError(f"num_buckets must be in [2, {MAX_BUCKETS}]; got "
                         f"{nb}")
    if bias.bidirectional and nb % 2:
        raise ValueError(
            f"bidirectional bucketing splits the range by sign and needs "
            f"an even num_buckets; got {nb}")
    _check_bucketing(bias.bidirectional, nb, bias.max_distance)


def _table_grad(bias: BucketedBias, dbias: torch.Tensor) -> torch.Tensor:
    """(num_buckets, heads) fp32 table cotangent from the (heads, sq, sk)
    bias cotangent: the gather's VJP, a sum by bucket
    (``_bucketed_table_grad``, ``:156-169``)."""
    hb, sq, sk = dbias.shape
    idx = bias.buckets(sq, sk).reshape(-1).long()
    out = torch.zeros((bias.num_buckets, hb), dtype=torch.float32,
                      device=dbias.device)
    return out.index_add_(0, idx, dbias.float().reshape(hb, -1).t())


# --- the counter-hash dropout mask --------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 on uint32 values held in int64 (``pallas/
    attention.py:56-63``). A product of two uint32 values can pass 2^63
    and wrap; its low 32 bits survive, so every multiply is masked."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _u32(x) -> Union[int, torch.Tensor]:
    """An int32 (or any integer) value, tensor or int, as its uint32 bits
    in int64."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def dropout_threshold(rate: float) -> int:
    """The 24-bit keep threshold (``pallas/attention.py:84``): Python's
    round (half to even) of rate·2^24 on the double, at most 2^24."""
    return min(1 << 24, int(round(rate * (1 << 24))))


def dropout_scale(rate: float) -> float:
    """The flash kernels' multiplier of a kept probability:
    float32(1 / (1 - rate)) (``pallas/attention.py:95``)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def dropout_keep(seed, t, rows, cols, rate: float) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask of score elements (rows, cols) of
    q-head row ``t`` (``pallas/attention.py:66-86``, bit for bit): key =
    fmix(seed ^ t·0x9E3779B9), row_key = fmix(key ^ row), keep iff
    (fmix(row_key ^ col) >> 8) >= the 24-bit threshold. ``seed`` an int32
    (its bits read as uint32; an int or a tensor), ``t``/``rows``/``cols``
    integer tensors or ints that broadcast; ``rate`` a float. A pure
    function of (seed, coordinates): the forward, the backward and a
    recompute under remat rebuild the same mask."""
    key = _fmix32(torch.as_tensor(_u32(seed) ^ ((_u32(t) * _GOLDEN) & _M32)))
    h = _fmix32(_fmix32(key ^ _u32(rows)) ^ _u32(cols))
    return (h >> 8) >= dropout_threshold(rate)


def _dropout_keep_dense(seed, lead, sq: int, sk: int, rate: float,
                        device=None) -> torch.Tensor:
    """(*lead, sq, sk) bool keep mask of the scores of the rows over the
    leading dims ``lead``, flattened in order to the q-head rows t
    (``apex_tpu/ops/attention.py:210-222``)."""
    lead = tuple(lead)
    n = 1
    for x in lead:
        n *= x
    t = torch.arange(n, device=device).reshape(*lead, 1, 1)
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return dropout_keep(seed, t, rows, cols, rate)


def _dropout_apply_dense(x: torch.Tensor, keep: torch.Tensor,
                         rate: float) -> torch.Tensor:
    """where(keep, x · float32(1/(1 - rate)), 0) (``:225-228``)."""
    return torch.where(keep, x * dropout_scale(rate), 0.0)


def _check_dropout(dropout_rate: float, dropout_seed) -> Optional[int]:
    """The dropout arguments as the kernels and plain versions take them:
    None without dropout, else the seed as a host int (an int, or an int
    tensor of one element: its value is read once here)."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate == 0.0:
        return None
    if dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    return int(dropout_seed)


def seed_from_key(key: torch.Generator) -> int:
    """One int32 dropout seed drawn from a ``torch.Generator``, as a host
    int (``apex_tpu/ops/attention.py:881``: 32 random bits of a PRNG key as
    an int32). The one place every module of the port draws its
    counter-hash seeds; torch cannot reproduce the reference's threefry
    bits, so the CPU tests pass the reference's int instead."""
    if not isinstance(key, torch.Generator):
        raise TypeError(f"seed_from_key takes a torch.Generator; got "
                        f"{type(key).__name__}")
    return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=key,
                             device=key.device, dtype=torch.int64))


def key_seed(key: Union[torch.Generator, int, torch.Tensor]) -> int:
    """The dropout seed of a module's ``key=``: :func:`seed_from_key` of a
    ``torch.Generator``, or an int32 seed as given (an int or a
    one-element integer tensor; the CPU tests pass the int the reference's
    ``seed_from_key`` returns)."""
    if isinstance(key, torch.Generator):
        return seed_from_key(key)
    seed = int(key)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"a dropout seed is an int32; got {seed}")
    return seed


# --- plain version ------------------------------------------------------------

def masked_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                  causal: bool, kv_lens: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 scaled scores over (..., seq, d) with the bottom-right-aligned
    causal mask (masked entries :data:`NEG_INF`). ``kv_lens`` (rows,)
    masks each row's columns >= its length; ``bias`` (hb, sq, sk) is added
    to the scaled scores BEFORE the masks, row ``r`` reading bias row
    ``r % hb``. Both need the 3D (rows, sq, d) layout."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    if (bias is not None or kv_lens is not None) and s.ndim != 3:
        raise ValueError("kv_lens and bias need 3D (rows, sq, sk) scores; "
                         "flatten the leading dims to rows first")
    if bias is not None:
        hb = bias.shape[0]
        s = (s.reshape(-1, hb, sq, sk) + bias.float()).reshape(s.shape)
    if causal:
        mask = (torch.arange(sk, device=s.device)[None, :]
                <= torch.arange(sq, device=s.device)[:, None] + (sk - sq))
        s = torch.where(mask, s, NEG_INF)
    if kv_lens is not None:
        cols = torch.arange(sk, device=s.device)
        s = torch.where(cols[None, None, :] < kv_lens[:, None, None], s,
                        NEG_INF)
    return s


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, causal: bool,
                   kv_lens: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, s, d) q/k/v → (o in q's dtype, fp32 lse); p is rounded to q's
    dtype before the PV product. A row of kv length 0 gets o = 0 and
    lse = 0 (``:238-246``), so the backward's p = exp(NEG_INF - 0) is 0.
    With ``dropout_rate > 0`` (``:231-245``) lse stays un-dropped and the
    PV product takes p masked by :func:`dropout_keep` on the rows of the
    leading dims, flattened in order, and scaled by float32(1/(1 - r))."""
    s = masked_scores(q, k, scale, causal, kv_lens, bias)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if dropout_rate > 0.0:
        p = _dropout_apply_dense(p, _dropout_keep_dense(
            dropout_seed, s.shape[:-2], s.shape[-2], s.shape[-1],
            dropout_rate, s.device), dropout_rate)
    o = torch.einsum("...qk,...kd->...qd", p.to(q.dtype).float(), v.float())
    if kv_lens is not None:
        dead = (kv_lens == 0)[:, None]
        o = torch.where(dead[..., None], 0.0, o)
        lse = torch.where(dead, 0.0, lse)
    return o.to(q.dtype), lse


def _split_packed(qkv: torch.Tensor, h: int, h_kv: int, d: int):
    """Packed (b, s, (h+2·h_kv)·d) → q (b, h_kv, group, s, d) and k/v
    (b, h_kv, s, d): query head t = kv_head·group + i reads kv head t //
    group, with no repeat of k/v."""
    b, s, _ = qkv.shape
    group = h // h_kv
    q = qkv[..., :h * d].reshape(b, s, h_kv, group, d).permute(0, 2, 3, 1, 4)
    k = qkv[..., h * d:(h + h_kv) * d].reshape(b, s, h_kv, d).transpose(1, 2)
    v = qkv[..., (h + h_kv) * d:].reshape(b, s, h_kv, d).transpose(1, 2)
    return q, k, v


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, h_kv, group, s, d) or (b, h_kv, s, d) → (b, s, heads·d)."""
    if x.ndim == 5:
        b, hk, g, s, d = x.shape
        return x.permute(0, 3, 1, 2, 4).reshape(b, s, hk * g * d)
    b, hk, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, hk * d)


def _torch_flash_fwd(qkv, h, h_kv, d, scale, causal, dropout_rate=0.0,
                     dropout_seed=None):
    b, s, _ = qkv.shape
    q, k, v = _split_packed(qkv, h, h_kv, d)
    # the (b, h_kv, group) leading dims flatten to t = b·h + head
    o, lse = _xla_attention(q, k[:, :, None], v[:, :, None], scale, causal,
                            dropout_rate=dropout_rate,
                            dropout_seed=dropout_seed)
    return _merge_heads(o), lse.reshape(b, h, s)


def _torch_flash_bwd(qkv, o, lse, do, h, h_kv, d, scale, causal,
                     dropout_rate=0.0, dropout_seed=None):
    """The backward of :func:`_torch_flash_fwd` with the Pallas kernels'
    rounding points (``_bwd_single_block_kernel``, ``:568-589``):
    delta = rowsum(do·o) in fp32; dV from p rounded to do's dtype; dS =
    p·(dP − delta)·scale rounded to q's dtype before dQ and dK; every
    product accumulates in fp32 and the kv-group sum happens in fp32
    before the one cast. With dropout (``:295-345``) the mask is rebuilt
    from the seed: dV takes p∘M/(1−r), dS = p·(M/(1−r)∘dP − delta)."""
    b, s, _ = qkv.shape
    group = h // h_kv
    dt = qkv.dtype
    q, k, v = _split_packed(qkv, h, h_kv, d)
    split = lambda x: x.reshape(b, s, h_kv, group, d).permute(  # noqa: E731
        0, 2, 3, 1, 4).float()
    dof, of = split(do), split(o)
    sc = masked_scores(q, k[:, :, None], scale, causal)
    p = torch.exp(sc - lse.reshape(b, h_kv, group, s)[..., None])
    del sc
    delta = bwd_delta(of, dof)[..., None]
    keep = (None if dropout_rate == 0.0 else _dropout_keep_dense(
        dropout_seed, p.shape[:-2], s, s, dropout_rate, p.device))
    pd = p if keep is None else _dropout_apply_dense(p, keep, dropout_rate)
    dv = torch.einsum("bngqk,bngqd->bnkd", pd.to(dt).float(), dof)
    del pd
    dp = torch.einsum("bngqd,bnkd->bngqk", dof, v.float())
    if keep is not None:
        dp = _dropout_apply_dense(dp, keep, dropout_rate)
        del keep
    ds = (p * (dp - delta) * scale).to(dt).float()
    del p, dp
    dq = torch.einsum("bngqk,bnkd->bngqd", ds, k.float())
    dk = torch.einsum("bngqk,bngqd->bnkd", ds, q.float())
    return (_merge_heads(dq.to(dt)), _merge_heads(dk.to(dt)),
            _merge_heads(dv.to(dt)))


def _repeat_kv(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(bh_kv, s, d) → (rows, s, d): q row r reads kv row r // group."""
    group = rows // x.shape[0]
    return x.repeat_interleave(group, 0) if group > 1 else x


def _torch_flash_fwd_flat(q, k, v, scale, causal, kv_lens=None, bias=None,
                          dropout_rate=0.0, dropout_seed=None):
    """q (bh, sq, d), k/v (bh_kv, sk, d), kv_lens (bh,) or None, bias
    (hb, sq, sk) fp32 or None → (o (bh, sq, d), lse (bh, sq)); dropout
    keyed by the q row t."""
    return _xla_attention(q, _repeat_kv(k, q.shape[0]),
                          _repeat_kv(v, q.shape[0]), scale, causal, kv_lens,
                          bias, dropout_rate, dropout_seed)


def _torch_flash_bwd_flat(q, k, v, o, lse, do, scale, causal, kv_lens=None,
                          bias=None, delta=None, dropout_rate=0.0,
                          dropout_seed=None):
    """The backward of :func:`_torch_flash_fwd_flat` with the Pallas
    kernels' rounding points (``_bwd_dq_kernel``/``_bwd_dkv_kernel``,
    ``:869-1018``): p = exp(s − lse); delta = rowsum(do·o) in fp32 (given,
    (bh, sq), as the dQ kernel hands it to dK/dV, or computed); dV from
    p rounded to do's dtype; the unscaled dS = p·(dP − delta) in fp32,
    summed over the rows sharing each bias row for dbias (hb, sq, sk);
    dS·scale rounded to q's dtype before dQ and dK; kv-group sums in fp32
    before the one cast. With dropout the mask M is rebuilt from the seed:
    dV from p∘M/(1−r), dS = p·(M/(1−r)∘dP − delta) (``:295-345``).
    Returns (dq, dk, dv, dbias or None)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    group = bh // k.shape[0]
    dt = q.dtype
    s = masked_scores(q, _repeat_kv(k, bh), scale, causal, kv_lens, bias)
    p = torch.exp(s - lse[..., None])
    del s
    dof = do.float()
    delta = (bwd_delta(o, do) if delta is None else delta)[..., None]
    keep = (None if dropout_rate == 0.0 else _dropout_keep_dense(
        dropout_seed, (bh,), sq, sk, dropout_rate, p.device))
    pd = p if keep is None else _dropout_apply_dense(p, keep, dropout_rate)
    dv = torch.einsum("bqk,bqd->bkd", pd.to(dt).float(), dof)
    del pd
    dp = torch.einsum("bqd,bkd->bqk", dof, _repeat_kv(v, bh).float())
    if keep is not None:
        dp = _dropout_apply_dense(dp, keep, dropout_rate)
        del keep
    ds = p * (dp - delta)
    del p, dp
    dbias = (None if bias is None
             else ds.reshape(-1, bias.shape[0], sq, sk).sum(0))
    ds = (ds * scale).to(dt).float()
    dq = torch.einsum("bqk,bkd->bqd", ds, _repeat_kv(k, bh).float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    if group > 1:
        dk = dk.reshape(-1, group, sk, d).sum(1)
        dv = dv.reshape(-1, group, sk, d).sum(1)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype), dbias


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d) → (b·h, s, d) rows, b-major (``:431-438``)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _from_bh(x: torch.Tensor, b: int) -> torch.Tensor:
    """(b·h, s, d) rows → a contiguous (b, s, h, d) tensor."""
    return x.reshape(b, -1, *x.shape[1:]).transpose(1, 2).contiguous()


def _expand_lens_bh(kv_lens: Optional[torch.Tensor],
                    h: int) -> Optional[torch.Tensor]:
    """(b,) per-batch lengths → (b·h,) per-row, in :func:`_to_bh`'s row
    order (``_expand_lens_bh``, ``:452-455``)."""
    return None if kv_lens is None else kv_lens.repeat_interleave(h)


def _torch_flash_fwd_bshd(q, k, v, scale, causal, kv_lens=None, bias=None,
                          dropout_rate=0.0, dropout_seed=None):
    """q (b, sq, h, d), k/v (b, sk, h_kv, d), kv_lens (b,) or None, bias
    (hb, sq, sk) fp32 with hb | h or None → (o (b, sq, h, d), lse (b, h,
    sq)): the flat plain version on the (b·h, s, d) rows (dropout's t =
    b·h + head), bottom-right causal alignment ``off = sk − sq``."""
    b, sq, h, _ = q.shape
    o, lse = _torch_flash_fwd_flat(_to_bh(q), _to_bh(k), _to_bh(v), scale,
                                   causal, _expand_lens_bh(kv_lens, h), bias,
                                   dropout_rate, dropout_seed)
    return _from_bh(o, b), lse.reshape(b, h, sq)


def _torch_flash_bwd_bshd(q, k, v, o, lse, do, scale, causal, kv_lens=None,
                          bias=None, dropout_rate=0.0, dropout_seed=None):
    """The backward of :func:`_torch_flash_fwd_bshd` through the flat plain
    version: (dq (b, sq, h, d), dk, dv (b, sk, h_kv, d), dbias (hb, sq, sk)
    fp32 or None)."""
    b, sq, h, _ = q.shape
    dq, dk, dv, dbias = _torch_flash_bwd_flat(
        _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(o), lse.reshape(b * h, sq),
        _to_bh(do), scale, causal, _expand_lens_bh(kv_lens, h), bias,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return _from_bh(dq, b), _from_bh(dk, b), _from_bh(dv, b), dbias


# --- the CUDA kernels ---------------------------------------------------------

def _check_packed(qkv: torch.Tensor, h: int, h_kv: int, d: int,
                  name: str) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if qkv.ndim != 3 or h < 1 or h_kv < 1 or h % h_kv \
            or qkv.shape[2] != (h + 2 * h_kv) * d:
        raise ValueError(
            f"{name}: qkv must be (b, s, (h + 2*h_kv)*d) with h_kv | h; got "
            f"{tuple(qkv.shape)} for h={h}, h_kv={h_kv}, d={d}")
    if not packed_kernel_ok(qkv.shape[1], h, d, qkv.dtype):
        raise ValueError(
            f"{name}: the flash kernels take bfloat16 or float16, head_dim in "
            f"{KERNEL_HEAD_DIMS} and 1 <= s <= {KERNEL_MAX_SEQ}; got "
            f"{qkv.dtype}, d={d}, s={qkv.shape[1]}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte "
                         f"aligned (the kernels copy 16-byte chunks)")


def _check_like(name: str, t: torch.Tensor, shape, dtype, ref) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != ref.device:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on "
                         f"{ref.device}; got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_fwd_cuda(qkv: torch.Tensor, h: int, h_kv: int, d: int, *,
                   scale: float, causal: bool, dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None,
                   variant: Optional[str] = None,
                   planted_fault: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash forward kernel on the packed buffer. Returns o
    (b, s, h·d) in qkv's dtype (bf16, or fp16: the fp16 instance, on the
    wgmma variant without dropout; ``planted_fault`` then names one of
    :data:`FP16_FAULTS`) and lse (b, h, s) fp32. ``dropout_rate > 0`` drops
    the probabilities in the kernel by :func:`dropout_keep` of
    ``dropout_seed`` (a host int), q-head row t = b·h + head; lse stays
    the un-dropped one. ``variant`` and ``planted_fault`` are for the A/B
    timing and the kernel checks (:func:`_fwd_plan`, :func:`_planted`,
    :data:`DROPOUT_FAULTS`). Counts its launches in ``.launches``, by
    variant in ``.wgmma_launches`` and ``.sm80_launches`` and those with
    dropout in ``.dropout_launches``."""
    _check_packed(qkv, h, h_kv, d, "flash_fwd_cuda")
    b, s, _ = qkv.shape
    out = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    plan = _packed_fwd_plan(qkv, h, h_kv, d, variant)
    f16 = qkv.dtype == torch.float16
    if f16:
        rc = _build.library().apex_flash_fwd_f16(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h, h_kv, d,
            int(causal), float(scale),
            _f16_fault("flash_fwd_cuda", plan, dropout_rate, planted_fault),
            stream)
    else:
        kv_lens, _, _, _ = _planted(planted_fault, None, (h, 1), None, None,
                                    b, h, s, qkv.device)
        drop = _drop_args(dropout_rate, dropout_seed, plan, planted_fault,
                          "flash_fwd_cuda")
        rc = _build.library().apex_flash_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(kv_lens), b,
            s, h, h_kv, d, int(causal), float(scale),
            int(plan.variant == "wgmma"), *drop, stream)
    _build.check(rc, "flash_fwd")
    _count(flash_fwd_cuda, plan, dropout=dropout_rate, f16=f16)
    return out, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.wgmma_launches = 0
flash_fwd_cuda.sm80_launches = 0
flash_fwd_cuda.dropout_launches = 0
flash_fwd_cuda.f16_launches = 0


def _check_bwd(qkv, o, lse, do, h, h_kv, d, name):
    _check_packed(qkv, h, h_kv, d, name)
    b, s, _ = qkv.shape
    _check_like("o", o, (b, s, h * d), qkv.dtype, qkv)
    _check_like("do", do, (b, s, h * d), qkv.dtype, qkv)
    _check_like("lse", lse, (b, h, s), torch.float32, qkv)
    return b, s


def _packed_views(qkv: torch.Tensor, h: int, h_kv: int, d: int):
    """q (b, h, s, d), k and v (b, h_kv, s, d): the packed buffer's three
    sections as the backward kernels' strided views, no copy."""
    def heads(lo, n):
        return qkv[..., lo * d:(lo + n) * d].unflatten(-1, (n, d)).transpose(
            1, 2)
    return heads(0, h), heads(h, h_kv), heads(h + h_kv, h_kv)


def _heads4(x: torch.Tensor, d: int) -> torch.Tensor:
    """A (b, s, heads·d) tensor as a (b, heads, s, d) view."""
    return x.unflatten(-1, (x.shape[-1] // d, d)).transpose(1, 2)


def flash_bwd_dq_cuda(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                      do: torch.Tensor, h: int, h_kv: int, d: int, *,
                      scale: float, causal: bool, dropout_rate: float = 0.0,
                      dropout_seed: Optional[int] = None,
                      variant: Optional[str] = None,
                      planted_fault: Optional[str] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the dQ kernel on the packed buffer: dq (b, s, h·d) bf16 and
    delta (b·h, s) fp32 = rowsum(do·o), which the dK/dV kernel reads
    (None on the ``"sm80"`` variant). ``variant`` and ``planted_fault``
    are for the A/B timing and the kernel checks (:func:`_bwd_plan`,
    :func:`_planted`). ``dropout_rate``/``dropout_seed`` as the forward's:
    dP is masked and rescaled before dS. Counts launches in ``.launches``,
    by variant in ``.wgmma_launches`` and ``.sm80_launches`` and with
    dropout in ``.dropout_launches``."""
    name = "flash_bwd_dq_cuda"
    b, s = _check_bwd(qkv, o, lse, do, h, h_kv, d, name)
    dq = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    q4, k4, v4 = _packed_views(qkv, h, h_kv, d)
    plan, delta = _launch_dq(
        name, q4, k4, v4, _heads4(o, d), _heads4(do, d), _heads4(dq, d), lse,
        scale=scale, causal=causal, dropout=(dropout_rate, dropout_seed),
        variant=variant, planted_fault=planted_fault)
    _count(flash_bwd_dq_cuda, plan, dropout=dropout_rate,
           f16=qkv.dtype == torch.float16)
    return dq, delta


flash_bwd_dq_cuda.launches = 0
flash_bwd_dq_cuda.wgmma_launches = 0
flash_bwd_dq_cuda.sm80_launches = 0
flash_bwd_dq_cuda.dropout_launches = 0
flash_bwd_dq_cuda.f16_launches = 0


def flash_bwd_dkv_cuda(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                       do: torch.Tensor, h: int, h_kv: int, d: int, *,
                       scale: float, causal: bool,
                       delta: Optional[torch.Tensor] = None,
                       dropout_rate: float = 0.0,
                       dropout_seed: Optional[int] = None,
                       variant: Optional[str] = None,
                       planted_fault: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on the packed buffer: dk, dv (b, s, h_kv·d)
    bf16, each kv group's query heads summed in fp32. The ``"wgmma"``
    variant reads ``delta`` from :func:`flash_bwd_dq_cuda` (call it
    first). With dropout, dV takes the dropped and rescaled p and dP is
    masked before dS. Counts launches in ``.launches``,
    ``.wgmma_launches``, ``.sm80_launches`` and ``.dropout_launches``."""
    name = "flash_bwd_dkv_cuda"
    b, s = _check_bwd(qkv, o, lse, do, h, h_kv, d, name)
    dk = torch.empty((b, s, h_kv * d), dtype=qkv.dtype, device=qkv.device)
    dv = torch.empty_like(dk)
    q4, k4, v4 = _packed_views(qkv, h, h_kv, d)
    plan = _launch_dkv(
        name, q4, k4, v4, _heads4(o, d), _heads4(do, d), _heads4(dk, d),
        _heads4(dv, d), lse, delta, scale=scale, causal=causal,
        dropout=(dropout_rate, dropout_seed), variant=variant,
        planted_fault=planted_fault)
    _count(flash_bwd_dkv_cuda, plan, dropout=dropout_rate,
           f16=qkv.dtype == torch.float16)
    return dk, dv


flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.wgmma_launches = 0
flash_bwd_dkv_cuda.sm80_launches = 0
flash_bwd_dkv_cuda.dropout_launches = 0
flash_bwd_dkv_cuda.f16_launches = 0


def _seq_major_ok(t: torch.Tensor) -> bool:
    """A (b, s, heads, d) operand as the bshd kernels read it: dense (head,
    feature) rows, 16-byte aligned (the kernels copy 16-byte chunks)."""
    return (t.stride(3) == 1 and t.stride(2) == t.shape[3]
            and t.stride(1) % 8 == 0 and t.stride(0) % 8 == 0
            and t.data_ptr() % 16 == 0)


def _check_seq_major(t: torch.Tensor, name: str) -> None:
    if not _seq_major_ok(t):
        raise ValueError(
            f"{name}: each (head, feature) row must be dense with 16-byte "
            f"aligned rows (the kernel copies 16-byte chunks); got strides "
            f"{t.stride()}")


def _check_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, name: str = "flash_fwd_bshd_cuda",
                kv_lens: Optional[torch.Tensor] = None) -> None:
    if any(t.device != q.device or t.device.type != "cuda"
           for t in (q, k, v)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    b, sq, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"{name}: q (b, sq, h, d) and k/v (b, sk, h_kv, d) with h_kv | h;"
            f" got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype == torch.float16:
        raise ValueError(f"{name}: {FP16_FAMILY}")
    if not packed_kernel_ok(sq, h, d, q.dtype) or k.dtype != q.dtype \
            or v.dtype != q.dtype or k.shape[1] > KERNEL_MAX_SEQ:
        raise ValueError(
            f"{name}: the flash kernels take bfloat16, head_dim in "
            f"{KERNEL_HEAD_DIMS} and 1 <= sq <= {KERNEL_MAX_SEQ}; got "
            f"{q.dtype}/{k.dtype}/{v.dtype}, d={d}, sq={sq}")
    if causal and sq > k.shape[1]:
        raise ValueError(f"{name}: causal attention requires sq <= sk; got "
                         f"sq={sq} > sk={k.shape[1]}")
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share their strides")
    for t in (q, k, v):
        _check_seq_major(t, name)
    if kv_lens is not None and (tuple(kv_lens.shape) != (b,)
                                or kv_lens.dtype != torch.int32
                                or kv_lens.device != q.device):
        raise ValueError(f"{name}: kv_lens must be per batch, ({b},) int32 "
                         f"on {q.device}; got {tuple(kv_lens.shape)} "
                         f"{kv_lens.dtype} on {kv_lens.device}")


def _check_bias(bias: Optional[torch.Tensor], rows: int, sq: int, sk: int,
                ref: torch.Tensor, name: str) -> int:
    """The array bias as the kernels take it: (hb, sq, sk) fp32,
    contiguous, on ``ref``'s device, hb dividing ``rows`` (the q-head rows
    on the flat layout, the heads on the bshd one). Returns hb (1 without
    a bias)."""
    if bias is None:
        return 1
    if bias.dtype != torch.float32 or bias.ndim != 3 \
            or tuple(bias.shape[1:]) != (sq, sk) or bias.shape[0] < 1 \
            or rows % bias.shape[0] or not bias.is_contiguous() \
            or bias.device != ref.device:
        raise ValueError(
            f"{name}: bias must be a contiguous (hb, {sq}, {sk}) float32 "
            f"tensor on {ref.device} with hb dividing {rows}; got "
            f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    return bias.shape[0]


def _count(fn, plan=None, bias=None, dropout=0.0, f16=False) -> None:
    """One launch of a wrapper: ``.launches``, by variant
    (``.wgmma_launches``, ``.sm80_launches``), with an array bias
    (``.bias_launches``), with dropout (``.dropout_launches``) and on the
    fp16 instance (``.f16_launches``)."""
    fn.launches += 1
    if f16:
        fn.f16_launches += 1
    if plan is not None:
        attr = f"{plan.variant}_launches"
        setattr(fn, attr, getattr(fn, attr) + 1)
    if bias is not None:
        fn.bias_launches += 1
    if dropout > 0.0:
        fn.dropout_launches += 1


def flash_fwd_bshd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool,
                        kv_lens: Optional[torch.Tensor] = None,
                        rel_bias: Optional[BucketedBias] = None,
                        bias: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        variant: Optional[str] = None,
                        planted_fault: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bshd flash forward: q (b, sq, h, d), k/v (b, sk, h_kv,
    d), bf16 — separate tensors or views into one buffer (the batch and
    row strides are passed through); kv_lens (b,) int32 per batch or None;
    the bucketed bias (its heads dividing h: head t reads table column t %
    heads), or an array bias (hb, sq, sk) fp32 with hb | h, or neither.
    Returns o (b, sq, h, d) bf16 and lse (b, h, sq) fp32. Dropout as
    :func:`flash_fwd_cuda`'s (q-head row t = b·h + head). Counts its
    launches in ``.launches``, by variant, those with an array bias in
    ``.bias_launches``, with the bucketed bias in ``.rel_launches`` and
    those with dropout in ``.dropout_launches``."""
    name = "flash_fwd_bshd_cuda"
    _check_bshd(q, k, v, causal, name, kv_lens)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    lut, _, rel_off, maxd, hb, _ = _flat_bias_args(rel_bias, bias, h, sq,
                                                   sk, q, name)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    kv_lens, _, run_bias, lut = _planted(planted_fault, kv_lens,
                                         _LENS_PER_BATCH, bias, lut, b, h,
                                         sk, q.device)
    if lut is None:
        maxd = rel_off = 0
    plan = _bshd_fwd_plan(q, k, v, run_bias, variant)
    drop = _drop_args(dropout_rate, dropout_seed, plan, planted_fault, name)
    rc = _build.library().apex_flash_fwd_bshd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(kv_lens), _ptr(run_bias), q.stride(0),
        k.stride(0), q.stride(1), k.stride(1), b, sq, sk, h, h_kv, d,
        int(causal), float(scale), hb, int(plan.variant == "wgmma"),
        int(plan.bias_staging == "tma"), *drop, _ptr(lut), maxd, rel_off,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_fwd_bshd")
    _count(flash_fwd_bshd_cuda, plan, bias, dropout_rate)
    if rel_bias is not None:
        flash_fwd_bshd_cuda.rel_launches += 1
    return out, lse


flash_fwd_bshd_cuda.launches = 0
flash_fwd_bshd_cuda.rel_launches = 0
flash_fwd_bshd_cuda.wgmma_launches = 0
flash_fwd_bshd_cuda.sm80_launches = 0
flash_fwd_bshd_cuda.bias_launches = 0
flash_fwd_bshd_cuda.dropout_launches = 0


def _check_bshd_bwd(q, k, v, o, lse, do, causal, kv_lens, bias, name):
    _check_bshd(q, k, v, causal, name, kv_lens)
    b, sq, h, d = q.shape
    for nm, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {nm} must be {tuple(q.shape)} "
                             f"{q.dtype}; got {tuple(t.shape)} {t.dtype}")
        _check_seq_major(t, name)
    _check_like("lse", lse, (b, h, sq), torch.float32, q)
    return _check_bias(bias, h, sq, k.shape[1], q, name)


def _bshd_views(*ts: torch.Tensor):
    """Seq-major (b, s, heads, d) tensors as the bh-flat kernels' (b,
    heads, s, d) views: their head-stride-d case, no copy."""
    return [t.transpose(1, 2) for t in ts]


# kv_lens strides (batch, head) of the seq-major layout: one length per
# batch, shared by its heads (the flat layout's are (heads, 1), per row)
_LENS_PER_BATCH = (1, 0)


def flash_bwd_bshd_dq_cuda(q, k, v, o, lse, do, *, scale: float,
                           causal: bool,
                           kv_lens: Optional[torch.Tensor] = None,
                           rel_bias: Optional[BucketedBias] = None,
                           bias: Optional[torch.Tensor] = None,
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None,
                           variant: Optional[str] = None,
                           planted_fault: Optional[str] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the dQ kernel on seq-major operands: q, o, do (b, sq, h, d),
    k, v (b, sk, h_kv, d) bf16, lse (b, h, sq) fp32, kv_lens (b,) int32 or
    None, the bucketed bias or an array bias (hb, sq, sk) fp32 or neither
    → dq (b, sq, h, d) bf16 and delta (b·h, sq) fp32 for the dK/dV kernel
    (None on ``"sm80"``); dropout as :func:`flash_bwd_dq_cuda`'s. Counts
    launches in ``.launches``, by variant, in ``.bias_launches``,
    ``.rel_launches`` and ``.dropout_launches``."""
    name = "flash_bwd_bshd_dq_cuda"
    _check_bshd_bwd(q, k, v, o, lse, do, causal, kv_lens, bias, name)
    b, sq, h, d = q.shape
    lut, _, rel_off, maxd, hb, _ = _flat_bias_args(rel_bias, bias, h, sq,
                                                   k.shape[1], q, name)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    plan, delta = _launch_dq(
        name, *_bshd_views(q, k, v, o, do, dq), lse, scale=scale,
        causal=causal, kv_lens=kv_lens, lens_strides=_LENS_PER_BATCH,
        lut=lut, rel_off=rel_off, maxd=maxd, hb=hb, bias=bias,
        dropout=(dropout_rate, dropout_seed), variant=variant,
        planted_fault=planted_fault)
    _count(flash_bwd_bshd_dq_cuda, plan, bias, dropout_rate)
    if rel_bias is not None:
        flash_bwd_bshd_dq_cuda.rel_launches += 1
    return dq, delta


flash_bwd_bshd_dq_cuda.launches = 0
flash_bwd_bshd_dq_cuda.rel_launches = 0
flash_bwd_bshd_dq_cuda.wgmma_launches = 0
flash_bwd_bshd_dq_cuda.sm80_launches = 0
flash_bwd_bshd_dq_cuda.bias_launches = 0
flash_bwd_bshd_dq_cuda.dropout_launches = 0


def flash_bwd_bshd_dkv_cuda(q, k, v, o, lse, do, *, scale: float,
                            causal: bool,
                            kv_lens: Optional[torch.Tensor] = None,
                            rel_bias: Optional[BucketedBias] = None,
                            bias: Optional[torch.Tensor] = None,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None,
                            delta: Optional[torch.Tensor] = None,
                            variant: Optional[str] = None,
                            planted_fault: Optional[str] = None):
    """Launch the dK/dV kernel on seq-major operands (as
    :func:`flash_bwd_bshd_dq_cuda`, whose ``delta`` the ``"wgmma"``
    variant reads) → dk, dv (b, sk, h_kv, d) bf16, each kv group's query
    heads summed in fp32 and cast once, and with ``rel_bias`` a third
    output, the bucket-table gradient (num_buckets, heads) fp32 summed in
    the same kernel (``dtab[:, :num_buckets].T``, ``:515-520``); dropout
    as :func:`flash_bwd_dkv_cuda`'s. Counts launches in ``.launches``, by
    variant, in ``.bias_launches``, ``.rel_launches`` and
    ``.dropout_launches``."""
    name = "flash_bwd_bshd_dkv_cuda"
    _check_bshd_bwd(q, k, v, o, lse, do, causal, kv_lens, bias, name)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    lut, bucket, rel_off, maxd, hb, nb = _flat_bias_args(
        rel_bias, bias, h, sq, sk, q, name)
    dk = torch.empty((b, sk, h_kv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    dtab = (None if rel_bias is None else
            torch.zeros((hb, nb), dtype=torch.float32, device=q.device))
    q4, k4, v4, o4, do4, dk4, dv4 = _bshd_views(q, k, v, o, do, dk, dv)
    plan = _launch_dkv(
        name, q4, k4, v4, o4, do4, dk4, dv4, lse, delta, scale=scale,
        causal=causal, kv_lens=kv_lens, lens_strides=_LENS_PER_BATCH,
        lut=lut, bucket=bucket, dtab=dtab, rel_off=rel_off, maxd=maxd,
        hb=hb, nb=nb, bias=bias, dropout=(dropout_rate, dropout_seed),
        variant=variant, planted_fault=planted_fault)
    _count(flash_bwd_bshd_dkv_cuda, plan, bias, dropout_rate)
    if dtab is None:
        return dk, dv
    flash_bwd_bshd_dkv_cuda.rel_launches += 1
    return dk, dv, dtab.t()


flash_bwd_bshd_dkv_cuda.launches = 0
flash_bwd_bshd_dkv_cuda.rel_launches = 0
flash_bwd_bshd_dkv_cuda.wgmma_launches = 0
flash_bwd_bshd_dkv_cuda.sm80_launches = 0
flash_bwd_bshd_dkv_cuda.bias_launches = 0
flash_bwd_bshd_dkv_cuda.dropout_launches = 0


def _rows4(x: torch.Tensor, group: int = 1) -> torch.Tensor:
    """A bh-flat operand as the kernels' (b, heads, s, d) view: a 4D
    tensor as it is, a 3D (rows, s, d) one split into (rows / group,
    group, s, d) — no copy either way."""
    return x if x.ndim == 4 else x.unflatten(0, (x.shape[0] // group, group))


def _strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, head, row) element strides of a 4D view; a head dim of
    extent 1 is given stride 0 (never stepped)."""
    return (x.stride(0), x.stride(1) if x.shape[1] > 1 else 0, x.stride(2))


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """The operand itself when its rows are dense and 16-byte aligned
    (the kernels copy 16-byte chunks), else a contiguous copy."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st in _strides(x)))
    return x if ok else x.contiguous()


def _check_flat(q4, k4, v4, kv_lens, name) -> None:
    if any(t.device != q4.device or t.device.type != "cuda"
           for t in (q4, k4, v4)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    b, h, sq, d = q4.shape
    if k4.shape != v4.shape or k4.shape[0] != b or k4.shape[3] != d \
            or h % k4.shape[1]:
        raise ValueError(
            f"{name}: q (b, h, sq, d) and k/v (b, h_kv, sk, d) with h_kv | "
            f"h; got {tuple(q4.shape)}, {tuple(k4.shape)}, "
            f"{tuple(v4.shape)}")
    if q4.dtype == torch.float16:
        raise ValueError(f"{name}: {FP16_FAMILY}")
    if not packed_kernel_ok(sq, h, d, q4.dtype) or k4.dtype != q4.dtype \
            or v4.dtype != q4.dtype or k4.shape[2] > KERNEL_MAX_SEQ:
        raise ValueError(
            f"{name}: the flash kernels take bfloat16, head_dim in "
            f"{KERNEL_HEAD_DIMS} and 1 <= s <= {KERNEL_MAX_SEQ}; got "
            f"{q4.dtype}/{k4.dtype}/{v4.dtype}, d={d}, sq={sq}, "
            f"sk={k4.shape[2]}")
    if kv_lens is not None and (kv_lens.shape != (b * h,)
                                or kv_lens.dtype != torch.int32
                                or kv_lens.device != q4.device):
        raise ValueError(f"{name}: kv_lens must be ({b * h},) int32 on "
                         f"{q4.device}; got {tuple(kv_lens.shape)} "
                         f"{kv_lens.dtype} on {kv_lens.device}")


def _rel_args(rel_bias: Optional[BucketedBias], rows: int):
    """(lut, bucket, rel_off, maxd, hb, nb) for the kernels, or nulls."""
    if rel_bias is None:
        return None, None, 0, 0, 1, 1
    if rel_bias.max_distance > KERNEL_MAX_DISTANCE:
        raise ValueError(
            f"the flash kernels take max_distance <= {KERNEL_MAX_DISTANCE} "
            f"(one value per clamped offset in shared memory); got "
            f"{rel_bias.max_distance}")
    if rows % rel_bias.heads:
        raise ValueError(f"bias rows ({rel_bias.heads}) must divide the "
                         f"rows ({rows})")
    lut, bucket, rel_off = rel_bias.kernel_operands()
    return (lut, bucket, rel_off, rel_bias.max_distance, rel_bias.heads,
            rel_bias.num_buckets)


def _flat_views(q, k, v, *q_like):
    """(rows, then q, k, v and each q-shaped operand as the kernels' 4D
    views): k and v must share their strides, so they are made
    contiguous together when they do not."""
    rows = q.shape[0] if q.ndim == 3 else q.shape[0] * q.shape[1]
    group = rows // (k.shape[0] if k.ndim == 3 else k.shape[0] * k.shape[1])
    q4, *rest = (_kernel_ready(_rows4(t, group)) for t in (q, *q_like))
    k4, v4 = (_kernel_ready(_rows4(t)) for t in (k, v))
    if k4.stride() != v4.stride():
        k4, v4 = k4.contiguous(), v4.contiguous()
    return (rows, q4, k4, v4, *rest)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stride_array(*views: torch.Tensor):
    vals = [st for x in views for st in _strides(x)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _out_like(x4: torch.Tensor, ndim: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """An output for an operand of shape x4 (b, heads, s, d): with a 4D
    caller, (b, s, heads, d) storage seen as (b, heads, s, d) — so the
    caller's merge of heads back to features is a view; with a 3D caller,
    contiguous rows. Returns (the 4D view for the kernel, the tensor the
    caller gets)."""
    b, h, s, d = x4.shape
    if ndim == 4:
        out = torch.empty((b, s, h, d), dtype=x4.dtype,
                          device=x4.device).transpose(1, 2)
        return out, out
    out = torch.empty((b * h, s, d), dtype=x4.dtype, device=x4.device)
    return _rows4(out, h), out


def _flat_bias_args(rel_bias: Optional[BucketedBias],
                    bias: Optional[torch.Tensor], rows: int, sq: int,
                    sk: int, ref: torch.Tensor, name: str):
    """(lut, bucket, rel_off, maxd, hb, nb) for the flat kernels: the
    bucketed bias's operands, or an array bias's row count as hb."""
    if rel_bias is not None and bias is not None:
        raise ValueError(f"{name}: a BucketedBias or an array bias, not both")
    if bias is not None:
        return None, None, 0, 0, _check_bias(bias, rows, sq, sk, ref,
                                             name), 1
    return _rel_args(rel_bias, rows)


# --- the flash kernels' launch plans -------------------------------------------

#: the flash kernels' variants: "wgmma" (TMA and wgmma, one body for every
#: layout: every path's call) and "sm80" (the first mma.sync kernels,
#: reached only through ``variant="sm80"`` on the ``_cuda`` wrappers, for
#: the A/B timing and tests) — the forward, the backward pair and dbias
KERNEL_VARIANTS = ("wgmma", "sm80")
#: the wgmma forward's tiles: query rows per CTA, kv rows per stage (64
#: with an array bias at d 128: its block rides the stage)
FWD_Q_TILE, FWD_KV_TILE, FWD_BIAS_KV_TILE = 128, 128, 64
#: the wgmma dK/dV kernel's tiles: kv rows per CTA, query rows per stage
#: (64 at d 128 and with an array bias; 128 otherwise at d 64)
DKV_KV_TILE, DKV_Q_TILE = 128, 64
#: the wgmma dQ kernel's tiles: query rows per CTA, kv rows per stage (64
#: at d 128; 128 at d 64)
DQ_Q_TILE, DQ_KV_TILE = 128, 64
#: the wgmma dbias kernel's output tiles (query rows, key columns) and the
#: most groups it splits the sharing rows into
DBIAS_Q_TILE, DBIAS_KV_TILE, DBIAS_MAX_SPLITS = 128, 64, 64
#: the faults a wrapper plants on request, made from its own inputs, for
#: the chip checks to refuse: the keys past the start of the last 64-row kv
#: tile masked off, or the bias (array or bucketed) left out
PLANTED_FAULTS = ("drop_last_kv_tile", "drop_bias")
#: dbias's: the last group of sharing rows left out of the sum (with one
#: group, its last row), or the bias left out of p
DBIAS_FAULTS = ("drop_last_group", "drop_bias")
#: the dropout faults the dbias kernel plants on request, by the code it
#: reads: the mask keyed by the kv head's row, the row and column swapped
#: in the hash (both as :data:`DROPOUT_FAULTS`), dP left unmasked
DBIAS_DROPOUT_FAULTS = {"key_kv_head": 1, "swap_row_col": 2,
                        "no_dbias_dp_mask": 5}
#: the dropout faults the wgmma kernels plant on request, by the code the
#: kernels read: the mask keyed by the kv head's row instead of the q
#: head's (every kernel; visible under GQA), the row and column swapped in
#: the hash (every kernel), the mask left out of the dK/dV kernel's dS
#: (its dV keeps it), the forward's l summed from the dropped p
DROPOUT_FAULTS = {"key_kv_head": 1, "swap_row_col": 2, "no_dkv_ds_mask": 3,
                  "l_from_dropped": 4}
#: the faults the fp16 instances plant on request, by the code their
#: entries take (each launches a template instance of its own): P (and,
#: in the backward, dS) rounded through bf16 before the fp16 tensor-core
#: operand, which the error rule refuses; every output clamped to +-65504
#: (a saturating conversion), which the overflow check refuses
FP16_FAULTS = {"bf16_p": 16, "satfinite": 17}
#: where dropout is refused: the sm80 kernels (deleted by ROADMAP's
#: simplicity item)
SM80_DROPOUT = ("the sm80 variant has no dropout (ROADMAP, Simplicity "
                "items: the sm80 kernels' deletion); use the wgmma variant")


class TensorMap(NamedTuple):
    """A TMA map as the kernel's host code encodes it: element type, the
    extents (innermost first), the byte strides of axes 1.., the box."""
    dtype: str
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]


class FlashPlan(NamedTuple):
    """One forward or backward call's launch: the variant, the TMA maps of
    its operands (``"q"``, ``"k"``, ``"v"``, the backward's ``"do"`` and,
    staged by TMA, the bias; none on ``"sm80"``), how the array bias
    reaches shared memory (``"tma"``, ``"cp.async"`` for rows no map
    describes, ``"global"``: the sm80 kernels read it per score; None
    without one), and the wgmma kernels' tiles — the forward's (query rows
    per CTA, kv rows per stage), :func:`fwd_schedule`'s; the backward's
    stage tiles (dK/dV query rows, dQ kv rows), :func:`dkv_schedule`'s and
    :func:`dq_schedule`'s (None on sm80)."""
    variant: str
    maps: dict
    bias_staging: Optional[str]
    tiles: Optional[Tuple[int, int]] = None


class DbiasPlan(NamedTuple):
    """One dbias call's launch: the variant, the TMA maps (``"q"``,
    ``"k"``, ``"v"``, ``"do"``; none on ``"sm80"``), the number of groups
    the sharing rows are split into (1 on sm80) and the groups, each a
    [first, last + 1) range of sharing-row indices n (row r = n·hb + th),
    and the output tiles (query rows, key columns; None on sm80)."""
    variant: str
    maps: dict
    splits: int
    groups: Tuple[Tuple[int, int], ...]
    tiles: Optional[Tuple[int, int]] = None


def _tensor_map(dtype: str, dims, strides, box) -> TensorMap:
    """The map ``make_tensor_map`` (``csrc/apex_sm90.cuh``) encodes: an
    axis of extent 1 is never stepped, and its stride becomes the largest
    span of the others (a row's bytes at least), rounded up to 16
    bytes."""
    row = dims[0] * (4 if dtype == "fp32" else 2)
    span = max([row] + [st * n for st, n in zip(strides, dims[1:])
                        if n > 1])
    fixed = tuple(st if n > 1 else -(-span // 16) * 16
                  for st, n in zip(strides, dims[1:]))
    return TensorMap(dtype, tuple(dims), fixed, tuple(box))


def _view_map(x4: torch.Tensor) -> TensorMap:
    """The (d, row, head, batch) bf16 (or fp16) map of a (b, heads, s, d)
    view: 64-row x 64-feature boxes (128 bytes: the 128-byte swizzle's
    span)."""
    b, heads, rows, d = x4.shape
    sb, sh, sr = _strides(x4)
    return _tensor_map("f16" if x4.dtype == torch.float16 else "bf16",
                       (d, rows, heads, b), (2 * sr, 2 * sh, 2 * sb),
                       (64, 64, 1, 1))


def _layout_key(a):
    """What a plan reads of an argument: a tensor's dtype, shape, strides
    and base offset from 16 bytes; any other argument as it is."""
    if isinstance(a, torch.Tensor):
        return a.dtype, tuple(a.shape), a.stride(), a.data_ptr() % 16
    return a


def _by_layout(fn):
    """Memoize a plan by :func:`_layout_key` of its arguments: a step
    launches a few layouts again and again, and a plan's maps cost more
    host time than its launch. A plan that raises is not kept."""
    cache = {}

    @functools.wraps(fn)
    def plan(*args, **kw):
        key = (tuple(map(_layout_key, args)),
               tuple((k, _layout_key(v)) for k, v in sorted(kw.items())))
        hit = cache.get(key)
        if hit is None:
            if len(cache) >= 1024:
                cache.clear()
            hit = cache[key] = fn(*args, **kw)
        return hit
    return plan


def _variant(variant: Optional[str], what: str) -> str:
    if variant is None:
        return "wgmma"
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"{what} has no variant {variant!r}; it has "
                         f"{KERNEL_VARIANTS}")
    return variant


def _operand_maps(what: str, **views: torch.Tensor) -> dict:
    """The TMA map of each named (b, heads, s, d) view; raises where none
    describes one (no fallback to another variant)."""
    maps = {}
    for name, x4 in views.items():
        m = _view_map(x4)
        if x4.data_ptr() % 16 or x4.stride(-1) != 1 \
                or any(st % 16 for st in m.strides):
            raise ValueError(
                f"the wgmma {what}: no tensor map describes {name} "
                f"(strides {tuple(x4.stride())}, base {x4.data_ptr() % 16} "
                f"bytes off 16)")
        maps[name] = m
    return maps


def _bias_staging(bias: Optional[torch.Tensor], maps: dict) -> Optional[str]:
    """How a wgmma kernel stages the array bias: by TMA where a map
    describes the fp32 (sk, sq, hb) bias (rows a multiple of 16 bytes, a
    16-byte aligned base; 32-column x 64-row boxes, added to ``maps``),
    else by ``cp.async`` of 8 or 4 bytes into the same swizzled layout."""
    if bias is None:
        return None
    hb, sq, sk = bias.shape
    if sk % 4 or bias.data_ptr() % 16:
        return "cp.async"
    maps["bias"] = _tensor_map("fp32", (sk, sq, hb), (4 * sk, 4 * sk * sq),
                               (32, 64, 1))
    return "tma"


@_by_layout
def _bwd_plan(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
              do4: torch.Tensor, bias: Optional[torch.Tensor] = None,
              variant: Optional[str] = None) -> FlashPlan:
    """Every host-side decision of a backward call, from its operands:
    the variant (``"wgmma"`` unless the caller names another), the tensor
    maps, the bias's staging (:func:`_bias_staging`) and the stage tiles.
    Raises where no map describes an operand; there is no fallback to the
    other variant."""
    variant = _variant(variant, "the flash backward")
    if variant == "sm80":
        return FlashPlan("sm80", {}, None if bias is None else "global")
    d = q4.shape[-1]  # the registers' and shared memory's tiles (DkvCfg)
    tiles = (128 if d == 64 and bias is None else 64, 128 if d == 64 else 64)
    maps = _operand_maps("flash backward", q=q4, k=k4, v=v4, do=do4)
    return FlashPlan(variant, maps, _bias_staging(bias, maps), tiles)


@_by_layout
def _fwd_plan(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              variant: Optional[str] = None) -> FlashPlan:
    """Every host-side decision of a forward call, from its (b, heads, s,
    d) views: the variant (``"wgmma"`` unless the caller names another),
    the tensor maps of q, k and v, the array bias's staging
    (:func:`_bias_staging`) and the tiles (128 query rows a CTA; 128 kv
    rows a stage, 64 with an array bias at d 128). Raises where no map
    describes an operand; there is no fallback to the other variant nor
    to the plain version."""
    variant = _variant(variant, "the flash forward")
    if variant == "sm80":
        return FlashPlan("sm80", {}, None if bias is None else "global")
    maps = _operand_maps("flash forward", q=q4, k=k4, v=v4)
    narrow = bias is not None and q4.shape[-1] == 128
    tiles = (FWD_Q_TILE, FWD_BIAS_KV_TILE if narrow else FWD_KV_TILE)
    return FlashPlan(variant, maps, _bias_staging(bias, maps), tiles)


@_by_layout
def _packed_fwd_plan(qkv: torch.Tensor, h: int, h_kv: int, d: int,
                     variant: Optional[str]) -> FlashPlan:
    """:func:`_fwd_plan` of the packed buffer's q/k/v windows, kept by
    the buffer's layout (the windows are not made again)."""
    return _fwd_plan(*_packed_views(qkv, h, h_kv, d), variant=variant)


@_by_layout
def _bshd_fwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   variant: Optional[str]) -> FlashPlan:
    """:func:`_fwd_plan` of seq-major operands' (b, h, s, d) views, kept
    by the operands' layout."""
    return _fwd_plan(*_bshd_views(q, k, v), bias, variant)


def dbias_splits(hb: int, sq: int, sk: int, nb: int, sms: int = 132) -> int:
    """How many contiguous groups the wgmma dbias kernel splits the nb
    rows sharing a bias row into: enough for its grid of hb × tiles × S
    CTAs to cover the card's ``sms`` SMs about twice (one CTA an SM), at
    most nb and :data:`DBIAS_MAX_SPLITS`; 1 where hb × tiles already
    does."""
    tiles = hb * -(-sq // DBIAS_Q_TILE) * -(-sk // DBIAS_KV_TILE)
    return max(1, min(nb, DBIAS_MAX_SPLITS, 2 * sms // tiles))


def dbias_groups(nb: int, splits: int) -> Tuple[Tuple[int, int], ...]:
    """The kernel's groups of sharing rows: group s holds n in [s·nb // S,
    (s + 1)·nb // S), contiguous and in order."""
    return tuple((s * nb // splits, (s + 1) * nb // splits)
                 for s in range(splits))


@_by_layout
def _dbias_plan(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
                do4: torch.Tensor, hb: int, variant: Optional[str] = None,
                sms: int = 132) -> DbiasPlan:
    """Every host-side decision of a dbias call: the variant, the tensor
    maps of q, k, v and do, the split of the sharing rows
    (:func:`dbias_splits`, :func:`dbias_groups`) and the output tiles.
    Raises where no map describes an operand."""
    variant = _variant(variant, "the flash dbias kernel")
    nb = q4.shape[0] * q4.shape[1] // hb
    if variant == "sm80":
        return DbiasPlan("sm80", {}, 1, ((0, nb),))
    maps = _operand_maps("flash dbias kernel", q=q4, k=k4, v=v4, do=do4)
    splits = dbias_splits(hb, q4.shape[2], k4.shape[2], nb, sms)
    return DbiasPlan(variant, maps, splits, dbias_groups(nb, splits),
                     (DBIAS_Q_TILE, DBIAS_KV_TILE))


def dbias_schedule(plan: DbiasPlan, hb: int, sq: int, sk: int):
    """The wgmma dbias kernel's CTAs in launch order: (group, bias row th,
    first query row, first key column, [sharing-row indices n it sums, in
    order]); group-major, then th, then query tile, the kv tile fastest.
    With one group each CTA writes dbias; else its partial, and the
    partials of a tile are added in group order."""
    out = []
    for s, (n0, n1) in enumerate(plan.groups):
        for th in range(hb):
            for q0 in range(0, sq, DBIAS_Q_TILE):
                for k0 in range(0, sk, DBIAS_KV_TILE):
                    out.append((s, th, q0, k0, list(range(n0, n1))))
    return out


def dkv_schedule(b: int, h: int, h_kv: int, sq: int, sk: int, causal: bool,
                 lens=None, q_tile: int = DKV_Q_TILE):
    """The wgmma dK/dV kernel's CTAs in launch order, as the kernel walks
    them: (batch, kv head, first kv row, [(query head, first query row),
    ...] in the order its ring loads them). CTAs go kv head by kv head
    (so those in flight share their heads' Q and dO in the L2), and
    within a head kv tile by kv tile (causal: the tiles that see the most
    queries first); a CTA walks each query head of its kv group whose kv
    length reaches its tile, and the query tiles (``q_tile`` rows: 128 at
    d 64 unless an array bias is staged, else 64) from the causal
    diagonal (bottom-right: row r sees column c iff c <= r + sk - sq)
    down. ``lens``: (b, h) kv lengths or None."""
    group, coff = h // h_kv, sk - sq
    out = []
    for bi in range(b):
        for kvh in range(h_kv):
            for kt in range(-(-sk // DKV_KV_TILE)):
                k0 = kt * DKV_KV_TILE
                qt0 = max(k0 - coff, 0) // q_tile if causal else 0
                qts = range(qt0, -(-sq // q_tile))
                heads = [kvh * group + i for i in range(group)
                         if lens is None
                         or k0 < min(max(int(lens[bi][kvh * group + i]), 0),
                                     sk)]
                out.append((bi, kvh, k0, [(hd, qt * q_tile)
                                          for hd in heads for qt in qts]))
    return out


def _query_tile_walk(b, h, sq, sk, causal, lens, q_tile, kv_tile):
    """CTAs of ``q_tile`` query rows in launch order, head by head, within
    a head the last query tiles first: (batch, head, first query row,
    [first kv row of each stage]), the ``kv_tile``-row stages up to the
    CTA's last row's causal diagonal and the row's kv length."""
    coff, out = sk - sq, []
    nq = -(-sq // q_tile)
    for bi in range(b):
        for hd in range(h):
            lim = sk if lens is None else min(max(int(lens[bi][hd]), 0), sk)
            for i in range(nq):
                q0 = (nq - 1 - i) * q_tile
                end = min(lim, q0 + q_tile + coff) if causal else lim
                out.append((bi, hd, q0, list(range(0, max(end, 0),
                                                   kv_tile))))
    return out


def dq_schedule(b: int, h: int, h_kv: int, sq: int, sk: int, causal: bool,
                lens=None, kv_tile: int = DQ_KV_TILE):
    """The wgmma dQ kernel's CTAs in launch order: (batch, head, first
    query row, [first kv row of each stage]). CTAs go head by head (so
    those in flight share their heads' K and V in the L2), within a head
    the last query tiles first (causal: the longest); a CTA's kv tiles
    (``kv_tile`` rows: 128 at d 64, 64 at d 128) run up to its last row's
    causal diagonal and the row's kv length."""
    return _query_tile_walk(b, h, sq, sk, causal, lens, DQ_Q_TILE, kv_tile)


def fwd_schedule(b: int, h: int, h_kv: int, sq: int, sk: int, causal: bool,
                 lens=None, kv_tile: int = FWD_KV_TILE):
    """The wgmma forward's tiles in order, as :func:`dq_schedule`'s CTAs
    (the same walk: 128 query rows a tile, head by head, the last query
    tiles first, kv tiles up to the causal diagonal and the kv length; a
    CTA an SM walks every #SMs-th tile where the tiles' work is equal), its
    stages ``kv_tile`` rows (128; 64 with an array bias at d 128). A
    warpgroup of a
    CTA skips a stage wholly above its 64 rows' diagonal."""
    return _query_tile_walk(b, h, sq, sk, causal, lens, FWD_Q_TILE, kv_tile)


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The plain version of the dQ kernel's side output: delta =
    rowsum(do·o) in fp32 over the last dim (the backward's
    ``delta``, ``:574-575``)."""
    return (do.float() * o.float()).sum(-1)


def _drop_args(rate: float, seed: Optional[int], plan, fault: Optional[str],
               name: str, faults: dict = DROPOUT_FAULTS):
    """(seed bits, 24-bit threshold, fp32 scale, fault code) for a flash
    entry (``faults``: the dropout faults it plants); (0, 0, 1.0, 0)
    without dropout. Raises on the sm80 variant."""
    if rate == 0.0:
        if fault in faults:
            raise ValueError(f"{name}: planted_fault {fault!r} needs "
                             f"dropout_rate > 0")
        return 0, 0, 1.0, 0
    seed = _check_dropout(rate, seed)
    if plan.variant == "sm80":
        raise ValueError(f"{name}: {SM80_DROPOUT}")
    return (seed & _M32, dropout_threshold(rate), dropout_scale(rate),
            faults.get(fault, 0))


def _planted(fault: Optional[str], kv_lens, lens_strides, bias, lut,
             b: int, h: int, sk: int, dev):
    """The kernel's (kv_lens, lens strides, bias, lut) with a planted
    fault (:data:`PLANTED_FAULTS`) made from them, or as given (the
    dropout faults, :data:`DROPOUT_FAULTS`, are planted in the kernel)."""
    if fault is None or fault in DROPOUT_FAULTS:
        return kv_lens, lens_strides, bias, lut
    if fault not in PLANTED_FAULTS:
        raise ValueError(f"planted_fault must be one of {PLANTED_FAULTS}; "
                         f"got {fault!r}")
    if fault == "drop_bias":
        return kv_lens, lens_strides, None, None
    cap = (sk - 1) // DQ_KV_TILE * DQ_KV_TILE
    if kv_lens is None:  # one length per row
        return (torch.full((b * h,), cap, dtype=torch.int32, device=dev),
                (h, 1), bias, lut)
    return kv_lens.clamp(max=cap), lens_strides, bias, lut


def _check_delta(name, delta, b, h, sq, ref) -> None:
    if delta is None:
        raise ValueError(
            f"{name}: the wgmma dK/dV kernel reads delta = rowsum(do*o), "
            f"which the dQ kernel writes: call the dQ wrapper first and pass "
            f"its delta")
    _check_like("delta", delta, (b * h, sq), torch.float32, ref)


def _f16_fault(name: str, plan: FlashPlan, rate: float,
               fault: Optional[str]) -> int:
    """The fp16 instances' fault code (0: sound); raises where they do not
    run: the sm80 variant, dropout, a fault they do not plant."""
    if plan.variant == "sm80":
        raise ValueError(f"{name}: {SM80_FP16}")
    if rate > 0.0:
        raise NotImplementedError(f"{name}: {FP16_DROPOUT}")
    if fault is None:
        return 0
    if fault not in FP16_FAULTS:
        raise ValueError(f"{name}: the fp16 instances plant "
                         f"{tuple(FP16_FAULTS)}; got {fault!r}")
    return FP16_FAULTS[fault]


def _launch_dq(name, q4, k4, v4, o4, do4, dq4, lse, *, scale, causal,
               kv_lens=None, lens_strides=None, lut=None, rel_off=0,
               maxd=0, hb=1, bias=None, dropout=(0.0, None), variant=None,
               planted_fault=None):
    """The dQ entry on (b, heads, s, d) views; ``dropout`` (rate, seed).
    Returns (the plan, delta or None)."""
    b, h, sq, d = q4.shape
    h_kv, sk = k4.shape[1], k4.shape[2]
    if q4.dtype == torch.float16:  # the packed wrappers: no lens nor bias
        plan = _bwd_plan(q4, k4, v4, do4, None, variant)
        fault = _f16_fault(name, plan, dropout[0], planted_fault)
        delta = torch.empty((b * h, sq), dtype=torch.float32,
                            device=q4.device)
        rc = _build.library().apex_flash_bwd_dq_f16(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            do4.data_ptr(), lse.data_ptr(), dq4.data_ptr(), delta.data_ptr(),
            _stride_array(q4, k4, o4, do4, dq4), b, h, h_kv, sq, sk, d,
            int(causal), float(scale), fault,
            torch.cuda.current_stream(q4.device).cuda_stream)
        _build.check(rc, name)
        return plan, delta
    lens_strides = lens_strides or (h, 1)
    kv_lens, lens_strides, bias, lut = _planted(
        planted_fault, kv_lens, lens_strides, bias, lut, b, h, sk, q4.device)
    plan = _bwd_plan(q4, k4, v4, do4, bias, variant)
    drop = _drop_args(*dropout, plan, planted_fault, name)
    delta = (torch.empty((b * h, sq), dtype=torch.float32, device=q4.device)
             if plan.variant == "wgmma" else None)
    rc = _build.library().apex_flash_bwd_dq(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
        do4.data_ptr(), lse.data_ptr(), dq4.data_ptr(), _ptr(delta),
        _ptr(kv_lens), _ptr(lut), _ptr(bias),
        _stride_array(q4, k4, o4, do4, dq4), b, h, h_kv, sq, sk, d,
        int(causal), float(scale), maxd, rel_off, hb, *lens_strides,
        int(plan.variant == "wgmma"), int(plan.bias_staging == "tma"), *drop,
        torch.cuda.current_stream(q4.device).cuda_stream)
    _build.check(rc, name)
    return plan, delta


def _launch_dkv(name, q4, k4, v4, o4, do4, dk4, dv4, lse, delta, *, scale,
                causal, kv_lens=None, lens_strides=None, lut=None,
                bucket=None, dtab=None, rel_off=0, maxd=0, hb=1, nb=1,
                bias=None, dropout=(0.0, None), variant=None,
                planted_fault=None) -> FlashPlan:
    """The dK/dV entry on (b, heads, s, d) views (dk and dv share their
    strides); ``dropout`` (rate, seed). Returns the plan."""
    b, h, sq, d = q4.shape
    h_kv, sk = k4.shape[1], k4.shape[2]
    if dk4.stride() != dv4.stride():
        raise ValueError(f"{name}: dk and dv must share their strides")
    if q4.dtype == torch.float16:  # the packed wrappers: no lens nor bias
        plan = _bwd_plan(q4, k4, v4, do4, None, variant)
        fault = _f16_fault(name, plan, dropout[0], planted_fault)
        _check_delta(name, delta, b, h, sq, q4)
        rc = _build.library().apex_flash_bwd_dkv_f16(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            do4.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk4.data_ptr(),
            dv4.data_ptr(), _stride_array(q4, k4, o4, do4, dk4), b, h, h_kv,
            sq, sk, d, int(causal), float(scale), fault,
            torch.cuda.current_stream(q4.device).cuda_stream)
        _build.check(rc, name)
        return plan
    lens_strides = lens_strides or (h, 1)
    kv_lens, lens_strides, bias, lut = _planted(
        planted_fault, kv_lens, lens_strides, bias, lut, b, h, sk, q4.device)
    plan = _bwd_plan(q4, k4, v4, do4, bias, variant)
    drop = _drop_args(*dropout, plan, planted_fault, name)
    if plan.variant == "wgmma":
        _check_delta(name, delta, b, h, sq, q4)
    rc = _build.library().apex_flash_bwd_dkv(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
        do4.data_ptr(), lse.data_ptr(), _ptr(delta), dk4.data_ptr(),
        dv4.data_ptr(), _ptr(dtab), _ptr(kv_lens), _ptr(lut),
        _ptr(None if lut is None else bucket), _ptr(bias),
        _stride_array(q4, k4, o4, do4, dk4), b, h, h_kv, sq, sk, d,
        int(causal), float(scale), maxd, rel_off, hb, nb, *lens_strides,
        int(plan.variant == "wgmma"), int(plan.bias_staging == "tma"), *drop,
        torch.cuda.current_stream(q4.device).cuda_stream)
    _build.check(rc, name)
    return plan


def flash_fwd_flat_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool,
                        kv_lens: Optional[torch.Tensor] = None,
                        rel_bias: Optional[BucketedBias] = None,
                        bias: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        variant: Optional[str] = None,
                        planted_fault: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bh-flat flash forward: q (bh, sq, d) or (b, h, sq, d),
    k/v (bh_kv, sk, d) or (b, h_kv, sk, d), bf16, any strides with dense
    rows; kv_lens (bh,) int32 or None; the bucketed bias, or an array bias
    (hb, sq, sk) fp32 with hb | bh, or neither. Returns o (q's shape; a 4D
    o is a (b, sq, h, d) buffer seen as (b, h, sq, d)) and lse (bh, sq)
    fp32. Dropout as :func:`flash_fwd_cuda`'s, q-head row t the flat row
    (with either bias or none). Counts its
    launches in ``.launches``, by variant, those with an array bias in
    ``.bias_launches`` and those with dropout in ``.dropout_launches``."""
    name = "flash_fwd_flat_cuda"
    rows, q4, k4, v4 = _flat_views(q, k, v)
    _check_flat(q4, k4, v4, kv_lens, name)
    b, h, sq, d = q4.shape
    h_kv, sk = k4.shape[1], k4.shape[2]
    lut, _, rel_off, maxd, hb, _ = _flat_bias_args(rel_bias, bias, rows, sq,
                                                   sk, q, name)
    kv_lens, _, run_bias, lut = _planted(planted_fault, kv_lens, (h, 1),
                                         bias, lut, b, h, sk, q.device)
    if lut is None:
        maxd = rel_off = 0
    plan = _fwd_plan(q4, k4, v4, run_bias, variant)
    drop = _drop_args(dropout_rate, dropout_seed, plan, planted_fault, name)
    o4, out = _out_like(q4, q.ndim)
    lse = torch.empty((rows, sq), dtype=torch.float32, device=q.device)
    rc = _build.library().apex_flash_fwd_flat(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
        lse.data_ptr(), _ptr(kv_lens), _ptr(lut), _ptr(run_bias),
        _stride_array(q4, k4, o4), b, h, h_kv, sq, sk, d, int(causal),
        float(scale), maxd, rel_off, hb, int(plan.variant == "wgmma"),
        int(plan.bias_staging == "tma"), *drop,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_fwd_flat")
    _count(flash_fwd_flat_cuda, plan, bias, dropout_rate)
    return out, lse


flash_fwd_flat_cuda.launches = 0
flash_fwd_flat_cuda.wgmma_launches = 0
flash_fwd_flat_cuda.sm80_launches = 0
flash_fwd_flat_cuda.bias_launches = 0
flash_fwd_flat_cuda.dropout_launches = 0


def _check_flat_bwd(q4, k4, v4, o4, do4, lse, kv_lens, name):
    _check_flat(q4, k4, v4, kv_lens, name)
    b, h, sq, d = q4.shape
    for nm, t in (("o", o4), ("do", do4)):
        if t.shape != q4.shape or t.dtype != q4.dtype \
                or t.device != q4.device:
            raise ValueError(f"{name}: {nm} must be {tuple(q4.shape)} "
                             f"{q4.dtype}; got {tuple(t.shape)} {t.dtype}")
    _check_like("lse", lse, (b * h, sq), torch.float32, q4)


def flash_bwd_flat_dq_cuda(q, k, v, o, lse, do, *, scale: float,
                           causal: bool,
                           kv_lens: Optional[torch.Tensor] = None,
                           rel_bias: Optional[BucketedBias] = None,
                           bias: Optional[torch.Tensor] = None,
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None,
                           variant: Optional[str] = None,
                           planted_fault: Optional[str] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the dQ kernel on bh-flat operands: dq in q's shape and delta
    (bh, sq) fp32 for the dK/dV kernel (None on ``"sm80"``); dropout as
    :func:`flash_bwd_dq_cuda`'s. Counts launches in ``.launches``, by
    variant, those with an array bias in ``.bias_launches`` and those with
    dropout in ``.dropout_launches``."""
    name = "flash_bwd_flat_dq_cuda"
    rows, q4, k4, v4, o4, do4 = _flat_views(q, k, v, o, do)
    _check_flat_bwd(q4, k4, v4, o4, do4, lse, kv_lens, name)
    sq, sk = q4.shape[2], k4.shape[2]
    lut, _, rel_off, maxd, hb, _ = _flat_bias_args(rel_bias, bias, rows, sq,
                                                   sk, q, name)
    dq4, dq = _out_like(q4, q.ndim)
    plan, delta = _launch_dq(
        name, q4, k4, v4, o4, do4, dq4, lse, scale=scale, causal=causal,
        kv_lens=kv_lens, lens_strides=(q4.shape[1], 1), lut=lut,
        rel_off=rel_off, maxd=maxd, hb=hb, bias=bias,
        dropout=(dropout_rate, dropout_seed), variant=variant,
        planted_fault=planted_fault)
    _count(flash_bwd_flat_dq_cuda, plan, bias, dropout_rate)
    return dq, delta


flash_bwd_flat_dq_cuda.launches = 0
flash_bwd_flat_dq_cuda.wgmma_launches = 0
flash_bwd_flat_dq_cuda.sm80_launches = 0
flash_bwd_flat_dq_cuda.bias_launches = 0
flash_bwd_flat_dq_cuda.dropout_launches = 0


def flash_bwd_flat_dkv_cuda(q, k, v, o, lse, do, *, scale: float,
                            causal: bool,
                            kv_lens: Optional[torch.Tensor] = None,
                            rel_bias: Optional[BucketedBias] = None,
                            bias: Optional[torch.Tensor] = None,
                            delta: Optional[torch.Tensor] = None,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None,
                            variant: Optional[str] = None,
                            planted_fault: Optional[str] = None):
    """Launch the dK/dV kernel on bh-flat operands: dk, dv in k's shape
    (each kv group's query heads summed in fp32) and, with ``rel_bias``,
    the bucket-table gradient (num_buckets, heads) fp32 summed in the same
    kernel (None without; an array ``bias`` gets its gradient from
    :func:`flash_bwd_dbias_cuda`). The ``"wgmma"`` variant reads ``delta``
    from :func:`flash_bwd_flat_dq_cuda` (call it first). Dropout as
    :func:`flash_bwd_dkv_cuda`'s (the table gradient sums the dropped
    dS). Counts launches in ``.launches``, by variant, those that carry
    the table gradient in ``.table_launches``, those with an array bias in
    ``.bias_launches`` and those with dropout in
    ``.dropout_launches``."""
    name = "flash_bwd_flat_dkv_cuda"
    rows, q4, k4, v4, o4, do4 = _flat_views(q, k, v, o, do)
    _check_flat_bwd(q4, k4, v4, o4, do4, lse, kv_lens, name)
    sq, sk = q4.shape[2], k4.shape[2]
    lut, bucket, rel_off, maxd, hb, nb = _flat_bias_args(
        rel_bias, bias, rows, sq, sk, q, name)
    dk4, dk = _out_like(k4, k.ndim)
    dv4, dv = _out_like(k4, k.ndim)
    dtab = (None if rel_bias is None else
            torch.zeros((hb, nb), dtype=torch.float32, device=q.device))
    plan = _launch_dkv(
        name, q4, k4, v4, o4, do4, dk4, dv4, lse, delta, scale=scale,
        causal=causal, kv_lens=kv_lens, lens_strides=(q4.shape[1], 1),
        lut=lut, bucket=bucket, dtab=dtab, rel_off=rel_off, maxd=maxd,
        hb=hb, nb=nb, bias=bias, dropout=(dropout_rate, dropout_seed),
        variant=variant, planted_fault=planted_fault)
    _count(flash_bwd_flat_dkv_cuda, plan, bias, dropout_rate)
    if dtab is not None:
        flash_bwd_flat_dkv_cuda.table_launches += 1
    return dk, dv, (None if dtab is None else dtab.t())


flash_bwd_flat_dkv_cuda.launches = 0
flash_bwd_flat_dkv_cuda.wgmma_launches = 0
flash_bwd_flat_dkv_cuda.sm80_launches = 0
flash_bwd_flat_dkv_cuda.table_launches = 0
flash_bwd_flat_dkv_cuda.bias_launches = 0
flash_bwd_flat_dkv_cuda.dropout_launches = 0


def _dbias_planted(fault: Optional[str], plan: DbiasPlan, hb: int,
                   do4: torch.Tensor, delta: Optional[torch.Tensor],
                   bias: torch.Tensor):
    """The (do, delta, bias) the kernel reads, with a planted fault
    (:data:`DBIAS_FAULTS`) made from them, or as given: the do and delta
    rows of the plan's last group of sharing rows zeroed (with one group,
    of its last sharing row), so that p·(dP − delta) is 0 on those rows;
    or a zero bias in p. The dropout faults
    (:data:`DBIAS_DROPOUT_FAULTS`) are planted in the kernel."""
    if fault is None or fault in DBIAS_DROPOUT_FAULTS:
        return do4, delta, bias
    if fault not in DBIAS_FAULTS:
        raise ValueError(f"planted_fault must be one of {DBIAS_FAULTS}; got "
                         f"{fault!r}")
    if fault == "drop_bias":
        return do4, delta, torch.zeros_like(bias)
    first, end = plan.groups[-1]
    r0 = (first or end - 1) * hb  # the rows r = n·hb + th of n >= first
    b, h, sq, d = do4.shape
    do4 = do4.clone(memory_format=torch.contiguous_format)
    do4.view(b * h, sq, d)[r0:] = 0
    if delta is not None:
        delta = delta.clone()
        delta[r0:] = 0
    return do4, delta, bias


def flash_bwd_dbias_cuda(q, k, v, o, lse, do, bias: torch.Tensor, *,
                         scale: float, causal: bool,
                         kv_lens: Optional[torch.Tensor] = None,
                         layout: str = "bhsd",
                         delta: Optional[torch.Tensor] = None,
                         dropout_rate: float = 0.0,
                         dropout_seed: Optional[int] = None,
                         variant: Optional[str] = None,
                         planted_fault: Optional[str] = None) -> torch.Tensor:
    """Launch the dbias kernel: the array bias's gradient (hb, sq, sk)
    fp32, the unscaled dS summed over the rows that share each bias row.
    ``layout="bhsd"``: the flat operands of :func:`flash_bwd_flat_dkv_cuda`
    (per-row kv_lens); ``"bshd"``: those of
    :func:`flash_bwd_bshd_dkv_cuda` (per-batch kv_lens, hb | h). The
    ``"wgmma"`` variant reads ``delta`` (b·h, sq) fp32, the dQ wrapper's
    side output; without one it computes it here once by
    :func:`bwd_delta` (for direct callers and tests). It sums the sharing
    rows in the groups of :func:`_dbias_plan`, then the groups' partials in
    order. With ``dropout_rate > 0`` dS takes the dropped dP, the mask
    rebuilt from ``dropout_seed`` on the forward's q-head rows (the rows of
    the flattened (batch, head) dims; ``_bwd_dbias_kernel``, ``:1083``).
    ``variant`` and ``planted_fault`` (:data:`DBIAS_FAULTS`,
    :data:`DBIAS_DROPOUT_FAULTS`) are for the A/B timing and the kernel
    checks. Counts launches in ``.launches``, by variant and with dropout
    in ``.dropout_launches``."""
    name = "flash_bwd_dbias_cuda"
    if layout == "bshd":
        _check_bshd_bwd(q, k, v, o, lse, do, causal, kv_lens, bias, name)
        q4, k4, v4, o4, do4 = _bshd_views(q, k, v, o, do)
        rows = q4.shape[0] * q4.shape[1]
        lens_strides = _LENS_PER_BATCH
    elif layout == "bhsd":
        rows, q4, k4, v4, o4, do4 = _flat_views(q, k, v, o, do)
        _check_flat_bwd(q4, k4, v4, o4, do4, lse, kv_lens, name)
        lens_strides = (q4.shape[1], 1)
    else:
        raise ValueError(f"layout must be bhsd|bshd, got {layout!r}")
    b, h, sq, d = q4.shape
    h_kv, sk = k4.shape[1], k4.shape[2]
    hb = _check_bias(bias, rows, sq, sk, q, name)
    plan = _dbias_plan(q4, k4, v4, do4, hb, variant,
                       _sm_count(q.device.index or 0))
    drop = _drop_args(dropout_rate, dropout_seed, plan, planted_fault, name,
                      DBIAS_DROPOUT_FAULTS)
    ws = None
    if plan.variant == "wgmma":
        if delta is None:
            delta = bwd_delta(o4, do4).reshape(rows, sq)
        _check_like("delta", delta, (rows, sq), torch.float32, q4)
        if plan.splits > 1:
            ws = torch.empty((plan.splits, hb, sq, sk), dtype=torch.float32,
                             device=q.device)
    do4, delta, run_bias = _dbias_planted(planted_fault, plan, hb, do4,
                                          delta, bias)
    dbias = torch.empty((hb, sq, sk), dtype=torch.float32, device=q.device)
    rc = _build.library().apex_flash_bwd_dbias(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
        do4.data_ptr(), lse.data_ptr(), _ptr(delta), run_bias.data_ptr(),
        dbias.data_ptr(), _ptr(ws), _ptr(kv_lens),
        _stride_array(q4, k4, o4, do4), b, h, h_kv, sq, sk, d, int(causal),
        float(scale), hb, *lens_strides, plan.splits,
        int(plan.variant == "wgmma"), *drop,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_bwd_dbias")
    _count(flash_bwd_dbias_cuda, plan, dropout=dropout_rate)
    return dbias


flash_bwd_dbias_cuda.launches = 0
flash_bwd_dbias_cuda.wgmma_launches = 0
flash_bwd_dbias_cuda.sm80_launches = 0
flash_bwd_dbias_cuda.dropout_launches = 0


# --- dispatch -----------------------------------------------------------------

def flash_fwd_packed(qkv: torch.Tensor, h: int, h_kv: int, d: int, *,
                     scale: float, causal: bool, dropout_rate: float = 0.0,
                     dropout_seed: Optional[int] = None, impl: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward reading q/k/v out of the PACKED projection output
    ``qkv`` (b, s, (h+2·h_kv)·d). Returns (o (b, s, h·d), lse (b, h, s)).
    ``dropout_rate > 0`` drops the probabilities by :func:`dropout_keep`
    of the host int ``dropout_seed`` (the Pallas ``flash_fwd_packed``'s
    ``dropout_rate``/``dropout_seed``)."""
    seed = _check_dropout(dropout_rate, dropout_seed)
    if _backend.use_kernel(qkv, impl):
        return flash_fwd_cuda(qkv, h, h_kv, d, scale=scale, causal=causal,
                              dropout_rate=dropout_rate, dropout_seed=seed)
    return _torch_flash_fwd(qkv, h, h_kv, d, scale, causal, dropout_rate,
                            seed)


def flash_bwd_packed(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                     do: torch.Tensor, h: int, h_kv: int, d: int, *,
                     scale: float, causal: bool, dropout_rate: float = 0.0,
                     dropout_seed: Optional[int] = None, impl: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`flash_fwd_packed`: SEPARATE dq (b, s, h·d) and
    dk/dv (b, s, h_kv·d) — the caller contracts each against its weight
    window. On a CUDA tensor the dQ kernel runs first (it writes delta),
    then the dK/dV kernel; both rebuild the forward's dropout mask from
    the same seed."""
    seed = _check_dropout(dropout_rate, dropout_seed)
    if _backend.use_kernel(qkv, impl):
        kw = dict(scale=scale, causal=causal, dropout_rate=dropout_rate,
                  dropout_seed=seed)
        dq, delta = flash_bwd_dq_cuda(qkv, o, lse, do, h, h_kv, d, **kw)
        dk, dv = flash_bwd_dkv_cuda(qkv, o, lse, do, h, h_kv, d,
                                    delta=delta, **kw)
        return dq, dk, dv
    return _torch_flash_bwd(qkv, o, lse, do, h, h_kv, d, scale, causal,
                            dropout_rate, seed)


def _bias32(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """An array bias as the kernels read it: fp32 and contiguous (a no-op
    when it already is)."""
    return None if bias is None else bias.float().contiguous()


def flash_fwd_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool,
                   kv_lens: Optional[torch.Tensor] = None,
                   rel_bias: Optional[BucketedBias] = None,
                   bias: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None, impl: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seq-major flash forward (the Pallas ``flash_fwd_bshd``): q (b, sq,
    h, d), k/v (b, sk, h_kv, d); ``kv_lens`` (b,) int32 per batch (the
    heads share a row's padding); ``rel_bias`` the bucketed bias (its
    heads dividing h, head t reading table column t % heads) or ``bias``
    (hb, sq, sk) with hb | h, head t reading bias row t % hb. Returns (o
    (b, sq, h, d), lse (b, h, sq)); dropout keyed by q-head row t = b·h +
    head."""
    bias = _bias32(bias)
    seed = _check_dropout(dropout_rate, dropout_seed)
    if _backend.use_kernel(q, impl):
        return flash_fwd_bshd_cuda(q, k, v, scale=scale, causal=causal,
                                   kv_lens=kv_lens, rel_bias=rel_bias,
                                   bias=bias, dropout_rate=dropout_rate,
                                   dropout_seed=seed)
    if rel_bias is not None:
        bias = rel_bias.materialize(q.shape[1], k.shape[1])
    return _torch_flash_fwd_bshd(q, k, v, scale, causal, kv_lens, bias,
                                 dropout_rate, seed)


def flash_bwd_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   scale: float, causal: bool,
                   kv_lens: Optional[torch.Tensor] = None,
                   rel_bias: Optional[BucketedBias] = None,
                   bias: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None, impl: str = "auto"):
    """Backward of :func:`flash_fwd_bshd` (the Pallas ``flash_bwd_bshd``,
    ``:1395-1530``): (dq (b, sq, h, d), dk, dv (b, sk, h_kv, d), and the
    bias's fp32 cotangent: the table's (num_buckets, heads) with
    ``rel_bias``, dbias (hb, sq, sk) with ``bias``, else None). On a CUDA
    tensor the dQ kernel runs (it writes delta), then the dK/dV kernel
    (which also sums the table gradient), and with an array bias the
    dbias kernel (both read that delta; every kernel rebuilds the
    forward's dropout mask)."""
    bias = _bias32(bias)
    seed = _check_dropout(dropout_rate, dropout_seed)
    if _backend.use_kernel(q, impl):
        do = do if _seq_major_ok(do) else do.contiguous()
        kw = dict(scale=scale, causal=causal, kv_lens=kv_lens,
                  rel_bias=rel_bias, bias=bias, dropout_rate=dropout_rate,
                  dropout_seed=seed)
        dq, delta = flash_bwd_bshd_dq_cuda(q, k, v, o, lse, do, **kw)
        dk, dv, *dtab = flash_bwd_bshd_dkv_cuda(q, k, v, o, lse, do,
                                                delta=delta, **kw)
        dbias = (dtab[0] if dtab else None if bias is None
                 else flash_bwd_dbias_cuda(
                     q, k, v, o, lse, do, bias, scale=scale, causal=causal,
                     kv_lens=kv_lens, layout="bshd", delta=delta,
                     dropout_rate=dropout_rate, dropout_seed=seed))
        return dq, dk, dv, dbias
    arr = (bias if rel_bias is None
           else rel_bias.materialize(q.shape[1], k.shape[1]))
    dq, dk, dv, dbias = _torch_flash_bwd_bshd(q, k, v, o, lse, do, scale,
                                              causal, kv_lens, arr,
                                              dropout_rate, seed)
    if rel_bias is not None:
        dbias = _table_grad(rel_bias, dbias)
    return dq, dk, dv, dbias


def _rows3(x: torch.Tensor) -> torch.Tensor:
    return x if x.ndim == 3 else x.flatten(0, 1)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool,
              kv_lens: Optional[torch.Tensor] = None,
              rel_bias: Optional[BucketedBias] = None,
              bias: Optional[torch.Tensor] = None,
              dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
              impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The bh-flat flash forward (the Pallas ``flash_fwd``, ``:375-461``):
    q (bh, sq, d), k/v (bh_kv, sk, d) with bh_kv | bh — or the same as
    (b, h, s, d) views, which the kernel reads without a copy. ``kv_lens``
    (bh,) int32 masks each row's columns >= its length (a row of length 0
    gives o = 0, lse = 0); ``rel_bias`` adds the bucketed bias, row r
    reading table column r % heads, or ``bias`` the array bias (hb, sq,
    sk), row r reading bias row r % hb. Returns (o in q's shape, lse (bh,
    sq) fp32). Dropout keyed by the flat q row t."""
    bias = _bias32(bias)
    seed = _check_dropout(dropout_rate, dropout_seed)
    if _backend.use_kernel(q, impl):
        return flash_fwd_flat_cuda(q, k, v, scale=scale, causal=causal,
                                   kv_lens=kv_lens, rel_bias=rel_bias,
                                   bias=bias, dropout_rate=dropout_rate,
                                   dropout_seed=seed)
    if rel_bias is not None:
        bias = rel_bias.materialize(q.shape[-2], k.shape[-2])
    o, lse = _torch_flash_fwd_flat(_rows3(q), _rows3(k), _rows3(v), scale,
                                   causal, kv_lens, bias, dropout_rate, seed)
    return o.reshape(q.shape), lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              scale: float, causal: bool,
              kv_lens: Optional[torch.Tensor] = None,
              rel_bias: Optional[BucketedBias] = None,
              bias: Optional[torch.Tensor] = None,
              dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
              impl: str = "auto"):
    """Backward of :func:`flash_fwd` (the Pallas ``flash_bwd``,
    ``:1249-1411``): (dq, dk, dv) in their operands' shapes and the bias's
    fp32 cotangent — the table's (num_buckets, heads) with ``rel_bias``,
    dbias (hb, sq, sk) with ``bias``, else None. On a CUDA tensor the dQ
    kernel (which writes delta) and then the dK/dV kernel (which also sums
    the table gradient) run, and with an array bias the dbias kernel, the
    last two on the dQ kernel's delta; each rebuilds the forward's dropout
    mask."""
    bias = _bias32(bias)
    seed = _check_dropout(dropout_rate, dropout_seed)
    if _backend.use_kernel(q, impl):
        kw = dict(scale=scale, causal=causal, kv_lens=kv_lens,
                  rel_bias=rel_bias, bias=bias, dropout_rate=dropout_rate,
                  dropout_seed=seed)
        dq, delta = flash_bwd_flat_dq_cuda(q, k, v, o, lse, do, **kw)
        dk, dv, dtab = flash_bwd_flat_dkv_cuda(q, k, v, o, lse, do,
                                               delta=delta, **kw)
        if bias is not None:
            dtab = flash_bwd_dbias_cuda(q, k, v, o, lse, do, bias,
                                        scale=scale, causal=causal,
                                        kv_lens=kv_lens, delta=delta,
                                        dropout_rate=dropout_rate,
                                        dropout_seed=seed)
        return dq, dk, dv, dtab
    sq, sk = q.shape[-2], k.shape[-2]
    arr = bias if rel_bias is None else rel_bias.materialize(sq, sk)
    dq, dk, dv, dbias = _torch_flash_bwd_flat(
        _rows3(q), _rows3(k), _rows3(v), _rows3(o), lse, _rows3(do), scale,
        causal, kv_lens, arr, dropout_rate=dropout_rate, dropout_seed=seed)
    if rel_bias is not None:
        dbias = _table_grad(rel_bias, dbias)
    return (dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape),
            dbias)


class _FlashFlat(torch.autograd.Function):
    """The bh-flat core (``_flash_core``, ``:255-390``): the forward saves
    q, k, v, o and lse; the backward returns dq, dk, dv and the bias's
    cotangent. ``bias_t`` is the bucket table when ``rel`` (its bucketing)
    is given, else the fp32 array bias or None. ``drop`` is (rate, seed as
    a host int): no mask is saved, the backward rebuilds it."""

    @staticmethod
    def forward(ctx, q, k, v, bias_t, kv_lens, scale, causal, rel, impl,
                drop):
        rb, arr = ((None, bias_t) if rel is None
                   else (BucketedBias(bias_t, *rel), None))
        o, lse = flash_fwd(q, k, v, scale=scale, causal=causal,
                           kv_lens=kv_lens, rel_bias=rb, bias=arr,
                           dropout_rate=drop[0], dropout_seed=drop[1],
                           impl=impl)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens, bias_t)
        ctx.attn = (scale, causal, rel, impl, drop)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens, bias_t = ctx.saved_tensors
        scale, causal, rel, impl, drop = ctx.attn
        rb, arr = ((None, bias_t) if rel is None
                   else (BucketedBias(bias_t, *rel), None))
        dq, dk, dv, dbias = flash_bwd(q, k, v, o, lse, do, scale=scale,
                                      causal=causal, kv_lens=kv_lens,
                                      rel_bias=rb, bias=arr,
                                      dropout_rate=drop[0],
                                      dropout_seed=drop[1], impl=impl)
        dbias = None if dbias is None else dbias.to(bias_t.dtype)
        return dq, dk, dv, dbias, None, None, None, None, None, None


class _FlashBshd(torch.autograd.Function):
    """The seq-major core (``_flash_core_bshd``, ``_flash_fwd_res_bshd``,
    ``_flash_bwd_bshd_impl``, ``:442-539``): the forward saves q, k, v, o
    and lse; the backward returns dq, dk, dv and the bias's cotangent.
    ``bias_t`` is the bucket table when ``rel`` (its bucketing) is given,
    else the fp32 array bias or None. ``drop`` (rate, host seed) as
    :class:`_FlashFlat`'s."""

    @staticmethod
    def forward(ctx, q, k, v, bias_t, kv_lens, scale, causal, rel, impl,
                drop):
        rb, arr = ((None, bias_t) if rel is None
                   else (BucketedBias(bias_t, *rel), None))
        o, lse = flash_fwd_bshd(q, k, v, scale=scale, causal=causal,
                                kv_lens=kv_lens, rel_bias=rb, bias=arr,
                                dropout_rate=drop[0], dropout_seed=drop[1],
                                impl=impl)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens, bias_t)
        ctx.attn = (scale, causal, rel, impl, drop)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens, bias_t = ctx.saved_tensors
        scale, causal, rel, impl, drop = ctx.attn
        rb, arr = ((None, bias_t) if rel is None
                   else (BucketedBias(bias_t, *rel), None))
        dq, dk, dv, dbias = flash_bwd_bshd(q, k, v, o, lse, do, scale=scale,
                                           causal=causal, kv_lens=kv_lens,
                                           rel_bias=rb, bias=arr,
                                           dropout_rate=drop[0],
                                           dropout_seed=drop[1], impl=impl)
        dbias = None if dbias is None else dbias.to(bias_t.dtype)
        return dq, dk, dv, dbias, None, None, None, None, None, None


def _bias_rows(bias: Union[BucketedBias, torch.Tensor]) -> int:
    return bias.heads if isinstance(bias, BucketedBias) else bias.shape[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    bias: Optional[Union[BucketedBias, torch.Tensor]] = None,
                    impl: str = "auto", layout: str = "bhsd",
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[Union[int, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Blockwise attention (``apex_tpu/ops/attention.py:647-844``). ``scale``
    defaults to 1/sqrt(d); ``causal`` aligns bottom-right (row r sees keys
    ``<= r + sk − sq``) and requires sq <= sk. On a CUDA tensor the
    kernels run (a shape they refuse — not bf16, d not in 64/128 —
    raises); on a CPU tensor, or with ``impl="torch"``, the plain version.

    ``layout="bhsd"`` (the default, as in the reference): q (..., sq, d)
    and k/v (..., sk, d), any leading dims, k/v's head dim (the last
    leading dim) dividing q's for grouped-query heads. ``kv_lens`` over
    q's leading dims masks each row's keys >= its length (a row of length
    0 returns zeros). (b, h, s, d) views of a projection output go to the
    kernels without a copy, and a 4D output is a (b, s, h, d) buffer seen
    as (b, h, s, d), so merging the heads back is a view too.

    ``layout="bshd"``: q (b, sq, h, d) and k/v (b, sk, h_kv, d);
    ``kv_lens`` is PER BATCH, (b,) (the heads share a row's padding).

    ``bias``: a :class:`BucketedBias` whose heads divide the flattened
    rows (on ``"bshd"``, the heads), its table getting a gradient; or an
    additive array (hb, sq, sk) — on ``"bhsd"`` hb divides the flattened
    rows, on ``"bshd"`` the heads — row r of the flattened
    (batch·heads) leading dims reading bias row r % hb (table column r
    % heads). Either is added to the scaled
    scores before the causal and ``kv_lens`` masks; the array is cast to
    fp32 once, and its gradient (the unscaled dS summed over the rows
    sharing a bias row) comes back in its own dtype. Both layouts run
    forward and backward.

    ``dropout_rate > 0`` drops the probabilities in the kernels
    (``:700-737``): the mask is :func:`dropout_keep` of ``dropout_seed``
    (an int32 value: an int, or a one-element int tensor, read once on
    the host) over (q-head row t, query row, key column), t the row of
    the flattened (batch·heads) leading dims; lse stays un-dropped and
    kept probabilities are scaled by float32(1/(1 - rate)). The backward
    rebuilds the mask from the seed; none is saved. With an array bias,
    dbias sums dS of the dropped dP (``_bwd_dbias_kernel``, ``:1083``).
    HALF-class under an O1 policy (q, k and v cast)."""
    q, k, v = apply_op_rules("attention", q, k, v)
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"layout must be bhsd|bshd, got {layout!r}")
    drop = (float(dropout_rate), _check_dropout(dropout_rate, dropout_seed))
    if isinstance(bias, BucketedBias):
        _validate_bucketed(bias)
    elif bias is not None:
        sq_, sk_ = ((q.shape[1], k.shape[1]) if layout == "bshd"
                    else (q.shape[-2], k.shape[-2]))
        if bias.ndim != 3 or tuple(bias.shape[1:]) != (sq_, sk_):
            raise ValueError(f"bias must be (hb, sq, sk) = (hb, {sq_}, "
                             f"{sk_}); got {tuple(bias.shape)}")
    d = q.shape[-1]
    s_scale = float(scale if scale is not None else 1.0 / d ** 0.5)
    if layout == "bshd":
        if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
            raise ValueError(f"layout='bshd' takes (b, s, h, d) operands; "
                             f"got {tuple(q.shape)} / {tuple(k.shape)}")
        if causal and q.shape[1] > k.shape[1]:
            raise ValueError(f"causal attention requires sq <= sk; got "
                             f"sq={q.shape[1]} > sk={k.shape[1]}")
        if q.shape[2] % k.shape[2] or k.shape[:2] != v.shape[:2]:
            raise ValueError(f"kv heads ({k.shape[2]}) must divide q heads "
                             f"({q.shape[2]}) with matching batch/seq dims")
        if kv_lens is not None:
            if tuple(kv_lens.shape) != (q.shape[0],):
                raise ValueError(
                    f"layout='bshd' takes per-batch kv_lens of shape "
                    f"({q.shape[0]},); got {tuple(kv_lens.shape)}")
            kv_lens = kv_lens.to(torch.int32)
        if bias is not None and q.shape[2] % _bias_rows(bias):
            raise ValueError(
                f"layout='bshd' needs bias rows ({_bias_rows(bias)}) "
                f"dividing q heads ({q.shape[2]})")
        rel, bias_t = None, _bias32(bias) if torch.is_tensor(bias) else None
        if isinstance(bias, BucketedBias):
            rel = (bias.bidirectional, int(bias.max_distance),
                   int(bias.q_offset), int(bias.k_offset))
            bias_t = bias.table
        return _FlashBshd.apply(q, k, v, bias_t, kv_lens, s_scale,
                                bool(causal), rel, impl, drop)
    if q.ndim < 2 or k.ndim != q.ndim or v.ndim != q.ndim:
        raise ValueError(f"layout='bhsd' takes (..., s, d) operands of one "
                         f"rank; got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if causal and q.shape[-2] > k.shape[-2]:
        raise ValueError(
            f"causal attention requires sq <= sk (bottom-right alignment); "
            f"got sq={q.shape[-2]} > sk={k.shape[-2]} — rows before the "
            f"context start would attend nothing")
    if k.shape[:-2] != v.shape[:-2] or k.shape[-1] != d \
            or v.shape[-1] != d or k.shape[-2] != v.shape[-2]:
        raise ValueError(f"k/v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    lead = q.shape[:-2]
    if q.ndim >= 4:
        # batch dims must match; only the head axis may be narrower on kv
        if q.shape[:-3] != k.shape[:-3] or q.shape[-3] % k.shape[-3]:
            raise ValueError(
                f"kv heads ({k.shape[-3]}) must divide q heads "
                f"({q.shape[-3]}) with equal batch dims ({q.shape[:-3]} vs "
                f"{k.shape[:-3]}) for grouped-query attention")
        # (..., h, s, d) → (b, h, s, d): a view for 4D operands
        q_, k_, v_ = (t.reshape(-1, *t.shape[-3:]) for t in (q, k, v))
    else:
        q_, k_, v_ = (t.reshape(-1, *t.shape[-2:]) for t in (q, k, v))
        if q_.shape[0] % k_.shape[0]:
            raise ValueError(
                f"kv heads ({k_.shape[0]} flattened) must divide q heads "
                f"({q_.shape[0]} flattened) for grouped-query attention")
    rows = lead.numel()
    if kv_lens is not None:
        if tuple(kv_lens.shape) != tuple(lead):
            raise ValueError(f"kv_lens shape {tuple(kv_lens.shape)} must "
                             f"equal q's leading dims {tuple(lead)}")
        kv_lens = kv_lens.reshape(-1).to(torch.int32)
    rel, bias_t = None, _bias32(bias) if torch.is_tensor(bias) else None
    if bias is not None:
        if rows % _bias_rows(bias):
            raise ValueError(f"bias rows ({_bias_rows(bias)}) must divide "
                             f"q's flattened leading dims ({rows})")
        if isinstance(bias, BucketedBias):
            rel = (bias.bidirectional, int(bias.max_distance),
                   int(bias.q_offset), int(bias.k_offset))
            bias_t = bias.table
    o = _FlashFlat.apply(q_, k_, v_, bias_t, kv_lens, s_scale, bool(causal),
                         rel, impl, drop)
    return o.reshape(*lead, q.shape[-2], d)


# --- the fused projection + attention block -----------------------------------

class _FusedQKVAttention(torch.autograd.Function):
    """Forward ``_fused_attn_fwd`` (``:581-609``), backward
    ``_fused_attn_bwd`` (``:612-641``); saves what the reference saves:
    x, the packed qkv, o, lse and the two weights."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_out, h, h_kv, d, scale, causal,
                impl, drop):
        qkv = F.linear(x, w_qkv, b_qkv)
        o, lse = flash_fwd_packed(qkv, h, h_kv, d, scale=scale,
                                  causal=causal, dropout_rate=drop[0],
                                  dropout_seed=drop[1], impl=impl)
        y = F.linear(o, w_out)
        ctx.save_for_backward(x, qkv, o, lse, w_qkv, w_out)
        ctx.attn = (h, h_kv, d, scale, causal, impl, b_qkv is not None, drop)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, qkv, o, lse, w_qkv, w_out = ctx.saved_tensors
        h, h_kv, d, scale, causal, impl, has_bias, drop = ctx.attn
        b, s, H = x.shape
        T = b * s
        dy2 = dy.reshape(T, -1)
        dw_out = dy2.t() @ o.reshape(T, h * d)
        do = (dy2 @ w_out).reshape(b, s, h * d)
        dq, dk, dv = flash_bwd_packed(qkv, o, lse, do, h, h_kv, d,
                                      scale=scale, causal=causal,
                                      dropout_rate=drop[0],
                                      dropout_seed=drop[1], impl=impl)
        del do
        x2 = x.reshape(T, H)
        dq2, dk2, dv2 = dq.reshape(T, -1), dk.reshape(T, -1), dv.reshape(T, -1)
        wq = w_qkv[:h * d]
        wk = w_qkv[h * d:(h + h_kv) * d]
        wv = w_qkv[(h + h_kv) * d:]
        dx = (dq2 @ wq + dk2 @ wk + dv2 @ wv).reshape(b, s, H)
        dw_qkv = torch.cat([dq2.t() @ x2, dk2.t() @ x2, dv2.t() @ x2], 0)
        db_qkv = (torch.cat([dq2.sum(0), dk2.sum(0), dv2.sum(0)]).to(
            w_qkv.dtype) if has_bias else None)
        return (dx, dw_qkv.to(w_qkv.dtype), db_qkv, dw_out.to(w_out.dtype),
                None, None, None, None, None, None, None)


def fused_qkv_attention(x: torch.Tensor, w_qkv: torch.Tensor,
                        b_qkv: Optional[torch.Tensor], w_out: torch.Tensor,
                        h: int, h_kv: int, d: int, scale: float,
                        causal: bool = True, *, dropout_rate: float = 0.0,
                        dropout_seed: Optional[Union[int,
                                                     torch.Tensor]] = None,
                        impl: str = "auto") -> torch.Tensor:
    """Packed-QKV projection → flash attention → output projection as ONE
    differentiable block. ``x`` (b, s, H); ``w_qkv`` ((h + 2·h_kv)·d, H)
    packed q|k|v (heads contiguous per part); ``b_qkv`` ((h+2·h_kv)·d,) or
    None; ``w_out`` (O, h·d). Returns (b, s, O): the output-projection
    bias stays with the caller (``gpt.py:404-406``). The plain GEMMs are
    ``F.linear``/``matmul``; the attention is the flash kernels on a CUDA
    tensor (an unsupported shape or dtype raises) and the plain version on
    a CPU tensor or with ``impl="torch"``. The backward returns dq/dk/dv
    separately and contracts each against its weight window: dx sums three
    GEMMs, dW_qkv concatenates three, db_qkv three column sums.
    ``dropout_rate > 0`` drops the probabilities in the flash kernels
    (``:545-547``; the seed as :func:`flash_attention`'s), the backward
    rebuilding the mask from the seed."""
    drop = (float(dropout_rate), _check_dropout(dropout_rate, dropout_seed))
    if x.ndim != 3 or w_qkv.shape != ((h + 2 * h_kv) * d, x.shape[-1]) \
            or w_out.shape[-1] != h * d:
        raise ValueError(
            f"fused_qkv_attention: x (b, s, H), w_qkv ((h + 2*h_kv)*d, H) and "
            f"w_out (O, h*d); got x {tuple(x.shape)}, w_qkv "
            f"{tuple(w_qkv.shape)}, w_out {tuple(w_out.shape)} for h={h}, "
            f"h_kv={h_kv}, d={d}")
    return _FusedQKVAttention.apply(x, w_qkv, b_qkv, w_out, h, h_kv, d,
                                    float(scale), bool(causal), impl, drop)
