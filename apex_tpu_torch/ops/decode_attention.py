"""Decode attention: one query token per sequence over a KV cache.

Port of ``apex_tpu/ops/decode_attention.py``: both cache layouts with the
reference's validation, and the dispatch of
:mod:`apex_tpu_torch.ops._backend` —

* the contiguous cache ``(b, h_kv, max_s, d)`` of the decode engine
  (``:98-200``): a CUDA tensor launches :func:`decode_attn_cuda`, the
  ``apex_decode_attn`` entry of ``csrc/paged_decode_attn.cu`` that
  replaces the Pallas ``decode_attn_fwd``; the kernel reads the per-batch
  lengths at row // h_kv (the reference repeats them over kv heads,
  ``:193``);
* the paged pool of the serving engine (``_paged_decode_attention``,
  ``:226-295``): a CUDA tensor launches :func:`paged_decode_attn_cuda`,
  replacing the Pallas ``decode_attn_paged_fwd``;
* a CPU tensor (or ``impl="torch"``) runs the plain version,
  :func:`_torch_decode` (after :func:`_gather_blocks` for the pool),
  ported from the reference's XLA fallback (``:53-95``).

Both kernels split each row's kv walk over a thread-block cluster of S
CTAs; :func:`_decode_plan` picks S, the ring of bulk-copied blocks and the
shared memory from the shapes alone (never from ``lengths``, which stay on
the card), and :func:`split_blocks` is the walk each rank takes.

Two options, as the reference's (never together: it refuses a quantized
pool with a bias, ``:252-270``):

* the quantized pool (``k_scale``/``v_scale``, the serving engine's
  ``kv_dtype``): int8 or float8_e4m3fn cells with one fp32 scale a block
  row. Its two plain versions differ by bf16 roundings:
  :func:`_torch_decode` on the reference's gathered view (the CPU path:
  dequantized cells rounded to q's dtype, p rounded to it too), and
  :func:`quant_decode_fp32`, the kernel's function (fp32 dequant, fp32 p:
  ``_decode_kernel``'s quant branch, ``:99-103``, ``:123-127``);
* the causal bucketed bias (``bias=BucketedBias``, T5's at decode): the
  query is position ``lengths - 1``; the kernels read the bias's per-head
  lookup (:meth:`~apex_tpu_torch.ops.attention.BucketedBias.
  kernel_operands`), the plain version adds the gathered table values
  (``_xla_decode``'s bias branch, ``:77-86``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _backend, _build
from apex_tpu_torch.ops.attention import (BucketedBias, _validate_bucketed,
                                          relative_position_bucket)
from apex_tpu_torch.ops.matmul import _sm_count

#: masked-score value (``apex_tpu/ops/pallas/attention.py:33``)
NEG_INF = -1e30

#: what the kernel is compiled for: head dims, query heads per kv head, and
#: rows per pool block (one softmax thread a block row)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8, 16)
KERNEL_MAX_BLOCK = 128
#: the contiguous cache's length must be a multiple of the kernel's
#: 128-row block (``decode_kernel_ok``, ``:36-42``)
KERNEL_CACHE_TILE = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: 1-byte pool dtypes dequantized with per-row scales (the serving
#: engine's kv_dtype="int8" / "fp8_e4m3" pools), and the kernel's code of
#: each (0: the pool holds q's dtype)
QUANT_POOL_DTYPES = (torch.int8, torch.float8_e4m3fn)
_KV_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
#: the bias's largest max_distance in the kernels' shared memory
KERNEL_MAX_DISTANCE = 4096

#: the kernel's CTA: eight warps
DECODE_THREADS = 256
#: cluster sizes the plan picks from (8: the portable cluster's most)
DECODE_SPLITS = (1, 2, 4, 8)
#: CTAs that share an SM's shared memory at most when the ring is sized
DECODE_CTAS_PER_SM = 2
#: ring slots at most (each one K or one V block): two blocks in flight
DECODE_MAX_TILES = 4
#: shared memory of an sm_90 SM, a CTA's most, and what the system keeps
#: of it for each resident CTA (bytes)
SMEM_PER_SM = 233472
SMEM_PER_CTA = 232448
SMEM_RESERVED = 1024


class DecodePlan(NamedTuple):
    """One decode launch: each row's walk split over a cluster of
    ``splits`` CTAs (a grid of rows × splits), each with a ring of
    ``tiles`` bulk-copied blocks in ``smem`` bytes of dynamic shared
    memory."""
    splits: int
    tiles: int
    smem: int


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def decode_smem(elem: int, d: int, group: int, bs: int, tiles: int,
                splits: int, kv_elem: Optional[int] = None,
                quant: bool = False, maxd: int = 0) -> int:
    """A CTA's dynamic shared memory (bytes), as the kernel lays it out
    (``Layout`` in ``csrc/paged_decode_attn.cu``): the ring (``tiles``
    blocks of bs × d cells of ``kv_elem`` bytes, q's ``elem`` when None,
    overlaid after the walk by the warps' fp32 PV sums), q, two parity
    buffers of a block's scores, the per-warp maxima and sums, a quantized
    pool's scales (bs fp32 a ring slot), the bias's lookup (group × (maxd
    + 1) fp32), ``splits`` slots of a CTA's state (acc, m, l: its own, and
    at rank 0 its peers'), and the mbarriers (the ring's and the
    merge's)."""
    warps = DECODE_THREADS // 32
    kv_elem = elem if kv_elem is None else kv_elem
    q = _up(max(tiles * bs * d * kv_elem, warps * group * d * 4), 128)
    s = q + _up(group * d * elem, 16)
    red = s + _up(2 * group * bs * 4, 16)
    sc = red + _up(2 * warps * group * 4, 16)
    lut = sc + (_up(tiles * bs * 4, 16) if quant else 0)
    state = lut + _up(group * (maxd + 1 if maxd else 0) * 4, 16)
    bars = state + splits * _up((group * d + 2 * group) * 4, 16)
    return bars + (tiles + 1) * 8


def decode_splits(rows: int, nb: int, sms: int) -> int:
    """The cluster size S: the largest of 1, 2, 4, 8 that keeps the grid of
    rows × S CTAs within one CTA for each of the card's ``sms`` SMs and
    gives each rank one of the walk's ``nb`` blocks. More CTAs than SMs
    only added launch and merge time in the timed sweeps (``PERF.md``):
    the walk is load-bound once every SM has a CTA."""
    s = 1
    while (s < DECODE_SPLITS[-1] and 2 * s <= nb
           and rows * 2 * s <= sms):
        s *= 2
    return s


def split_blocks(nblk: int, splits: int) -> Tuple[Tuple[int, ...], ...]:
    """The blocks each rank of a row's cluster walks, in order: rank r
    takes r, r + S, r + 2S, ... of the row's ``nblk`` live blocks (a
    strided share, so any live prefix is spread evenly)."""
    return tuple(tuple(range(r, nblk, splits)) for r in range(splits))


def decode_ring(elem: int, d: int, group: int, bs: int, nb: int,
                splits: int, ctas: int, sms: int,
                kv_elem: Optional[int] = None, quant: bool = False,
                maxd: int = 0) -> int:
    """The ring's tiles at a split: as many of a rank's K and V blocks (of
    the walk's ``nb``) in flight as :data:`DECODE_MAX_TILES` and the room
    left by the CTAs that share an SM (one, or :data:`DECODE_CTAS_PER_SM`
    where the grid's ``ctas`` outnumber the ``sms`` SMs) allow, at least
    one block's two."""
    want = min(2 * -(-nb // splits), DECODE_MAX_TILES)
    resident = min(-(-ctas // sms), DECODE_CTAS_PER_SM)
    share = min(SMEM_PER_SM // resident - SMEM_RESERVED, SMEM_PER_CTA)
    tiles = 2
    while tiles < want and decode_smem(elem, d, group, bs, tiles + 1,
                                       splits, kv_elem, quant,
                                       maxd) <= share:
        tiles += 1
    return tiles


@functools.lru_cache(maxsize=None)
def _decode_plan(rows: int, nb: int, bs: int, d: int, group: int,
                 dtype: torch.dtype, sms: int,
                 kv_dtype: Optional[torch.dtype] = None,
                 maxd: int = 0) -> DecodePlan:
    """Every host-side decision of a decode launch, from what the host
    already knows (rows, the walk's ``nb`` blocks of ``bs`` rows, d, the
    group, the dtype, the card's SMs, a quantized pool's ``kv_dtype``, the
    bias's ``maxd``), never from the lengths: the split
    (:func:`decode_splits`), the ring (:func:`decode_ring`) and the shared
    memory."""
    splits = decode_splits(rows, nb, sms)
    return plan_at(rows, nb, bs, d, group, dtype, sms, splits, kv_dtype,
                   maxd)


def plan_at(rows: int, nb: int, bs: int, d: int, group: int,
            dtype: torch.dtype, sms: int, splits: int,
            kv_dtype: Optional[torch.dtype] = None,
            maxd: int = 0) -> DecodePlan:
    """The plan of a launch split ``splits`` ways: its ring, shared memory
    and grid (``chip_smoke.py`` times each split so)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    quant = kv_dtype in QUANT_POOL_DTYPES
    kv_elem = 1 if quant else elem
    tiles = decode_ring(elem, d, group, bs, nb, splits, rows * splits, sms,
                        kv_elem, quant, maxd)
    smem = decode_smem(elem, d, group, bs, tiles, splits, kv_elem, quant,
                       maxd)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"the decode kernel needs {smem} bytes of shared "
                         f"memory at d={d}, group={group}, block={bs}, "
                         f"max_distance={maxd}; a CTA has {SMEM_PER_CTA}")
    return DecodePlan(splits, tiles, smem)


def _plan_for(q: torch.Tensor, nb: int, bs: int,
              kv_dtype: Optional[torch.dtype] = None,
              maxd: int = 0) -> DecodePlan:
    rows, group, d = q.shape
    index = q.device.index
    return _decode_plan(rows, nb, bs, d, group, q.dtype, _sm_count(
        torch.cuda.current_device() if index is None else index), kv_dtype,
        maxd)


def max_active_clusters(plan: DecodePlan, dtype: torch.dtype, d: int,
                        group: int, bs: int, paged: bool,
                        kv_dtype: Optional[torch.dtype] = None,
                        maxd: int = 0) -> int:
    """How many of ``plan``'s clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``) on the instance of a quantized
    pool's ``kv_dtype`` or the bias's ``maxd``; 0: the card refuses the
    launch. Needs the card."""
    n = ctypes.c_int(0)
    rc = _build.library().apex_decode_attn_clusters(
        int(paged), _DTYPE_CODES[dtype], d, group, bs, plan.splits,
        plan.tiles, plan.smem, _KV_CODES.get(kv_dtype, 0), maxd,
        ctypes.byref(n))
    _build.check(rc, "decode_attn_clusters")
    return n.value


def _gather_blocks(pool: torch.Tensor, tables: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(num_blocks, h_kv, bs, d) pool + (b, nb) tables → the contiguous
    (b, h_kv, nb·bs, d) per-slot view, as one gather. ``scale``
    ((num_blocks, bs) fp32, a quantized pool) dequantizes the gathered
    cells, cell × its row's scale in fp32, cast to ``out_dtype``
    (``:53-74``)."""
    t = tables.long()
    g = pool[t]  # (b, nb, h_kv, bs, d)
    b, nb, h_kv, bs, d = g.shape
    if scale is not None:
        g = (g.float() * scale[t][:, :, None, :, None]).to(out_dtype)
    return g.permute(0, 2, 1, 3, 4).reshape(b, h_kv, nb * bs, d)


def _bias_scores(bias, lengths: torch.Tensor, h_kv: int, group: int,
                 max_s: int) -> torch.Tensor:
    """The causal bucketed bias of every (row, query head, column) as
    (b, h_kv, group, 1, max_s) fp32: the query sits at ``lengths - 1``,
    keys at [0, max_s) (``_xla_decode``'s bias branch, ``:77-86``)."""
    rel = (torch.arange(max_s, dtype=torch.int32,
                        device=lengths.device)[None, :]
           - (lengths.to(torch.int32)[:, None] - 1))
    buckets = relative_position_bucket(
        rel, bidirectional=False, num_buckets=bias.num_buckets,
        max_distance=bias.max_distance)                      # (b, max_s)
    vals = bias.table.float().to(lengths.device)[buckets.long()]  # (b, s, h)
    b = lengths.shape[0]
    return vals.permute(0, 2, 1).reshape(b, h_kv, group, 1, max_s)


def _torch_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, scale: float,
                  bias=None) -> torch.Tensor:
    """(b, h_kv, group, d) q against a (b, h_kv, max_s, d) cache: fp32
    scores (plus the causal bucketed ``bias``), masked softmax, p cast to
    v's dtype for the PV product, and length-0 rows zeroed (the kernel's
    dead-row convention)."""
    s = torch.einsum("bgqd,bgkd->bgqk", q.float(), k.float()) * scale
    if bias is not None:
        b, h_kv, group, max_s = s.shape
        s = s + _bias_scores(bias, lengths, h_kv, group, max_s)[:, :, :, 0]
    mask = (torch.arange(k.shape[2], device=k.device)[None, None, None, :]
            < lengths[:, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bgkd->bgqd", p.to(v.dtype), v)
    dead = (lengths == 0)[:, None, None, None]
    return o.masked_fill(dead, 0.0).to(q.dtype)


def quant_decode_fp32(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, lengths: torch.Tensor,
                      block_tables: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, *,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The quantized kernel's function in fp32, its plain version on the
    card: q (b, h, d), 1-byte pools (num_blocks, h_kv, bs, d), per-row
    scales (num_blocks, bs) → (b, h, d) in q's dtype. Cells dequantize to
    fp32 (never rounded to q's dtype) and p stays fp32 for the PV product,
    as ``_decode_kernel``'s quant branch (``:99-103``, ``:123-127``); the
    CPU path (:func:`decode_attention`) follows the reference's fallback
    instead, whose dequantized cells and p are rounded to q's dtype (the
    two agree exactly in fp32)."""
    b, h, d = q.shape
    h_kv = k_pool.shape[1]
    scale = float(scale if scale is not None else 1.0 / d ** 0.5)
    qg = q.float().reshape(b, h_kv, h // h_kv, d)
    k = _gather_blocks(k_pool, block_tables, k_scale, torch.float32)
    v = _gather_blocks(v_pool, block_tables, v_scale, torch.float32)
    o = _torch_decode(qg, k, v, lengths.to(torch.int32), scale)
    return o.reshape(b, h, d).to(q.dtype)


def _rel_operands(bias, h: int, device: torch.device):
    """The bias's per-head lookup (h, 2·maxd + 1) fp32, contiguous on
    ``device``, and maxd; (None, 0) without a bias."""
    if bias is None:
        return None, 0
    if bias.max_distance > KERNEL_MAX_DISTANCE:
        raise ValueError(f"the decode kernels take max_distance <= "
                         f"{KERNEL_MAX_DISTANCE}; got {bias.max_distance}")
    lut = bias.kernel_operands()[0]
    if lut.shape[0] != h:
        raise ValueError(f"decode bias table heads ({lut.shape[0]}) must "
                         f"equal q heads ({h})")
    return lut.to(device).contiguous(), int(bias.max_distance)


def _count_options(fn, kv_dtype=None, rel: bool = False) -> None:
    """One launch of a decode wrapper: ``.launches``, on an int8 or fp8
    pool (``.int8_launches``, ``.fp8_launches``), with the bias
    (``.rel_launches``)."""
    fn.launches += 1
    if kv_dtype == torch.int8:
        fn.int8_launches += 1
    elif kv_dtype == torch.float8_e4m3fn:
        fn.fp8_launches += 1
    if rel:
        fn.rel_launches += 1


def paged_decode_attn_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, lengths: torch.Tensor,
                           block_tables: torch.Tensor, *,
                           scale: float,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           rel_bias=None,
                           planted_fault: Optional[str] = None
                           ) -> torch.Tensor:
    """Launch the paged decode kernel. q ``(b·h_kv, group, d)``; pools
    ``(num_blocks, h_kv, bs, d)``; ``block_tables`` ``(b, nb)`` int32;
    ``lengths`` ``(b,)`` int32. Returns ``(b·h_kv, group, d)``.

    A quantized pool (int8 or float8_e4m3fn cells, bf16 q) comes with
    ``k_scale``/``v_scale`` ``(num_blocks, bs)`` fp32 (bs a multiple of
    4); its instance computes :func:`quant_decode_fp32`. ``rel_bias``: a
    causal BucketedBias whose heads are q's (bf16 q). Never both.
    ``planted_fault="unit_scales"`` launches with every scale 1 (for the
    chip checks to refuse).

    Every table entry a slot's length reaches must be a valid pool block
    (the serving engine's tables are; unused entries hold the dead block)
    — the kernel trusts them. Counts its launches in ``.launches``, on
    int8 and fp8 pools in ``.int8_launches`` and ``.fp8_launches``, with
    the bias in ``.rel_launches``."""
    rows, group, d = q.shape
    num_blocks, h_kv, bs, _ = k_pool.shape
    b, nb = block_tables.shape
    quant = k_pool.dtype in QUANT_POOL_DTYPES
    tensors = (q, k_pool, v_pool, lengths, block_tables,
               *((k_scale, v_scale) if quant else ()))
    if any(t is None for t in tensors) or any(
            t.device != q.device or t.device.type != "cuda"
            for t in tensors):
        raise ValueError("paged_decode_attn_cuda takes CUDA tensors on one "
                         "device (and k_scale, v_scale with a quantized "
                         "pool)")
    if quant:
        if q.dtype != torch.bfloat16 or v_pool.dtype != k_pool.dtype \
                or rel_bias is not None:
            raise ValueError(
                f"the quantized decode kernel takes bfloat16 q, pools of "
                f"one 1-byte dtype and no bias; got q {q.dtype}, k "
                f"{k_pool.dtype}, v {v_pool.dtype}")
        if any(t.dtype != torch.float32 or tuple(t.shape) != (num_blocks, bs)
               for t in (k_scale, v_scale)) or bs % 4:
            raise ValueError(
                f"k_scale/v_scale must be ({num_blocks}, {bs}) float32 with "
                f"a block size that is a multiple of 4 (the kernel copies "
                f"a block's scales in 16-byte units)")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("k_scale/v_scale come with a quantized pool only")
    elif q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(
            f"the paged decode kernel takes float32 or bfloat16 q and pools "
            f"of the same dtype; got q {q.dtype}, k {k_pool.dtype}, "
            f"v {v_pool.dtype}")
    if rel_bias is not None and q.dtype != torch.bfloat16:
        raise ValueError("the decode kernels' bias instances take bfloat16")
    if d not in KERNEL_HEAD_DIMS or group not in KERNEL_GROUPS \
            or bs > KERNEL_MAX_BLOCK:
        raise ValueError(
            f"the paged decode kernel is built for head_dim in "
            f"{KERNEL_HEAD_DIMS}, {KERNEL_GROUPS} query heads per kv head "
            f"and blocks of at most {KERNEL_MAX_BLOCK} rows; got d={d}, "
            f"group={group}, block_size={bs}")
    if v_pool.shape != k_pool.shape or rows != b * h_kv \
            or k_pool.shape[3] != d or lengths.shape != (b,):
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attn_cuda takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors[1:3] + tensors[5:]):
        raise ValueError("the kernel copies the pools (and scales) in "
                         "16-byte units: their storage must be 16-byte "
                         "aligned")
    if planted_fault not in (None, "unit_scales"):
        raise ValueError(f"planted_fault must be None or 'unit_scales'; got "
                         f"{planted_fault!r}")
    if planted_fault is not None:
        if not quant:
            raise ValueError("planted_fault='unit_scales' needs a "
                             "quantized pool")
        k_scale = v_scale = torch.ones_like(k_scale)
    lut, maxd = _rel_operands(rel_bias, rows // b * group, q.device)
    kv_dtype = k_pool.dtype if quant else None
    plan = _plan_for(q, nb, bs, kv_dtype, maxd)
    out = torch.empty_like(q)
    rc = _build.library().apex_paged_decode_attn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h_kv, group, d, bs, nb, float(scale),
        plan.splits, plan.tiles, plan.smem,
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, _KV_CODES.get(kv_dtype, 0),
        None if lut is None else lut.data_ptr(), maxd,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_decode_attn")
    _count_options(paged_decode_attn_cuda, kv_dtype, lut is not None)
    return out


paged_decode_attn_cuda.launches = 0
paged_decode_attn_cuda.int8_launches = 0
paged_decode_attn_cuda.fp8_launches = 0
paged_decode_attn_cuda.rel_launches = 0


def decode_kernel_ok(max_s: int, d: int, group: int,
                     dtype: torch.dtype) -> bool:
    """What the contiguous decode kernel takes: a cache length that is a
    multiple of 128, a head dim of 64 or 128, a group count it is compiled
    for, float32 or bfloat16."""
    return (max_s >= KERNEL_CACHE_TILE and max_s % KERNEL_CACHE_TILE == 0
            and d in KERNEL_HEAD_DIMS and group in KERNEL_GROUPS
            and dtype in _DTYPE_CODES)


def decode_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float,
                     rel_bias=None) -> torch.Tensor:
    """Launch the contiguous decode kernel. q ``(rows, group, d)``; k/v
    ``(rows, max_s, d)`` with rows = b·h_kv; ``lengths`` ``(b,)`` int32,
    one per batch row (the kernel reads row r's at r // h_kv);
    ``rel_bias`` a causal BucketedBias whose heads are q's (bf16). Returns
    ``(rows, group, d)``. Counts its launches in ``.launches``, those with
    the bias in ``.rel_launches``."""
    rows, group, d = q.shape
    max_s = k.shape[1]
    b = lengths.shape[0] if lengths.ndim == 1 else 0
    h_kv = rows // b if b and rows % b == 0 else 0
    tensors = (q, k, v, lengths)
    if any(t.device != q.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("decode_attn_cuda takes CUDA tensors on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype \
            or not decode_kernel_ok(max_s, d, group, q.dtype):
        raise ValueError(
            f"the decode kernel takes float32 or bfloat16 q and cache of one "
            f"dtype, head_dim in {KERNEL_HEAD_DIMS}, {KERNEL_GROUPS} query "
            f"heads per kv head and a cache length that is a multiple of "
            f"{KERNEL_CACHE_TILE}; got q {q.dtype}, k {k.dtype}, v "
            f"{v.dtype}, d={d}, group={group}, max_s={max_s}")
    if rel_bias is not None and q.dtype != torch.bfloat16:
        raise ValueError("the decode kernels' bias instances take bfloat16")
    if k.shape != (rows, max_s, d) or v.shape != k.shape or not h_kv \
            or lengths.dtype != torch.int32:
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, lengths {tuple(lengths.shape)} "
            f"{lengths.dtype} (int32, (b,) with b dividing the rows)")
    if not all(t.is_contiguous() for t in tensors) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attn_cuda takes contiguous tensors, the "
                         "cache 16-byte aligned")
    lut, maxd = _rel_operands(rel_bias, h_kv * group, q.device)
    plan = _plan_for(q, max_s // KERNEL_CACHE_TILE, KERNEL_CACHE_TILE, None,
                     maxd)
    out = torch.empty_like(q)
    rc = _build.library().apex_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], b, h_kv, group, d, max_s,
        float(scale), plan.splits, plan.tiles, plan.smem,
        None if lut is None else lut.data_ptr(), maxd,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attn")
    _count_options(decode_attn_cuda, rel=lut is not None)
    return out


decode_attn_cuda.launches = 0
decode_attn_cuda.rel_launches = 0


def _validate_decode_bias(bias, h: int):
    """The reference's checks of a decode bias (``:202-223``): a causal
    BucketedBias whose table heads equal q's heads."""
    if bias is None:
        return None
    if not isinstance(bias, BucketedBias):
        raise ValueError(
            "decode_attention takes bias as a BucketedBias (decode "
            "recomputes the bias from the table and the live length; a "
            "materialized array has no decode form)")
    _validate_bucketed(bias)
    if bias.bidirectional:
        raise ValueError(
            "decode bias must use causal bucketing (bidirectional=False) — "
            "the query IS the last position")
    if bias.heads != h:
        raise ValueError(f"decode bias table heads ({bias.heads}) must "
                         f"equal q heads ({h})")
    return bias


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     block_tables: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None, impl: str = "auto",
                     bias=None, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of ONE query token per sequence over a KV cache.

    ``q`` (b, h, d); ``lengths`` (b,) live positions per sequence, the new
    token's row already written. Positions >= the length are masked; a
    length-0 sequence returns zeros. Returns (b, h, d).

    Without ``block_tables``, ``k``/``v`` are the contiguous cache
    ``(b, h_kv, max_s, d)`` (h_kv | h). With ``block_tables`` (b, nb)
    integer, they are the shared pool ``(num_blocks, h_kv, block_size,
    d)`` and slot i's j-th logical block lives at pool index
    ``block_tables[i, j]`` (unused entries hold the dead block 0).

    ``bias``: a causal :class:`~apex_tpu_torch.ops.attention.BucketedBias`
    whose table heads are q's — T5's relative bias at decode, the query at
    position ``lengths - 1``. ``k_scale``/``v_scale``: the quantized paged
    pool (int8 or float8_e4m3fn cells), ``(num_blocks, block_size)`` fp32
    per-row scales; required exactly when the pool is quantized, never
    with a contiguous cache or a bias (the reference's validation, with
    its exception types)."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"decode_attention takes q (b, h, d) and k/v (b, h_kv, max_s, "
            f"d) — or (num_blocks, h_kv, block_size, d) pools with "
            f"block_tables; got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}")
    b, h, d = q.shape
    h_kv = k.shape[1]
    quant = k.dtype in QUANT_POOL_DTYPES
    if block_tables is None:
        if k_scale is not None or quant:
            raise ValueError(
                "quantized k/v pools (and their k_scale/v_scale) are the "
                "PAGED path only — pass block_tables (the serving engine's "
                "kv_dtype knob; the contiguous DecodeEngine cache keeps a "
                "float dtype)")
        return _contiguous(q, k, v, lengths, scale, impl,
                           _validate_decode_bias(bias, h))
    num_blocks, bs = k.shape[0], k.shape[2]
    if k.shape[3] != d or h % h_kv:
        raise ValueError(
            f"paged cache pool (num_blocks, h_kv, block_size, d) must match "
            f"q's head_dim with h_kv | h; got q {tuple(q.shape)} vs pool "
            f"{tuple(k.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be (b={b}, nb_max); got "
                         f"{tuple(block_tables.shape)}")
    if block_tables.dtype.is_floating_point or block_tables.dtype == \
            torch.bool:
        raise ValueError(f"block_tables must be integer block ids; got "
                         f"{block_tables.dtype}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},); got "
                         f"{tuple(lengths.shape)}")
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError(
            f"quantized pools require BOTH k_scale and v_scale (and float "
            f"pools take neither): the per-row scales are half the "
            f"quantized representation — got k dtype {k.dtype}, k_scale "
            f"{'set' if k_scale is not None else 'None'}, v_scale "
            f"{'set' if v_scale is not None else 'None'}")
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != (num_blocks, bs):
                raise ValueError(
                    f"{name} must be (num_blocks={num_blocks}, "
                    f"block_size={bs}) per-row scales; got "
                    f"{tuple(sc.shape)}")
        if bias is not None:
            raise ValueError(
                "quantized paged decode does not carry the bucketed "
                "relative bias (no quantized kernel path exists for the "
                "bias composition) — serve T5-style models with a float "
                "kv_dtype")
    bias = _validate_decode_bias(bias, h)
    group = h // h_kv
    scale = float(scale if scale is not None else 1.0 / d ** 0.5)
    qg = q.reshape(b, h_kv, group, d)
    if _backend.use_kernel(q, impl):
        o = paged_decode_attn_cuda(
            qg.reshape(b * h_kv, group, d).contiguous(), k, v,
            lengths.to(torch.int32).contiguous(),
            block_tables.to(torch.int32).contiguous(), scale=scale,
            k_scale=k_scale, v_scale=v_scale, rel_bias=bias)
        return o.reshape(b, h, d)
    out_dtype = q.dtype if quant else None
    return _torch_decode(qg, _gather_blocks(k, block_tables, k_scale,
                                            out_dtype),
                         _gather_blocks(v, block_tables, v_scale, out_dtype),
                         lengths.to(torch.int32), scale,
                         bias).reshape(b, h, d)


def _contiguous(q, k, v, lengths, scale, impl, bias):
    """The contiguous-cache path (``:176-200``)."""
    b, h, d = q.shape
    h_kv, max_s = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % h_kv:
        raise ValueError(
            f"cache (b, h_kv, max_s, d) must match q's batch/head_dim with "
            f"h_kv | h; got q {tuple(q.shape)} vs cache {tuple(k.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},); got "
                         f"{tuple(lengths.shape)}")
    lengths = lengths.to(torch.int32)
    group = h // h_kv
    scale = float(scale if scale is not None else 1.0 / d ** 0.5)
    qg = q.reshape(b, h_kv, group, d)
    if _backend.use_kernel(q, impl):
        o = decode_attn_cuda(
            qg.reshape(b * h_kv, group, d).contiguous(),
            k.reshape(b * h_kv, max_s, d), v.reshape(b * h_kv, max_s, d),
            lengths.contiguous(), scale=scale, rel_bias=bias)
        return o.reshape(b, h, d)
    return _torch_decode(qg, k, v, lengths, scale, bias).reshape(b, h, d)
