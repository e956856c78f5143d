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

Quantized pools and the bucketed relative bias are later slices of the
port and raise here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _backend, _build
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
                splits: int) -> int:
    """A CTA's dynamic shared memory (bytes), as the kernel lays it out
    (``Layout`` in ``csrc/paged_decode_attn.cu``): the ring (``tiles``
    blocks of bs × d elements, overlaid after the walk by the warps' fp32
    PV sums), q, two parity buffers of a block's scores, the per-warp
    maxima and sums, ``splits`` slots of a CTA's state (acc, m, l: its own,
    and at rank 0 its peers'), and the mbarriers (the ring's and the
    merge's)."""
    warps = DECODE_THREADS // 32
    q = _up(max(tiles * bs * d * elem, warps * group * d * 4), 128)
    s = q + _up(group * d * elem, 16)
    red = s + _up(2 * group * bs * 4, 16)
    state = red + _up(2 * warps * group * 4, 16)
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
                splits: int, ctas: int, sms: int) -> int:
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
                                       splits) <= share:
        tiles += 1
    return tiles


@functools.lru_cache(maxsize=None)
def _decode_plan(rows: int, nb: int, bs: int, d: int, group: int,
                 dtype: torch.dtype, sms: int) -> DecodePlan:
    """Every host-side decision of a decode launch, from what the host
    already knows (rows, the walk's ``nb`` blocks of ``bs`` rows, d, the
    group, the dtype, the card's SMs), never from the lengths: the split
    (:func:`decode_splits`), the ring (:func:`decode_ring`) and the shared
    memory."""
    splits = decode_splits(rows, nb, sms)
    return plan_at(rows, nb, bs, d, group, dtype, sms, splits)


def plan_at(rows: int, nb: int, bs: int, d: int, group: int,
            dtype: torch.dtype, sms: int, splits: int) -> DecodePlan:
    """The plan of a launch split ``splits`` ways: its ring, shared memory
    and grid (``chip_smoke.py`` times each split so)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    tiles = decode_ring(elem, d, group, bs, nb, splits, rows * splits, sms)
    smem = decode_smem(elem, d, group, bs, tiles, splits)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"the decode kernel needs {smem} bytes of shared "
                         f"memory at d={d}, group={group}, block={bs}; a "
                         f"CTA has {SMEM_PER_CTA}")
    return DecodePlan(splits, tiles, smem)


def _plan_for(q: torch.Tensor, nb: int, bs: int) -> DecodePlan:
    rows, group, d = q.shape
    index = q.device.index
    return _decode_plan(rows, nb, bs, d, group, q.dtype, _sm_count(
        torch.cuda.current_device() if index is None else index))


def max_active_clusters(plan: DecodePlan, dtype: torch.dtype, d: int,
                        group: int, bs: int, paged: bool) -> int:
    """How many of ``plan``'s clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``); 0: the card refuses the
    launch. Needs the card."""
    n = ctypes.c_int(0)
    rc = _build.library().apex_decode_attn_clusters(
        int(paged), _DTYPE_CODES[dtype], d, group, bs, plan.splits,
        plan.tiles, plan.smem, ctypes.byref(n))
    _build.check(rc, "decode_attn_clusters")
    return n.value


def _gather_blocks(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(num_blocks, h_kv, bs, d) pool + (b, nb) tables → the contiguous
    (b, h_kv, nb·bs, d) per-slot view, as one gather."""
    g = pool[tables.long()]  # (b, nb, h_kv, bs, d)
    b, nb, h_kv, bs, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h_kv, nb * bs, d)


def _torch_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """(b, h_kv, group, d) q against a (b, h_kv, max_s, d) cache: fp32
    scores, masked softmax, p cast to v's dtype for the PV product, and
    length-0 rows zeroed (the kernel's dead-row convention)."""
    s = torch.einsum("bgqd,bgkd->bgqk", q.float(), k.float()) * scale
    mask = (torch.arange(k.shape[2], device=k.device)[None, None, None, :]
            < lengths[:, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bgkd->bgqd", p.to(v.dtype), v)
    dead = (lengths == 0)[:, None, None, None]
    return o.masked_fill(dead, 0.0).to(q.dtype)


def paged_decode_attn_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, lengths: torch.Tensor,
                           block_tables: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """Launch the paged decode kernel. q ``(b·h_kv, group, d)``; pools
    ``(num_blocks, h_kv, bs, d)``; ``block_tables`` ``(b, nb)`` int32;
    ``lengths`` ``(b,)`` int32. Returns ``(b·h_kv, group, d)``.

    Every table entry a slot's length reaches must be a valid pool block
    (the serving engine's tables are; unused entries hold the dead block)
    — the kernel trusts them. Counts its launches in ``.launches``."""
    rows, group, d = q.shape
    num_blocks, h_kv, bs, _ = k_pool.shape
    b, nb = block_tables.shape
    tensors = (q, k_pool, v_pool, lengths, block_tables)
    if any(t.device != q.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("paged_decode_attn_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(
            f"the paged decode kernel takes float32 or bfloat16 q and pools "
            f"of the same dtype; got q {q.dtype}, k {k_pool.dtype}, "
            f"v {v_pool.dtype}")
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
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the kernel copies the pools in 16-byte units: "
                         "their storage must be 16-byte aligned")
    plan = _plan_for(q, nb, bs)
    out = torch.empty_like(q)
    rc = _build.library().apex_paged_decode_attn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h_kv, group, d, bs, nb, float(scale),
        plan.splits, plan.tiles, plan.smem,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_decode_attn")
    paged_decode_attn_cuda.launches += 1
    return out


paged_decode_attn_cuda.launches = 0


def decode_kernel_ok(max_s: int, d: int, group: int,
                     dtype: torch.dtype) -> bool:
    """What the contiguous decode kernel takes: a cache length that is a
    multiple of 128, a head dim of 64 or 128, a group count it is compiled
    for, float32 or bfloat16."""
    return (max_s >= KERNEL_CACHE_TILE and max_s % KERNEL_CACHE_TILE == 0
            and d in KERNEL_HEAD_DIMS and group in KERNEL_GROUPS
            and dtype in _DTYPE_CODES)


def decode_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Launch the contiguous decode kernel. q ``(rows, group, d)``; k/v
    ``(rows, max_s, d)`` with rows = b·h_kv; ``lengths`` ``(b,)`` int32,
    one per batch row (the kernel reads row r's at r // h_kv). Returns
    ``(rows, group, d)``. Counts its launches in ``.launches``."""
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
    plan = _plan_for(q, max_s // KERNEL_CACHE_TILE, KERNEL_CACHE_TILE)
    out = torch.empty_like(q)
    rc = _build.library().apex_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], b, h_kv, group, d, max_s,
        float(scale), plan.splits, plan.tiles, plan.smem,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attn")
    decode_attn_cuda.launches += 1
    return out


decode_attn_cuda.launches = 0


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
    ``block_tables[i, j]`` (unused entries hold the dead block 0)."""
    if bias is not None:
        raise NotImplementedError(
            "the bucketed relative bias (BucketedBias) at decode is a later "
            "slice of the port")
    if (k_scale is not None or v_scale is not None
            or k.dtype in (torch.int8, torch.float8_e4m3fn)):
        raise NotImplementedError(
            "quantized (int8 / fp8_e4m3) pools are a later slice of the "
            "port; serve with a float pool")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"decode_attention takes q (b, h, d) and k/v (b, h_kv, max_s, "
            f"d) — or (num_blocks, h_kv, block_size, d) pools with "
            f"block_tables; got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}")
    b, h, d = q.shape
    h_kv = k.shape[1]
    if block_tables is None:
        return _contiguous(q, k, v, lengths, scale, impl)
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
    group = h // h_kv
    scale = float(scale if scale is not None else 1.0 / d ** 0.5)
    qg = q.reshape(b, h_kv, group, d)
    if _backend.use_kernel(q, impl):
        o = paged_decode_attn_cuda(
            qg.reshape(b * h_kv, group, d).contiguous(), k, v,
            lengths.to(torch.int32).contiguous(),
            block_tables.to(torch.int32).contiguous(), scale=scale)
        return o.reshape(b, h, d)
    return _torch_decode(qg, _gather_blocks(k, block_tables),
                         _gather_blocks(v, block_tables),
                         lengths.to(torch.int32), scale).reshape(b, h, d)


def _contiguous(q, k, v, lengths, scale, impl):
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
            lengths.contiguous(), scale=scale)
        return o.reshape(b, h, d)
    return _torch_decode(qg, k, v, lengths, scale).reshape(b, h, d)
