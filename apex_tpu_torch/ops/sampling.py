"""Fused sampling tail: logits → temperature/top-k/top-p → token.

Port of ``apex_tpu/ops/sampling.py::fused_sample`` and the helpers of
``apex_tpu/ops/pallas/sampling.py`` (``:61-137``). The helpers below are the
plain PyTorch version: thresholds by 48-step bisection (no sort) and a
Gumbel-argmax draw. Dispatch follows :mod:`apex_tpu_torch.ops._backend`: a
CUDA tensor launches :func:`fused_sample_cuda` (the hand-written kernel
``apex_tpu_torch/csrc/fused_sample.cu``, replacing the Pallas
``fused_sample_fwd``), a CPU tensor runs the helpers.

The kernel splits each row over a thread-block cluster and finds the
top-k and top-p thresholds exactly by radix select (4 rounds of 8-bit
digits on the order-preserving key of each score) instead of bisecting;
:func:`_sample_plan` picks the split, the threads and the values a thread
from the shapes alone.

The uniform noise is an operand (``u``) or is drawn here from an explicit
``torch.Generator``. torch cannot reproduce JAX's threefry bits, so parity
with the reference is tested on shared noise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _backend, _build
from apex_tpu_torch.ops.matmul import _sm_count

#: masked-out logit value (``apex_tpu/ops/pallas/sampling.py:53``)
FILTERED = -1e30

#: bisection steps to a one-ulp threshold (``:58``)
BISECT_ITERS = 48

#: the widest row the kernel takes (its shares held in registers)
KERNEL_MAX_VOCAB = 49152
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: cluster sizes the plan picks from (16 ran slower than 8 at every timed
#: call: a round's merge and barrier grow with the cluster)
SAMPLE_SPLITS = (1, 2, 4, 8)
#: values a thread holds in registers, and a CTA's threads at most at each
#: (the kernel's launch bounds: 512 threads, 128 registers a thread)
SAMPLE_VALUES = {8: 512, 16: 512, 32: 512}
#: the fewest threads a CTA: one for each of the 256 bins of a radix round
SAMPLE_MIN_THREADS = 256
#: the fewest values a rank's share holds when the split is not forced
SAMPLE_MIN_SHARE = 256
#: a CTA's static shared memory (``Shared`` in ``csrc/sample_cluster.cuh``,
#: bytes): two 256-bin u64 histograms, the scan's 8 warp totals, the
#: selected digit and its masses, the largest keys, the ranks' and the
#: warps' draws, then rank 0's gathered entries (8 ranks x 256 of key,
#: score and index, their counts, 256 compacted keys and u64 masses)
SAMPLE_SMEM = (2 * 256 * 8 + 8 * 8 + 2 * 8 + 3 * 4 + 2 * 8 * 4 + 3 * 32 * 4
               + 3 * 8 * 256 * 4 + 8 * 4 + 256 * 4 + 4 + 256 * 8)
#: planted faults of the kernel's tests: the last rank of a cluster left
#: out of every merge, or top-k run with k + 1
PLANTED_FAULTS = ("drop_last_rank", "top_k_plus_one")


class SamplePlan(NamedTuple):
    """One sampling launch: each row over a cluster of ``splits`` CTAs of
    ``threads`` threads; rank r holds ``share`` values of the row (the last
    rank what is left), ``values`` a thread in registers."""
    splits: int
    threads: int
    values: int
    share: int


def _share(V: int, splits: int) -> int:
    """A rank's share of a row of V: ceil(V / S), up to a multiple of 8 so
    every share starts on a 16-byte chunk."""
    return -(-(-(-V // splits)) // 8) * 8


def _fit(share: int) -> Optional[Tuple[int, int]]:
    """(threads, values a thread) that hold ``share`` values: the fewest
    values a thread, then whole warps and at least 256 threads; None if no
    CTA holds it in registers."""
    for values, most in SAMPLE_VALUES.items():
        threads = -(-(-(-share // values)) // 32) * 32
        if threads <= most:
            return max(threads, SAMPLE_MIN_THREADS), values
    return None


@functools.lru_cache(maxsize=None)
def _sample_plan(b: int, V: int, sms: int) -> SamplePlan:
    """The sampling launch from the shapes and the card's ``sms`` alone
    (never the logits): the largest cluster size S that keeps the grid of
    b × S CTAs within one CTA an SM (a second CTA an SM only adds fixed
    cost) and each rank's share at least :data:`SAMPLE_MIN_SHARE` values,
    but never less than the S whose shares fit a CTA's registers (V 32768
    needs S 2). The serve's decode steps (b 8) and prefill chunks (b 1)
    take S 8."""
    if not 1 <= V <= KERNEL_MAX_VOCAB:
        raise ValueError(f"the sampling kernel takes a row of 1 to "
                         f"{KERNEL_MAX_VOCAB} logits; got V={V}")
    least = next(S for S in SAMPLE_SPLITS if _fit(_share(V, S)))
    splits = least
    for S in SAMPLE_SPLITS:
        if S > least and b * S <= sms and _share(V, S) >= SAMPLE_MIN_SHARE:
            splits = S
    share = _share(V, splits)
    threads, values = _fit(share)
    return SamplePlan(splits, threads, values, share)


def _plan_for(logits: torch.Tensor) -> SamplePlan:
    b, V = logits.shape
    index = logits.device.index
    return _sample_plan(b, V, _sm_count(
        torch.cuda.current_device() if index is None else index))


def max_active_clusters(plan: SamplePlan, dtype: torch.dtype, V: int) -> int:
    """How many of ``plan``'s clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``); 0: the card refuses the launch.
    Needs the card."""
    n = ctypes.c_int(0)
    rc = _build.library().apex_fused_sample_clusters(
        _DTYPE_CODES[dtype], V, plan.splits, plan.threads, plan.values,
        plan.share, ctypes.byref(n))
    _build.check(rc, "fused_sample_clusters")
    return n.value


def uniform_noise(shape, generator: Optional[torch.Generator],
                  device: torch.device) -> torch.Tensor:
    """fp32 uniforms in [tiny, 1) from ``generator``: 0 is clamped away, so
    ``log(u)`` stays finite (``jax.random.uniform(minval=tiny)``'s range
    up to the excluded 1)."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device).clamp_min(
                          torch.finfo(torch.float32).tiny)


def _bisect(s: torch.Tensor, keep_mass: torch.Tensor, target,
            lo: Optional[torch.Tensor] = None,
            iters: int = BISECT_ITERS) -> torch.Tensor:
    """Largest threshold t (per row) with ``mass(s >= t) >= target``,
    where ``mass`` sums ``keep_mass`` over the kept entries. ``s`` (rows,
    V) fp32; returns (rows, 1). ``lo`` overrides the lower bound (it must
    still satisfy the mass condition)."""
    if lo is None:
        lo = s.amin(dim=-1, keepdim=True)
    hi = s.amax(dim=-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(s >= mid, keep_mass, 0.0).sum(dim=-1,
                                                        keepdim=True)
        ok = mass >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def apply_top_k(s: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep each row's ``top_k`` largest entries (ties at the k-th value
    all kept); the rest → FILTERED."""
    t = _bisect(s, torch.ones_like(s), float(top_k))
    return torch.where(s >= t, s, FILTERED)


def apply_top_p(s: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the minimal highest-probability set whose
    softmax mass reaches ``top_p``; the rest → FILTERED. The bisection
    starts from the minimum over LIVE entries — after top-k the row
    minimum is the FILTERED sentinel, which 48 halvings never leave."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)
    lo = torch.where(s > FILTERED * 0.5, s, m).amin(dim=-1, keepdim=True)
    t = _bisect(s, e, top_p * z, lo=lo)
    return torch.where(s >= t, s, FILTERED)


def gumbel_argmax(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One categorical draw over softmax(s) per row; ties to the lowest
    index. ``u`` uniform in (0, 1]."""
    x = s + (-torch.log(-torch.log(u)))
    m = x.amax(dim=-1, keepdim=True)
    V = x.shape[-1]
    idx = torch.arange(V, device=x.device)
    return torch.where(x == m, idx, V).amin(dim=-1).to(torch.int32)


def filtered_scaled(logits: torch.Tensor, *, temperature: float, top_k: int,
                    top_p: float) -> torch.Tensor:
    """fp32 cast → 1/T scale → top-k → top-p."""
    s = logits.float() * (1.0 / temperature)
    if top_k > 0:
        s = apply_top_k(s, top_k)
    if top_p < 1.0:
        s = apply_top_p(s, top_p)
    return s


def fused_sample_cuda(logits: torch.Tensor, u: torch.Tensor, *,
                      temperature: float, top_k: int, top_p: float,
                      planted_fault: Optional[str] = None) -> torch.Tensor:
    """Launch the fused sampling kernel: (b, V) logits + (b, V) fp32
    uniform noise → (b,) int32 tokens, each row over a cluster of CTAs
    (:func:`_sample_plan`). ``planted_fault`` (tests only) is one of
    :data:`PLANTED_FAULTS`. Counts its launches in ``.launches``."""
    b, V = logits.shape
    if logits.device.type != "cuda" or u.device != logits.device:
        raise ValueError("fused_sample_cuda takes CUDA tensors on one "
                         "device")
    if logits.dtype not in _DTYPE_CODES or u.dtype != torch.float32:
        raise ValueError(f"the sampling kernel takes float32 or bfloat16 "
                         f"logits and float32 noise; got {logits.dtype}, "
                         f"{u.dtype}")
    if V > KERNEL_MAX_VOCAB:
        raise ValueError(f"the sampling kernel holds a row of at most "
                         f"{KERNEL_MAX_VOCAB} logits in shared memory; got "
                         f"V={V}")
    if u.shape != logits.shape or not (logits.is_contiguous()
                                       and u.is_contiguous()):
        raise ValueError(f"logits and u must be contiguous (b, V); got "
                         f"{tuple(logits.shape)}, {tuple(u.shape)}")
    if not 0 <= top_k <= V:
        raise ValueError(f"top_k must be in [0, V={V}]; got {top_k}")
    if planted_fault not in (None, *PLANTED_FAULTS):
        raise ValueError(f"no planted fault {planted_fault!r}")
    if planted_fault == "top_k_plus_one":
        top_k = min(top_k + 1, V)
    plan = _plan_for(logits)
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    rc = _build.library().apex_fused_sample(
        logits.data_ptr(), u.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[logits.dtype], b, V, 1.0 / temperature, int(top_k),
        int(top_p < 1.0), float(top_p), plan.splits, plan.threads,
        plan.values, plan.share, int(planted_fault == "drop_last_rank"),
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(rc, "fused_sample")
    fused_sample_cuda.launches += 1
    return out


fused_sample_cuda.launches = 0


def fused_sample(logits: torch.Tensor, *, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None,
                 impl: str = "auto") -> torch.Tensor:
    """(b, V) logits → (b,) int32 tokens through one fused tail.

    ``temperature == 0`` is greedy argmax (``top_k``/``top_p`` are no-ops
    on an argmax). Otherwise: scale by ``1/temperature``, keep the
    ``top_k`` largest (0 = all), then the minimal top-``top_p``
    probability mass (1.0 = all), and draw by Gumbel-argmax on ``u`` —
    given, or drawn as ``torch.rand(..., generator=generator)`` with 0
    clamped away (u = 0 would pin a token's Gumbel at -inf)."""
    if logits.ndim != 2:
        raise ValueError(f"fused_sample takes (b, V) logits; got "
                         f"{tuple(logits.shape)}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b, V = logits.shape
    top_k = min(int(top_k), V)
    if u is None:
        u = uniform_noise((b, V), generator, logits.device)
    elif u.shape != (b, V) or u.dtype != torch.float32:
        raise ValueError(f"u must be float32 ({b}, {V}); got "
                         f"{u.dtype} {tuple(u.shape)}")
    if _backend.use_kernel(logits, impl):
        return fused_sample_cuda(logits.contiguous(), u.contiguous(),
                                 temperature=float(temperature),
                                 top_k=top_k, top_p=float(top_p))
    s = filtered_scaled(logits, temperature=float(temperature), top_k=top_k,
                        top_p=float(top_p))
    return gumbel_argmax(s, u)
