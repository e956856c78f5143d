"""Fused sampling tail: logits → temperature/top-k/top-p → token.

Port of ``apex_tpu/ops/sampling.py::fused_sample`` and the helpers of
``apex_tpu/ops/pallas/sampling.py`` (``:61-137``). The helpers below are the
plain PyTorch version: thresholds by 48-step bisection (no sort) and a
Gumbel-argmax draw. Dispatch follows :mod:`apex_tpu_torch.ops._backend`: a
CUDA tensor launches :func:`fused_sample_cuda` (the hand-written kernel
``apex_tpu_torch/csrc/fused_sample.cu``, replacing the Pallas
``fused_sample_fwd``), a CPU tensor runs the helpers.

The uniform noise is an operand (``u``) or is drawn here from an explicit
``torch.Generator``. torch cannot reproduce JAX's threefry bits, so parity
with the reference is tested on shared noise.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _backend, _build

#: masked-out logit value (``apex_tpu/ops/pallas/sampling.py:53``)
FILTERED = -1e30

#: bisection steps to a one-ulp threshold (``:58``)
BISECT_ITERS = 48

#: the widest row the kernel holds in shared memory (fp32, 192 KB)
KERNEL_MAX_VOCAB = 49152
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
                      temperature: float, top_k: int,
                      top_p: float) -> torch.Tensor:
    """Launch the fused sampling kernel: (b, V) logits + (b, V) fp32
    uniform noise → (b,) int32 tokens, one CTA per row. Counts its
    launches in ``.launches``."""
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
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    lib = _build.library()
    rc = lib.apex_fused_sample(
        logits.data_ptr(), u.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[logits.dtype], b, V, 1.0 / temperature, int(top_k),
        int(top_p < 1.0), float(top_p),
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
