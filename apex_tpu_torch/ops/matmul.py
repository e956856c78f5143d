"""GEMM with the bias + activation epilogue fused: ``act(x @ w + b)``.

Port of ``apex_tpu/ops/pallas/matmul.py``: :func:`matmul_bias_act` with
the reference's layouts — x (M, K), w (K, N), b (N,) or None — an fp32
accumulator, and an epilogue that adds the bias in fp32, applies
``none``/``gelu`` (tanh approximation)/``relu``/``sigmoid``
(:func:`_apply_act`, the reference's ``:24-33``) and casts once to
``out_dtype`` (default: x's dtype).

Dispatch follows :mod:`apex_tpu_torch.ops._backend`: on a CUDA tensor
:func:`matmul_bias_act_cuda` launches the hand-written kernel of
``apex_tpu_torch/csrc/matmul_bias_act.cu`` that replaces the Pallas
``matmul_bias_act``; on a CPU tensor (or with ``impl="torch"``) the plain
version :func:`_torch_matmul_bias_act` runs. The reference's ``bm``,
``bn``, ``bk`` and ``interpret`` are TPU tiling knobs and are not taken:
passing them raises ``TypeError``. The kernel masks its own edges, so no
operand is padded.

The kernel reads both operands through their strides. x is read as A
(M, K) and w as B (K, N), each along whichever axis is contiguous, so the
fused-dense and MLP paths pass views: ``weight.t()`` (forward),
``weight`` (dgrad), ``dy.t()`` (wgrad). The bias and activation run in the
forward layout only (A and B both K-contiguous, as the call sites give
them); a call with either on other layouts copies its operands into that
layout first.

:func:`_plan` makes every launch decision, from the operands alone:

* the variant — ``"wgmma"`` (TMA loads into a ring of shared stages,
  ``wgmma`` on two consumer warpgroups) when a tensor map can describe
  both bf16 operands (base on 16 bytes, row stride a multiple of 8
  elements), else ``"sm80"`` (the ``mma.sync`` body, which takes any
  strides); fp32 operands take the exact-FFMA kernel (``"fp32"``);
* split-K for the wgmma variant, when the call's 128 x 128 output tiles
  would leave more than half the SMs idle and K is deep (the MLP's weight
  gradients): S slices of at least ``SPLIT_MIN_STEPS`` 64-deep K steps,
  at most one CTA per SM and ``SPLIT_MAX`` slices, an fp32 workspace
  (S, M, N), and a second launch that sums the partials in slice order
  (bit-identical run to run) and applies the epilogue.

No argument or environment variable picks either. The wrapper counts its
calls in ``matmul_bias_act_cuda.launches`` and by variant in
``.wgmma_launches``, ``.sm80_launches`` and ``.fp32_launches``; the
split-K calls also in ``.split_launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _backend, _build

ACTIVATIONS = ("none", "gelu", "relu", "sigmoid")
_ACT_CODES = {a: i for i, a in enumerate(ACTIVATIONS)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: why fp16 is refused: no model calls the kernel (ROADMAP queue 2)
FP16 = (" (an fp16 instance of matmul_bias_act: ROADMAP queue 2, item 6, "
        "with the path that needs it)")
#: 65535 row tiles of the fp32 kernel's 64 rows (the bf16 kernel's are 128)
MAX_ROWS = 65535 * 64
#: the wgmma variant's output tile and K step
TILE_M = TILE_N = 128
TILE_K = 64
#: split-K: the least 64-deep K steps a slice walks, and the most slices
SPLIT_MIN_STEPS = 8
SPLIT_MAX = 64
#: an H100 SXM's SMs (the plan's default; a launch asks its card)
H100_SMS = 132


def _apply_act(r: torch.Tensor, activation: str) -> torch.Tensor:
    """The reference's ``_apply_act`` on fp32 ``r``."""
    if activation == "none":
        return r
    if activation == "gelu":
        return torch.nn.functional.gelu(r, approximate="tanh")
    if activation == "relu":
        return torch.relu(r)
    if activation == "sigmoid":
        return torch.sigmoid(r)
    raise ValueError(f"unknown activation {activation!r}")


# --- the plain version --------------------------------------------------------

def _torch_matmul_bias_act(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None,
                           activation: str = "none",
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """The fp32 product of the operands, the fp32 epilogue, one cast."""
    r = x.float() @ w.float()
    if b is not None:
        r = r + b.float()
    return _apply_act(r, activation).to(out_dtype or x.dtype)


# --- the kernel ---------------------------------------------------------------

def _operand(t: torch.Tensor, k_axis: int, k_only: bool = False
             ) -> Tuple[torch.Tensor, bool, int, bool]:
    """How the kernel reads a 2-D operand: (tensor, K-contiguous, the
    stride of its other axis, 16-byte chunks allowed). An axis of extent
    1 may count as contiguous. A layout whose 16-byte chunks are aligned
    is preferred, then the K-contiguous one (the only one when
    ``k_only``); an operand with no such layout is copied."""
    cands = []
    for contig, along_k in ((k_axis, True), (1 - k_axis, False)):
        if along_k or not k_only:
            if t.stride(contig) == 1 or t.shape[contig] == 1:
                ld = t.stride(1 - contig)
                vec = (t.element_size() == 2 and t.data_ptr() % 16 == 0
                       and (ld % 8 == 0 or t.shape[1 - contig] == 1))
                cands.append((not vec, not along_k, ld))
    if not cands:
        t = t.contiguous() if k_axis == 1 else t.t().contiguous().t()
        return _operand(t, k_axis, k_only)
    no_vec, not_k, ld = min(cands)
    return t, not not_k, ld, not no_vec


def _check_kernel_inputs(x: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor],
                         out_dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError("matmul_bias_act_cuda takes CUDA tensors")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"the matmul_bias_act kernel takes float32 or "
                         f"bfloat16 operands of one dtype; got {x.dtype} "
                         f"and {w.dtype} — pass impl='torch' for the plain "
                         f"version" + (FP16 if torch.float16 in (
                             x.dtype, w.dtype) else ""))
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"the matmul_bias_act kernel writes float32 or "
                         f"bfloat16; got out_dtype {out_dtype} — pass "
                         f"impl='torch' for the plain version")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_bias_act: x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"matmul_bias_act: at most {MAX_ROWS} rows (the "
                         f"kernel's grid), got {x.shape[0]}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("matmul_bias_act: operands on different devices")
    if b is not None and (b.shape != (w.shape[1],)
                          or b.dtype not in _DTYPE_CODES):
        raise ValueError(f"matmul_bias_act: bias must be (N,) = "
                         f"({w.shape[1]},) float32 or bfloat16, got "
                         f"{tuple(b.shape)} {b.dtype}")


class Plan(NamedTuple):
    """One call's launch: the variant, its K slices (1: none) and the
    64-deep K steps of each, the fp32 workspace's shape (None without
    split-K), and the two operands as :func:`_operand` gives them."""
    variant: str
    split: int
    kt_split: int
    workspace: Optional[Tuple[int, int, int]]
    a: Tuple[torch.Tensor, bool, int, bool]
    b: Tuple[torch.Tensor, bool, int, bool]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """(S, K steps per slice): S > 1 when the output tiles fill at most
    half of the ``sms`` SMs and K holds two slices of SPLIT_MIN_STEPS; then
    as many slices as keep one CTA per SM, no slice empty."""
    tiles = _cdiv(M, TILE_M) * _cdiv(N, TILE_N)
    steps = _cdiv(K, TILE_K)
    s = min(sms // tiles, steps // SPLIT_MIN_STEPS, SPLIT_MAX)
    if tiles > sms // 2 or s < 2:
        return 1, steps
    per = _cdiv(steps, s)
    return _cdiv(steps, per), per


def _plan(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None, activation: str = "none",
          sms: int = H100_SMS) -> Plan:
    """Every launch decision for ``act(x @ w + b)``, from the operands'
    dtype, shapes, strides and alignment alone (see the module's doc)."""
    # the bf16 epilogues run in the forward layout only
    k_only = x.dtype == torch.bfloat16 and (b is not None
                                            or activation != "none")
    a, bm = _operand(x, 1, k_only), _operand(w, 0, k_only)
    if x.dtype == torch.float32:
        return Plan("fp32", 1, 0, None, a, bm)
    M, K = x.shape
    N = w.shape[1]
    if not (a[3] and bm[3]) or K == 0:  # an empty operand has no map
        return Plan("sm80", 1, 0, None, a, bm)
    split, per = _split(M, N, K, sms)
    return Plan("wgmma", split, per, (split, M, N) if split > 1 else None,
                a, bm)


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _forced(plan: Plan, variant: Optional[str], split: Optional[int],
            K: int, M: int, N: int) -> Plan:
    """``plan`` with the variant and split a caller asked for, checked."""
    if variant is not None and variant != plan.variant:
        if plan.variant == "fp32" or variant not in ("wgmma", "sm80"):
            raise ValueError(f"matmul_bias_act: no {variant!r} variant for "
                             f"these operands")
        if variant == "wgmma":
            raise ValueError("matmul_bias_act: no tensor map describes "
                             "these operands (a base off 16 bytes, a row "
                             "stride that is no multiple of 8 elements, or "
                             "K = 0)")
        plan = plan._replace(variant="sm80", split=1, kt_split=0,
                             workspace=None)
    if split is not None and split != plan.split:
        steps = _cdiv(K, TILE_K)
        per = _cdiv(steps, split) if split > 0 else 0
        if plan.variant != "wgmma" or per == 0 or _cdiv(steps, per) != split:
            raise ValueError(f"matmul_bias_act: cannot split K = {K} into "
                             f"{split} slices of the {plan.variant} variant")
        plan = plan._replace(split=split, kt_split=per, workspace=(
            (split, M, N) if split > 1 else None))
    return plan


def _launch(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None, activation: str = "none",
            out_dtype: Optional[torch.dtype] = None,
            variant: Optional[str] = None,
            split: Optional[int] = None) -> torch.Tensor:
    """The kernel launch behind :func:`matmul_bias_act_cuda`. ``variant``
    and ``split`` override the plan, for the kernel tests and the A/B
    timing of the variants only; both raise where the kernel cannot take
    them."""
    out_dtype = out_dtype or x.dtype
    _check_kernel_inputs(x, w, b, out_dtype)
    act = _ACT_CODES.get(activation)
    if act is None:
        raise ValueError(f"unknown activation {activation!r}")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    index = x.device.index
    plan = _plan(x, w, b, activation, _sm_count(
        torch.cuda.current_device() if index is None else index))
    plan = _forced(plan, variant, split, K, M, N)
    a, a_k, lda, a_vec = plan.a
    bm, b_k, ldb, b_vec = plan.b
    bias = None if b is None else b.contiguous()
    ws = (None if plan.workspace is None else
          torch.empty(plan.workspace, dtype=torch.float32, device=x.device))
    rc = _build.library().apex_matmul_bias_act(
        a.data_ptr(), bm.data_ptr(), None if bias is None else
        bias.data_ptr(), out.data_ptr(), None if ws is None else
        ws.data_ptr(), _DTYPE_CODES[x.dtype], int(plan.variant == "wgmma"),
        int(a_k), int(b_k), int(a_vec), int(b_vec), act,
        int(bias is not None and bias.dtype == torch.float32),
        int(out_dtype == torch.float32), M, N, K, lda, ldb, N, plan.split,
        plan.kt_split, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "matmul_bias_act")
    fn = matmul_bias_act_cuda
    fn.launches += 1
    counter = f"{plan.variant}_launches"
    setattr(fn, counter, getattr(fn, counter) + 1)
    fn.split_launches += int(plan.split > 1)
    return out


def matmul_bias_act_cuda(x: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor] = None,
                         activation: str = "none",
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Launch the kernel: ``act(x @ w + b)`` for x (M, K), w (K, N) read
    through their strides, into a new contiguous (M, N) tensor of
    ``out_dtype``, on the variant and split :func:`_plan` picks. Counts
    its calls in ``.launches``, by variant in ``.wgmma_launches``,
    ``.sm80_launches`` and ``.fp32_launches``, and the split-K ones in
    ``.split_launches``."""
    return _launch(x, w, b, activation, out_dtype)


matmul_bias_act_cuda.launches = 0
matmul_bias_act_cuda.wgmma_launches = 0
matmul_bias_act_cuda.sm80_launches = 0
matmul_bias_act_cuda.fp32_launches = 0
matmul_bias_act_cuda.split_launches = 0


def matmul_bias_act(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *,
                    activation: str = "none",
                    out_dtype: Optional[torch.dtype] = None,
                    impl: str = "auto") -> torch.Tensor:
    """``act(x @ w + b)``; x: (M, K), w: (K, N), b: (N,) or None."""
    if _backend.use_kernel(x, impl):
        return matmul_bias_act_cuda(x, w, b, activation, out_dtype)
    return _torch_matmul_bias_act(x, w, b, activation, out_dtype)
