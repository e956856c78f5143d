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
  only: separate seq-major q (b, sq, h, d) and k/v (b, sk, h_kv, d) with
  bottom-right causal alignment — the decode engine's prefill. A CUDA
  tensor launches :func:`flash_fwd_bshd_cuda` (the ``apex_flash_fwd_bshd``
  entry of ``csrc/flash_attn_fwd.cu``, replacing the Pallas
  ``flash_fwd_bshd``); a CPU tensor runs :func:`_torch_flash_fwd_bshd`.
  The reference's ``flash_auto_crossover`` is a TPU finding and is not
  ported: on CUDA the kernel always runs.

The ``kv_lens``, additive ``bias`` and dropout options of the reference's
flash kernels, the bh-flat layout and the bshd backward
(``flash_bwd_bshd``) are later slices of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _backend, _build

#: masked-score value (``apex_tpu/ops/pallas/attention.py:33``)
NEG_INF = -1e30

#: head dims the flash kernels are compiled for
KERNEL_HEAD_DIMS = (64, 128)
#: the longest sequence the kernels' grids cover (65535 tiles of 32 rows)
KERNEL_MAX_SEQ = 65535 * 32


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
    ``bshd_kernel_ok`` (``apex_tpu/ops/attention.py:394-403``): bf16, a head
    dim of 64 or 128, any sequence length up to :data:`KERNEL_MAX_SEQ`
    (the ragged last tile is masked in-kernel), any number of heads."""
    return (dtype == torch.bfloat16 and d in KERNEL_HEAD_DIMS
            and 1 <= s <= KERNEL_MAX_SEQ and h >= 1)


# --- plain version ------------------------------------------------------------

def masked_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                  causal: bool) -> torch.Tensor:
    """fp32 scaled scores over (..., seq, d) with the bottom-right-aligned
    causal mask (masked entries :data:`NEG_INF`)."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sk, device=s.device)[None, :]
                <= torch.arange(sq, device=s.device)[:, None] + (sk - sq))
        s = torch.where(mask, s, NEG_INF)
    return s


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, s, d) q/k/v → (o in q's dtype, fp32 lse); p is rounded to q's
    dtype before the PV product."""
    s = masked_scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("...qk,...kd->...qd", p.to(q.dtype).float(), v.float())
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


def _torch_flash_fwd(qkv, h, h_kv, d, scale, causal):
    b, s, _ = qkv.shape
    q, k, v = _split_packed(qkv, h, h_kv, d)
    o, lse = _xla_attention(q, k[:, :, None], v[:, :, None], scale, causal)
    return _merge_heads(o), lse.reshape(b, h, s)


def _torch_flash_fwd_bshd(q, k, v, scale, causal):
    """q (b, sq, h, d), k/v (b, sk, h_kv, d) → (o (b, sq, h, d), lse
    (b, h, sq)): the packed plain version's masked scores, bottom-right
    causal alignment ``off = sk − sq``."""
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    qg = q.reshape(b, sq, h_kv, h // h_kv, d).permute(0, 2, 3, 1, 4)
    kg = k.transpose(1, 2)[:, :, None]
    vg = v.transpose(1, 2)[:, :, None]
    o, lse = _xla_attention(qg, kg, vg, scale, causal)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d), lse.reshape(b, h,
                                                                      sq)


def _torch_flash_bwd(qkv, o, lse, do, h, h_kv, d, scale, causal):
    """The backward of :func:`_torch_flash_fwd` with the Pallas kernels'
    rounding points (``_bwd_single_block_kernel``, ``:568-589``):
    delta = rowsum(do·o) in fp32; dV from p rounded to do's dtype; dS =
    p·(dP − delta)·scale rounded to q's dtype before dQ and dK; every
    product accumulates in fp32 and the kv-group sum happens in fp32
    before the one cast."""
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
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bngqk,bngqd->bnkd", p.to(dt).float(), dof)
    dp = torch.einsum("bngqd,bnkd->bngqk", dof, v.float())
    ds = (p * (dp - delta) * scale).to(dt).float()
    del p, dp
    dq = torch.einsum("bngqk,bnkd->bngqd", ds, k.float())
    dk = torch.einsum("bngqk,bngqd->bnkd", ds, q.float())
    return (_merge_heads(dq.to(dt)), _merge_heads(dk.to(dt)),
            _merge_heads(dv.to(dt)))


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
            f"{name}: the flash kernels take bfloat16, head_dim in "
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
                   scale: float, causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash forward kernel on the packed buffer. Returns o
    (b, s, h·d) bf16 and lse (b, h, s) fp32. Counts its launches in
    ``.launches``."""
    _check_packed(qkv, h, h_kv, d, "flash_fwd_cuda")
    b, s, _ = qkv.shape
    out = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=qkv.device)
    rc = _build.library().apex_flash_fwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h, h_kv, d,
        int(causal), float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(rc, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def _check_bwd(qkv, o, lse, do, h, h_kv, d, name):
    _check_packed(qkv, h, h_kv, d, name)
    b, s, _ = qkv.shape
    _check_like("o", o, (b, s, h * d), qkv.dtype, qkv)
    _check_like("do", do, (b, s, h * d), qkv.dtype, qkv)
    _check_like("lse", lse, (b, h, s), torch.float32, qkv)
    return b, s


def flash_bwd_dkv_cuda(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                       do: torch.Tensor, h: int, h_kv: int, d: int, *,
                       scale: float, causal: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel: dk, dv (b, s, h_kv·d) bf16, each kv
    group's query heads summed in fp32. Counts launches in
    ``.launches``."""
    b, s = _check_bwd(qkv, o, lse, do, h, h_kv, d, "flash_bwd_dkv_cuda")
    dk = torch.empty((b, s, h_kv * d), dtype=qkv.dtype, device=qkv.device)
    dv = torch.empty_like(dk)
    rc = _build.library().apex_flash_bwd_dkv(
        qkv.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, h_kv, d, int(causal),
        float(scale), torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(rc, "flash_bwd_dkv")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_bwd_dq_cuda(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                      do: torch.Tensor, h: int, h_kv: int, d: int, *,
                      scale: float, causal: bool) -> torch.Tensor:
    """Launch the dQ kernel: dq (b, s, h·d) bf16. Counts launches in
    ``.launches``."""
    b, s = _check_bwd(qkv, o, lse, do, h, h_kv, d, "flash_bwd_dq_cuda")
    dq = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    rc = _build.library().apex_flash_bwd_dq(
        qkv.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), b, s, h, h_kv, d, int(causal), float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(rc, "flash_bwd_dq")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def _check_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> None:
    name = "flash_fwd_bshd_cuda"
    if any(t.device != q.device or t.device.type != "cuda"
           for t in (q, k, v)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    b, sq, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"{name}: q (b, sq, h, d) and k/v (b, sk, h_kv, d) with h_kv | h;"
            f" got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not packed_kernel_ok(sq, h, d, q.dtype) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"{name}: the flash kernels take bfloat16, head_dim in "
            f"{KERNEL_HEAD_DIMS} and 1 <= sq <= {KERNEL_MAX_SEQ}; got "
            f"{q.dtype}/{k.dtype}/{v.dtype}, d={d}, sq={sq}")
    if causal and sq > k.shape[1]:
        raise ValueError(f"{name}: causal attention requires sq <= sk; got "
                         f"sq={sq} > sk={k.shape[1]}")
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share their strides")
    for t in (q, k):
        if t.stride(3) != 1 or t.stride(2) != d or t.stride(1) % 8 \
                or t.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError(
                f"{name}: each (head, feature) row must be dense with "
                f"16-byte aligned rows (the kernel copies 16-byte chunks); "
                f"got strides {t.stride()}")


def flash_fwd_bshd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bshd flash forward: q (b, sq, h, d), k/v (b, sk, h_kv,
    d), bf16 — separate tensors or views into one buffer (the batch and
    row strides are passed through). Returns o (b, sq, h, d) bf16 and lse
    (b, h, sq) fp32. Counts its launches in ``.launches``."""
    _check_bshd(q, k, v, causal)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _build.library().apex_flash_fwd_bshd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q.stride(0), k.stride(0), q.stride(1), k.stride(1),
        b, sq, sk, h, h_kv, d, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_fwd_bshd")
    flash_fwd_bshd_cuda.launches += 1
    return out, lse


flash_fwd_bshd_cuda.launches = 0


# --- dispatch -----------------------------------------------------------------

def flash_fwd_packed(qkv: torch.Tensor, h: int, h_kv: int, d: int, *,
                     scale: float, causal: bool, impl: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward reading q/k/v out of the PACKED projection output
    ``qkv`` (b, s, (h+2·h_kv)·d). Returns (o (b, s, h·d), lse (b, h, s))."""
    if _backend.use_kernel(qkv, impl):
        return flash_fwd_cuda(qkv, h, h_kv, d, scale=scale, causal=causal)
    return _torch_flash_fwd(qkv, h, h_kv, d, scale, causal)


def flash_bwd_packed(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                     do: torch.Tensor, h: int, h_kv: int, d: int, *,
                     scale: float, causal: bool, impl: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`flash_fwd_packed`: SEPARATE dq (b, s, h·d) and
    dk/dv (b, s, h_kv·d) — the caller contracts each against its weight
    window."""
    if _backend.use_kernel(qkv, impl):
        dk, dv = flash_bwd_dkv_cuda(qkv, o, lse, do, h, h_kv, d,
                                    scale=scale, causal=causal)
        dq = flash_bwd_dq_cuda(qkv, o, lse, do, h, h_kv, d, scale=scale,
                               causal=causal)
        return dq, dk, dv
    return _torch_flash_bwd(qkv, o, lse, do, h, h_kv, d, scale, causal)


def flash_fwd_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool, impl: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seq-major flash forward: (o (b, sq, h, d), lse (b, h, sq))."""
    if _backend.use_kernel(q, impl):
        return flash_fwd_bshd_cuda(q, k, v, scale=scale, causal=causal)
    return _torch_flash_fwd_bshd(q, k, v, scale, causal)


class _FlashBshd(torch.autograd.Function):
    """The bshd forward; its backward (``flash_bwd_bshd``) is queued."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, impl):
        return flash_fwd_bshd(q, k, v, scale=scale, causal=causal,
                              impl=impl)[0]

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "the backward of flash_attention(layout='bshd') (the Pallas "
            "flash_bwd_bshd) is a later slice of the port; the bshd path "
            "is forward-only (the decode engine's prefill)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None, bias=None,
                    impl: str = "auto", layout: str = "bshd",
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Blockwise attention, forward only, in the seq-major layout (the
    default ``layout="bshd"``; the bh-flat ``"bhsd"`` is a later slice and
    raises ``NotImplementedError``): q (b, sq, h, d) and k/v (b, sk, h_kv, d)
    (h_kv | h: grouped-query heads read kv head ``t // (h // h_kv)``) and
    returns o (b, sq, h, d). ``causal`` aligns bottom-right (row r sees
    keys ``<= r + sk − sq``) and requires sq <= sk. ``scale`` defaults to
    1/sqrt(d). On a CUDA tensor the kernel runs (a shape it refuses —
    not bf16, d not in 64/128 — raises); on a CPU tensor, or with
    ``impl="torch"``, the plain version. Differentiating through it
    raises ``NotImplementedError``."""
    if layout != "bshd":
        if layout != "bhsd":
            raise ValueError(f"layout must be bhsd|bshd, got {layout!r}")
        raise NotImplementedError(
            "flash_attention's bh-flat layout (the Pallas flash_fwd / "
            "flash_bwd) is a later slice of the port; pass layout='bshd'")
    if kv_lens is not None or bias is not None or dropout_rate != 0.0 \
            or dropout_seed is not None:
        raise NotImplementedError(
            "flash_attention's kv_lens, bias (and the bucketed rel_bias) "
            "and dropout options are later slices of the port")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"layout='bshd' takes (b, s, h, d) operands; got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"causal attention requires sq <= sk; got "
                         f"sq={q.shape[1]} > sk={k.shape[1]}")
    if q.shape[2] % k.shape[2] or k.shape[:2] != v.shape[:2]:
        raise ValueError(f"kv heads ({k.shape[2]}) must divide q heads "
                         f"({q.shape[2]}) with matching batch/seq dims")
    d = q.shape[-1]
    s_scale = float(scale if scale is not None else 1.0 / d ** 0.5)
    return _FlashBshd.apply(q, k, v, s_scale, bool(causal), impl)


# --- the fused projection + attention block -----------------------------------

class _FusedQKVAttention(torch.autograd.Function):
    """Forward ``_fused_attn_fwd`` (``:581-609``), backward
    ``_fused_attn_bwd`` (``:612-641``); saves what the reference saves:
    x, the packed qkv, o, lse and the two weights."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_out, h, h_kv, d, scale, causal,
                impl):
        qkv = F.linear(x, w_qkv, b_qkv)
        o, lse = flash_fwd_packed(qkv, h, h_kv, d, scale=scale,
                                  causal=causal, impl=impl)
        y = F.linear(o, w_out)
        ctx.save_for_backward(x, qkv, o, lse, w_qkv, w_out)
        ctx.attn = (h, h_kv, d, scale, causal, impl, b_qkv is not None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, qkv, o, lse, w_qkv, w_out = ctx.saved_tensors
        h, h_kv, d, scale, causal, impl, has_bias = ctx.attn
        b, s, H = x.shape
        T = b * s
        dy2 = dy.reshape(T, -1)
        dw_out = dy2.t() @ o.reshape(T, h * d)
        do = (dy2 @ w_out).reshape(b, s, h * d)
        dq, dk, dv = flash_bwd_packed(qkv, o, lse, do, h, h_kv, d,
                                      scale=scale, causal=causal, impl=impl)
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
                None, None, None, None, None, None)


def fused_qkv_attention(x: torch.Tensor, w_qkv: torch.Tensor,
                        b_qkv: Optional[torch.Tensor], w_out: torch.Tensor,
                        h: int, h_kv: int, d: int, scale: float,
                        causal: bool = True, *,
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
    GEMMs, dW_qkv concatenates three, db_qkv three column sums."""
    if x.ndim != 3 or w_qkv.shape != ((h + 2 * h_kv) * d, x.shape[-1]) \
            or w_out.shape[-1] != h * d:
        raise ValueError(
            f"fused_qkv_attention: x (b, s, H), w_qkv ((h + 2*h_kv)*d, H) and "
            f"w_out (O, h*d); got x {tuple(x.shape)}, w_qkv "
            f"{tuple(w_qkv.shape)}, w_out {tuple(w_out.shape)} for h={h}, "
            f"h_kv={h_kv}, d={d}")
    return _FusedQKVAttention.apply(x, w_qkv, b_qkv, w_out, h, h_kv, d,
                                    float(scale), bool(causal), impl)
