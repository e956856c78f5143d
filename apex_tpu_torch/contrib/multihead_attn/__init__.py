"""Multi-head attention modules on the flash kernels.

Port of ``apex_tpu/contrib/multihead_attn/__init__.py``
(``apex.contrib.multihead_attn``: ``self_multihead_attn.py``,
``encdec_multihead_attn.py``): self and encoder-decoder attention with an
optional fused pre-LayerNorm and residual add (``include_norm_add``),
optional biases, additive attention masks and key-padding masks, as
``nn.Module``s with the reference's parameter names. One call into the
flash family carries the whole option matrix (:func:`_attention`):

* probs dropout in the kernels (the counter-hash mask of ``key``: a
  ``torch.Generator`` or an int32 seed), the normaliser un-dropped;
* ``attn_mask`` (sq, sk) or (hb, sq, sk), additive: the bshd kernels'
  array bias, head t reading mask row t % hb;
* ``key_padding_mask`` (b, sk), nonzero = exclude: a (b, sq, sk) fp32
  bias of −1e9, with the operands flattened HEAD-major — the (h, b, s, d)
  views of the (b, s, h, d) projections — so q-head row t = h_i·b + b_i
  reads bias row t % b = b_i: the bh-flat kernels' array bias, whose
  dropout hashes that row t (the bshd route hashes t = b_i·h + h_i, so
  the two padding spellings draw different masks under dropout, as in the
  reference);
* ``pad_lens`` (b,) valid key lengths: the bshd kernels' per-batch
  ``kv_lens`` (a suffix pad; composes with ``attn_mask`` and causal).

``include_norm_add`` runs the port's ``fused_layer_norm`` (the LayerNorm
kernels on the card). The projections are ``F.linear`` (cuBLAS), as the
reference leaves its dots to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.attention import flash_attention, key_seed
from apex_tpu_torch.ops.fused_dense import uniform_weight
from apex_tpu_torch.ops.layer_norm import fused_layer_norm

Key = Optional[Union[torch.Generator, int, torch.Tensor]]

#: the additive value of an excluded key (``:31-35``): finite, so a row
#: whose keys are all padded gives a uniform softmax, not NaN
_MASKED = -1e9


def _norm_attn_mask(attn_mask: torch.Tensor, h: int, sq: int,
                    sk: int) -> torch.Tensor:
    """An additive ``attn_mask`` as the kernels' (hb, sq, sk) bias: (sq,
    sk) shared by every head, or (hb, sq, sk) with hb | h (``:43-54``)."""
    if attn_mask.ndim == 2:
        attn_mask = attn_mask[None]
    if attn_mask.ndim != 3 or tuple(attn_mask.shape[1:]) != (sq, sk) \
            or h % attn_mask.shape[0]:
        raise ValueError(
            f"attn_mask must be (sq, sk) or (hb, sq, sk) with hb | heads; "
            f"got {tuple(attn_mask.shape)} for h={h}, sq={sq}, sk={sk}")
    return attn_mask


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, rate: float, key: Key,
               attn_mask: Optional[torch.Tensor] = None,
               key_padding_mask: Optional[torch.Tensor] = None,
               pad_lens: Optional[torch.Tensor] = None,
               impl: str = "auto") -> torch.Tensor:
    """The attention core over (b, s, h, d) operands (``_attention``,
    ``:57-127``): one flash call for the option matrix. Refuses, as the
    reference: dropout without a key, both padding spellings,
    ``attn_mask`` with ``key_padding_mask``, and masks of the wrong
    shape."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    rate = float(rate)
    if rate > 0 and key is None:
        raise ValueError(
            "dropout > 0 with is_training=True needs a key (a "
            "torch.Generator or an int32 seed; or is_training=False)")
    seed = key_seed(key) if rate > 0 else None
    if attn_mask is not None:
        attn_mask = _norm_attn_mask(attn_mask, h, sq, sk)
    if key_padding_mask is not None:
        if pad_lens is not None:
            raise ValueError(
                "key_padding_mask and pad_lens are two spellings of key "
                "padding: pass one (pad_lens is the fast path)")
        if attn_mask is not None:
            raise ValueError(
                "attn_mask and key_padding_mask are mutually exclusive "
                "(use pad_lens for padding composed with attn_mask)")
        if tuple(key_padding_mask.shape) != (b, sk):
            raise ValueError(
                f"key_padding_mask must be (batch, src_len) = ({b}, {sk}); "
                f"got {tuple(key_padding_mask.shape)}")
        bias = torch.where(key_padding_mask.bool()[:, None, :], _MASKED,
                           0.0).to(torch.float32).expand(b, sq, sk)
        # head-major rows t = h_i·b + b_i: bias row t % b = b_i
        o = flash_attention(q.permute(2, 0, 1, 3), k.permute(2, 0, 1, 3),
                            v.permute(2, 0, 1, 3), causal=causal, bias=bias,
                            dropout_rate=rate, dropout_seed=seed, impl=impl)
        return o.permute(1, 2, 0, 3)
    if pad_lens is not None:
        pad_lens = torch.as_tensor(pad_lens, device=q.device).to(torch.int32)
        if tuple(pad_lens.shape) != (b,):
            raise ValueError(f"pad_lens must be per-batch ({b},); got "
                             f"{tuple(pad_lens.shape)}")
    return flash_attention(q, k, v, causal=causal, layout="bshd",
                           kv_lens=pad_lens, bias=attn_mask,
                           dropout_rate=rate, dropout_seed=seed, impl=impl)


class _MHA(nn.Module):
    """What both modules share: the reference's ``init`` — each projection
    ``<name>_weight`` (rows, e) drawn from U(-1/√e, 1/√e) in the order
    given, with ``bias`` its ``<name>_bias`` zeros, with
    ``include_norm_add`` ``ln_weight`` ones and ``ln_bias`` zeros — on
    ``device`` (default: the card), and the pre-norm, the output
    projection and the residual."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float,
                 bias: bool, include_norm_add: bool, impl: str,
                 projections, generator: Optional[torch.Generator],
                 device: Optional[Union[str, torch.device]],
                 dtype: torch.dtype):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim ({embed_dim}) must be a multiple "
                             f"of num_heads ({num_heads})")
        e = embed_dim
        self.embed_dim, self.num_heads = e, num_heads
        self.head_dim = e // num_heads
        self.dropout = dropout
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.impl = impl
        #: the projections' names, in the reference's parameter order
        self.projections = tuple(name for name, _ in projections)
        dev = _backend.resolve_device(device)
        for name, rows in projections:
            setattr(self, f"{name}_weight", nn.Parameter(uniform_weight(
                (rows, e), 1.0 / math.sqrt(e), generator, dev, dtype)))
        for name, rows in projections if bias else ():
            setattr(self, f"{name}_bias", nn.Parameter(
                torch.zeros(rows, dtype=dtype, device=dev)))
        if include_norm_add:
            self.ln_weight = nn.Parameter(torch.ones(e, dtype=dtype,
                                                     device=dev))
            self.ln_bias = nn.Parameter(torch.zeros(e, dtype=dtype,
                                                    device=dev))

    def _proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, getattr(self, f"{name}_weight"),
                        getattr(self, f"{name}_bias") if self.bias else None)

    def _pre(self, x: torch.Tensor) -> torch.Tensor:
        if not self.include_norm_add:
            return x
        return fused_layer_norm(x, self.ln_weight, self.ln_bias,
                                impl=self.impl)

    def _post(self, o: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        b, s = o.shape[:2]
        o = self._proj("out", o.reshape(b, s, self.embed_dim))
        return o + residual if self.include_norm_add else o

    def _rate(self, is_training: Optional[bool]) -> float:
        train = self.training if is_training is None else is_training
        return float(self.dropout) if train else 0.0

    def extra_repr(self) -> str:
        return (f"embed_dim={self.embed_dim}, num_heads={self.num_heads}, "
                f"dropout={self.dropout}, bias={self.bias}, "
                f"include_norm_add={self.include_norm_add}")


class SelfMultiheadAttn(_MHA):
    """``SelfMultiheadAttn`` (``:130-229``): the packed ``qkv_weight``
    (3e, e) — or ``q_weight``, ``k_weight``, ``v_weight`` with
    ``separate_qkv_params`` — then attention and ``out_weight``; with
    ``bias`` the biases of the same names, with ``include_norm_add``
    ``ln_weight``/``ln_bias`` and the residual. Parameters on ``device``
    (default: the card), drawn from ``generator``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 separate_qkv_params: bool = False, impl: str = "auto", *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        e = embed_dim
        qkv = ([("q", e), ("k", e), ("v", e)] if separate_qkv_params
               else [("qkv", 3 * e)])
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, qkv + [("out", e)],
                         generator, device, dtype)
        self.separate_qkv_params = separate_qkv_params

    def forward(self, x: torch.Tensor, *, causal: bool = False,
                attn_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                pad_lens: Optional[torch.Tensor] = None, key: Key = None,
                is_training: Optional[bool] = None) -> torch.Tensor:
        """x (batch, seq, embed) → the attention output (+ x with
        ``include_norm_add``). Dropout when ``is_training`` (default: the
        module's ``training``) and ``dropout`` > 0, from ``key``."""
        residual = x
        x = self._pre(x)
        b, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        if self.separate_qkv_params:
            q, k, v = (self._proj(n, x) for n in "qkv")
        else:
            q, k, v = self._proj("qkv", x).split(self.embed_dim, dim=-1)
        o = _attention(q.reshape(b, s, h, d), k.reshape(b, s, h, d),
                       v.reshape(b, s, h, d), causal=causal,
                       rate=self._rate(is_training), key=key,
                       attn_mask=attn_mask,
                       key_padding_mask=key_padding_mask, pad_lens=pad_lens,
                       impl=self.impl)
        return self._post(o, residual)


class EncdecMultiheadAttn(_MHA):
    """``EncdecMultiheadAttn`` (``:232-281``): Q from the decoder stream
    through ``q_weight``, K and V from the encoder memory through
    ``kv_weight`` (2e, e), then ``out_weight``; biases and the norm as
    :class:`SelfMultiheadAttn`'s."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "auto", *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        e = embed_dim
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl,
                         [("q", e), ("kv", 2 * e), ("out", e)], generator,
                         device, dtype)

    def forward(self, query: torch.Tensor, memory: torch.Tensor, *,
                attn_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                pad_lens: Optional[torch.Tensor] = None, key: Key = None,
                is_training: Optional[bool] = None) -> torch.Tensor:
        """query (batch, sq, embed), memory (batch, sk, embed): the
        encoder's keys; ``key_padding_mask`` (batch, sk) excludes padded
        encoder keys, ``pad_lens`` (batch,) is its suffix form."""
        residual = query
        query = self._pre(query)
        b, sq, _ = query.shape
        sk = memory.shape[1]
        h, d = self.num_heads, self.head_dim
        q = self._proj("q", query)
        k, v = self._proj("kv", memory).split(self.embed_dim, dim=-1)
        o = _attention(q.reshape(b, sq, h, d), k.reshape(b, sk, h, d),
                       v.reshape(b, sk, h, d), causal=False,
                       rate=self._rate(is_training), key=key,
                       attn_mask=attn_mask,
                       key_padding_mask=key_padding_mask, pad_lens=pad_lens,
                       impl=self.impl)
        return self._post(o, residual)
