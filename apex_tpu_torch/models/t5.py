"""T5-class encoder-decoder: the training forward, at tp=1.

Port of ``apex_tpu/models/t5.py``: the config, the parameter
initialisation (``EncoderDecoderModel.init``, ``:188-251``, same
distributions), the pre-LN encoder block (bidirectional self-attention +
MLP, ``:324-333``), the pre-LN decoder block (causal self-attention →
cross-attention over the encoder output → MLP, ``:335-353``),
:meth:`EncoderDecoderModel.encode` / ``decode`` (``:396-424``), the tied
unembedding (``:426-435``) and :meth:`EncoderDecoderModel.loss_fn`
(``:437-446``).

``attention_impl="softmax"`` (the reference's default, ``:292-320``):
materialised scores on the (b, h, s, d) views. Without a bias they go
through the fused scaled-masked softmax with the mask ``~tril | pad``
(decoder self-attention) or the encoder pad mask alone (encoder
self-attention, cross-attention; none without padding); with the
relative bias — materialised (1, h, sq, sk) fp32 whatever
``relative_bias_impl`` says, as in the reference — the scaled scores
plus the bias, the -1e30 masks and an fp32 softmax cast to v's dtype
(the reference's ``jax.nn.softmax``: no kernel).

``attention_impl="flash"``: ``flash_attention`` in its bh-flat layout on
the (b, h, s, d) views of the projection output — on a CUDA tensor the
hand-written kernels, with the encoder pad lengths as ``kv_lens``
(encoder self-attention and cross-attention) and, under ``position_encoding="relative"``, the
per-stack bucket tables as the self-attention's bias (encoder
bidirectional, decoder causal; cross-attention carries none): with
``relative_bias_impl="bucketed"`` (the default) a :class:`BucketedBias`
that the kernels expand per tile, with ``"materialized"`` (the
reference's oracle of the bucketed path, ``t5.py:75-79``) the (h, sq, sk)
fp32 array built by :func:`relative_bias`, whose gradient comes from the
dbias kernel and flows through the gather into the table. The bias enters
the SCALED scores: this model keeps the 1/sqrt(d) scale that T5 itself
omits (``:300-303``). ``remat=True`` recomputes in the backward
(``torch.utils.checkpoint``, non-reentrant) by ``remat_policy``
(``:54-60``): ``"blocks"`` each block (the reference's per-block
``jax.checkpoint``), ``"encode_only"`` the whole encoder as ONE
checkpoint (``:429``: only enc_out stays live through the decoder, which
runs un-rematted). The loss goes through the ported vocab-parallel
cross-entropy (the ``xent_stats`` kernel) and ``masked_mean``.

Parameters are a plain dict in the reference's tree layout, except that
``encoder`` and ``decoder`` are lists of per-layer dicts instead of
stacked leaves (:func:`apex_tpu_torch.models.convert.t5_params_from_jax`
converts both ways). The reference's knobs with one working value here —
``tp_overlap``, ``plan`` — are not config fields yet, and the pipeline
``EncDecPipeline`` is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.models.gpt import param_leaves  # noqa: F401
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.attention import BucketedBias, flash_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.softmax import scaled_masked_softmax
from apex_tpu_torch.transformer.tensor_parallel import (
    masked_mean, vocab_parallel_cross_entropy)

Params = Dict[str, object]

ENC_LAYER = ("ln1_w", "ln1_b", "qkv", "attn_out", "ln2_w", "ln2_b",
             "mlp_up", "mlp_down")
DEC_LAYER = ("ln1_w", "ln1_b", "qkv", "attn_out", "ln_x_w", "ln_x_b", "xq",
             "xkv", "x_out", "ln2_w", "ln2_b", "mlp_up", "mlp_down")


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    max_seq_len: int = 512
    hidden_size: int = 512
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    dtype: torch.dtype = torch.float32  # parameter dtype
    attention_impl: str = "softmax"  # softmax | flash
    remat: bool = True  # recompute in the backward, by remat_policy
    # "blocks": each block; "encode_only": the whole encoder as one
    # checkpoint, the decoder not rematted
    remat_policy: str = "blocks"
    # "learned": absolute learned positions; "relative": T5's per-stack
    # (num_buckets, heads) bias tables on the self-attention scores
    position_encoding: str = "learned"
    relative_num_buckets: int = 32
    relative_max_distance: int = 128
    # flash only — "bucketed": the kernels expand the table per score
    # tile; "materialized": the (h, sq, sk) array through the array-bias
    # option and the dbias kernel — the reference's oracle of the bucketed
    # path. The softmax route always adds the materialised array.
    relative_bias_impl: str = "bucketed"

    def __post_init__(self):
        if self.attention_impl not in ("softmax", "flash"):
            raise ValueError(
                f"attention_impl must be softmax|flash, got "
                f"{self.attention_impl!r}")
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be divisible by "
                f"num_heads ({self.num_heads})")
        if self.remat_policy not in ("blocks", "encode_only"):
            raise ValueError(
                f"remat_policy must be blocks|encode_only, got "
                f"{self.remat_policy!r}")
        if self.position_encoding not in ("learned", "relative"):
            raise ValueError(
                f"position_encoding must be learned|relative, got "
                f"{self.position_encoding!r}")
        if self.relative_bias_impl not in ("bucketed", "materialized"):
            raise ValueError(
                f"relative_bias_impl must be bucketed|materialized, got "
                f"{self.relative_bias_impl!r}")

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def relative_bias(table: torch.Tensor, sq: int, sk: int, *,
                  bidirectional: bool, num_buckets: int,
                  max_distance: int) -> torch.Tensor:
    """(1, heads, sq, sk) additive bias materialised from a (num_buckets,
    heads) table (``t5.py:165-180``): the plain form of what the kernels
    compute per tile."""
    if table.shape[0] != num_buckets:
        raise ValueError(f"table has {table.shape[0]} buckets, expected "
                         f"{num_buckets}")
    return BucketedBias(table, bidirectional,
                        max_distance).materialize(sq, sk)[None]


class EncoderDecoderModel:
    """Functional T5-class model: ``init(generator)`` → params;
    ``loss_fn(params, enc_tokens, dec_tokens, targets)`` → mean CE of the
    decoder output (teacher forcing: ``dec_tokens`` is the shifted-right
    target stream)."""

    def __init__(self, config: T5Config):
        self.config = config

    # --- params ---------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: Optional[Union[str, torch.device]] = None) -> Params:
        """Random parameters with the reference's distributions: LN weights
        1 and biases 0, linear weights N(0, 1/fan_in), the embedding
        N(0, 1), bias tables N(0, 0.1²), positions N(0, 0.01²). Drawn in
        fp32 from ``generator`` (which must live on ``device``), then cast
        to the config's dtype."""
        c = self.config
        dev = _backend.resolve_device(device)
        H, Fh = c.hidden_size, c.ffn

        def normal(shape, std):
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            return (t.normal_(0.0, 1.0, generator=generator) * std).to(
                c.dtype)

        def dense(out, inp):
            return normal((out, inp), (1.0 / inp) ** 0.5)

        def ones():
            return torch.ones((H,), dtype=c.dtype, device=dev)

        def zeros():
            return torch.zeros((H,), dtype=c.dtype, device=dev)

        def enc_layer():
            return {"ln1_w": ones(), "ln1_b": zeros(),
                    "qkv": dense(3 * H, H), "attn_out": dense(H, H),
                    "ln2_w": ones(), "ln2_b": zeros(),
                    "mlp_up": dense(Fh, H), "mlp_down": dense(H, Fh)}

        def dec_layer():
            return {"ln1_w": ones(), "ln1_b": zeros(),
                    "qkv": dense(3 * H, H), "attn_out": dense(H, H),
                    "ln_x_w": ones(), "ln_x_b": zeros(),
                    "xq": dense(H, H), "xkv": dense(2 * H, H),
                    "x_out": dense(H, H),
                    "ln2_w": ones(), "ln2_b": zeros(),
                    "mlp_up": dense(Fh, H), "mlp_down": dense(H, Fh)}

        params = {
            "embedding": normal((c.vocab_size, H), 1.0),
            "encoder": [enc_layer() for _ in range(c.num_encoder_layers)],
            "decoder": [dec_layer() for _ in range(c.num_decoder_layers)],
            "ln_enc_w": ones(), "ln_enc_b": zeros(),
            "ln_dec_w": ones(), "ln_dec_b": zeros(),
        }
        if c.position_encoding == "relative":
            nb = c.relative_num_buckets
            params["rel_bias_enc"] = normal((nb, c.num_heads), 0.1)
            params["rel_bias_dec"] = normal((nb, c.num_heads), 0.1)
        else:
            params["pos_embedding"] = normal((c.max_seq_len, H), 0.01)
        return params

    # --- attention pieces -----------------------------------------------------

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(b, s, H) → the (b, h, s, d) view: no copy."""
        b, s, _ = x.shape
        c = self.config
        return x.view(b, s, c.num_heads, c.head_dim).transpose(1, 2)

    @staticmethod
    def _merge(x: torch.Tensor) -> torch.Tensor:
        """(b, h, s, d) → (b, s, h·d); a view of the attention's output,
        whose storage is (b, s, h, d)."""
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def _attn(self, q, k, v, causal, bias=None, kv_lens=None,
              impl: str = "auto"):
        """Attention on (b, h, s, d) views; ``kv_lens`` (b,) per-batch
        valid KEY lengths (heads share a row's padding). The flash route
        expands them over the heads, and hands a materialised bias
        (1, h, sq, sk) to the kernels as its (h, sq, sk) per-head form:
        row r of the b·h flatten reads bias row r % h, its head."""
        if self.config.attention_impl == "softmax":
            return self._softmax_attn(q, k, v, causal, bias, kv_lens, impl)
        lens = None
        if kv_lens is not None:
            lens = kv_lens.to(torch.int32)[:, None].expand(q.shape[:2])
        if torch.is_tensor(bias):
            bias = bias[0]
        return flash_attention(q, k, v, causal=causal, kv_lens=lens,
                               bias=bias, layout="bhsd", impl=impl)

    def _softmax_attn(self, q, k, v, causal, bias, kv_lens, impl):
        """The softmax route (``t5.py:292-320``)."""
        d = q.shape[-1]
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
        sq, sk = scores.shape[-2], scores.shape[-1]
        pad = None
        if kv_lens is not None:  # True = masked (key position >= length)
            pad = (torch.arange(sk, device=q.device)[None, :]
                   >= kv_lens[:, None])[:, None, None, :]
        if bias is not None:
            # the relative bias enters the SCALED scores, in fp32
            s = scores.float() / float(d) ** 0.5 + bias
            if causal:
                keep = torch.ones((sq, sk), dtype=torch.bool,
                                  device=q.device).tril()
                s = torch.where(keep, s, -1e30)
            if pad is not None:
                s = torch.where(pad, -1e30, s)
            probs = torch.softmax(s, dim=-1).to(v.dtype)
            return torch.einsum("bhqk,bhkd->bhqd", probs, v)
        mask = pad
        if causal:
            mask = ~torch.ones((sq, sk), dtype=torch.bool,
                               device=q.device).tril()[None, None]
            if pad is not None:
                mask = mask | pad
        probs = scaled_masked_softmax(scores, mask, 1.0 / float(d) ** 0.5,
                                      impl=impl)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)

    # --- blocks ---------------------------------------------------------------

    def _mlp(self, p, x, impl):
        h = fused_layer_norm(x, p["ln2_w"], p["ln2_b"], impl=impl)
        return x + F.linear(F.gelu(F.linear(h, p["mlp_up"]),
                                   approximate="tanh"), p["mlp_down"])

    def _self_attention(self, p, x, causal, bias, kv_lens, impl):
        H = self.config.hidden_size
        h = fused_layer_norm(x, p["ln1_w"], p["ln1_b"], impl=impl)
        q, k, v = F.linear(h, p["qkv"]).split(H, dim=-1)
        a = self._merge(self._attn(self._heads(q), self._heads(k),
                                   self._heads(v), causal, bias, kv_lens,
                                   impl))
        return x + F.linear(a, p["attn_out"])

    def encoder_block(self, p, x, bias=None, pad_lens=None,
                      impl: str = "auto"):
        x = self._self_attention(p, x, False, bias, pad_lens, impl)
        return self._mlp(p, x, impl)

    def decoder_block(self, p, x, enc_out, bias=None, enc_pad_lens=None,
                      impl: str = "auto"):
        H = self.config.hidden_size
        x = self._self_attention(p, x, True, bias, None, impl)
        h = fused_layer_norm(x, p["ln_x_w"], p["ln_x_b"], impl=impl)
        q = F.linear(h, p["xq"])
        ck, cv = F.linear(enc_out, p["xkv"]).split(H, dim=-1)
        # cross-attention masks the encoder's padded positions as keys
        a = self._merge(self._attn(self._heads(q), self._heads(ck),
                                   self._heads(cv), False, None,
                                   enc_pad_lens, impl))
        x = x + F.linear(a, p["x_out"])
        return self._mlp(p, x, impl)

    def _wrapped(self, fn):
        """The block under the config's ``remat``: recomputed whole in the
        backward (the reference's per-block ``jax.checkpoint``) under
        ``remat_policy="blocks"`` (``t5.py:357``)."""
        c = self.config
        if not (c.remat and c.remat_policy == "blocks"):
            return fn

        def block(*args):
            return checkpoint(fn, *args, use_reentrant=False)

        return block

    def _stack_bias(self, params, name, sq, sk, bidirectional):
        c = self.config
        if c.position_encoding != "relative":
            return None
        if c.attention_impl == "flash" and c.relative_bias_impl == "bucketed":
            return BucketedBias(params[name], bidirectional=bidirectional,
                                max_distance=c.relative_max_distance)
        return relative_bias(params[name].float(), sq, sk,
                             bidirectional=bidirectional,
                             num_buckets=c.relative_num_buckets,
                             max_distance=c.relative_max_distance)

    def enc_bias(self, params, sq: int, sk: int
                 ) -> Optional[Union[BucketedBias, torch.Tensor]]:
        """The encoder self-attention's bias (bidirectional buckets): a
        :class:`BucketedBias` (the flash route's bucketed mode), the
        materialised (1, h, sq, sk) fp32 array, or None under learned
        positions."""
        return self._stack_bias(params, "rel_bias_enc", sq, sk, True)

    def dec_bias(self, params, sq: int, sk: int
                 ) -> Optional[Union[BucketedBias, torch.Tensor]]:
        return self._stack_bias(params, "rel_bias_dec", sq, sk, False)

    # --- forward --------------------------------------------------------------

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, params["embedding"])
        if self.config.position_encoding == "relative":
            return x  # positions live in the attention bias
        s = tokens.shape[1]
        if s > self.config.max_seq_len:
            raise ValueError(f"sequence {s} exceeds max_seq_len "
                             f"{self.config.max_seq_len}")
        return x + params["pos_embedding"][:s]

    def encode(self, params, enc_tokens, enc_pad_lens=None, *,
               impl: str = "auto"):
        """``enc_pad_lens`` (b,) int: per-batch valid encoder lengths
        (suffix padding); self-attention masks the padded KEYS through the
        kernels' ``kv_lens`` (padded query rows still compute, and nothing
        downstream reads them)."""
        x = self.embed(params, enc_tokens)
        s = enc_tokens.shape[1]
        bias = self.enc_bias(params, s, s)
        block = self._wrapped(self.encoder_block)
        for layer in params["encoder"]:
            x = block(layer, x, bias, enc_pad_lens, impl)
        return fused_layer_norm(x, params["ln_enc_w"], params["ln_enc_b"],
                                impl=impl)

    def decode(self, params, dec_tokens, enc_out, enc_pad_lens=None, *,
               impl: str = "auto"):
        x = self.embed(params, dec_tokens)
        s = dec_tokens.shape[1]
        bias = self.dec_bias(params, s, s)
        block = self._wrapped(self.decoder_block)
        for layer in params["decoder"]:
            x = block(layer, x, enc_out, bias, enc_pad_lens, impl)
        return fused_layer_norm(x, params["ln_dec_w"], params["ln_dec_b"],
                                impl=impl)

    def logits(self, params, enc_tokens, dec_tokens, enc_pad_lens=None, *,
               impl: str = "auto"):
        c = self.config
        if c.remat and c.remat_policy == "encode_only":
            # re-encode in the backward (t5.py:425-431): only enc_out stays
            # live through the decoder
            enc_out = checkpoint(
                lambda p, e, lens: self.encode(p, e, lens, impl=impl),
                params, enc_tokens, enc_pad_lens, use_reentrant=False)
        else:
            enc_out = self.encode(params, enc_tokens, enc_pad_lens,
                                  impl=impl)
        x = self.decode(params, dec_tokens, enc_out, enc_pad_lens, impl=impl)
        return F.linear(x, params["embedding"])  # tied unembedding

    def loss_fn(self, params: Params, enc_tokens: torch.Tensor,
                dec_tokens: torch.Tensor, targets: torch.Tensor,
                loss_mask: Optional[torch.Tensor] = None,
                enc_pad_lens: Optional[torch.Tensor] = None, *,
                impl: str = "auto") -> torch.Tensor:
        """Mean CE of the decoder output; ``loss_mask`` (dec-token shaped,
        1 = count) masks decoder padding out of the mean, ``enc_pad_lens``
        the encoder padding through the stack. ``impl="torch"`` runs every
        kernel's plain version (to hold the kernel path against it on the
        card)."""
        logits = self.logits(params, enc_tokens, dec_tokens, enc_pad_lens,
                             impl=impl)
        losses = vocab_parallel_cross_entropy(logits, targets, impl=impl)
        return masked_mean(losses, loss_mask)

