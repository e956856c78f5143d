"""BERT: the bidirectional encoder's padded MLM training forward, at tp=1.

Port of ``apex_tpu/models/bert.py``: the config, the parameter
initialisation (``BertModel.init``, ``:85-114``, same distributions), the
attention in both ``attention_impl`` routes, the post-LN block
(``:167-171``), :meth:`BertModel.hidden_states` (``:173-210``: token-type
embeddings, the embedding LayerNorm, per-block remat),
:meth:`BertModel.pooled` and :meth:`BertModel.mlm_loss` (``:212-222``,
tied logits through the vocab-parallel cross-entropy, so the
``xent_stats`` kernel runs).

``attention_impl="softmax"`` (the reference's default, ``:149-158``, the
Megatron standalone_bert path): head-batched scores through the fused
scaled-masked softmax with the (b, 1, 1, s) pad mask, True = masked; it
takes ANY pad mask, interior holes included. ``"flash"`` (``:132-148``):
``flash_attention(layout="bshd")`` on views of the packed projection
(:func:`~apex_tpu_torch.ops.attention.bshd_qkv_projection`), the SUFFIX
pad mask turned into per-batch ``kv_lens`` (:meth:`BertModel.
pad_lengths`); on a CUDA tensor the hand-written bshd forward, dQ and
dK/dV kernels run at every head dim (the reference sends d 64 to its
bh-flat fallback only because of the TPU's 128-lane rule,
``ops/attention.py:394-403``).

Parameters are a plain dict in the reference's tree layout, except that
``layers`` is a list of per-layer dicts instead of stacked leaves
(:func:`apex_tpu_torch.models.convert.bert_params_from_jax` converts both
ways).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.models.gpt import param_leaves  # noqa: F401
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.attention import (bshd_output_projection,
                                          bshd_qkv_projection,
                                          flash_attention)
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.softmax import scaled_masked_softmax
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    masked_mean, vocab_parallel_cross_entropy)

Params = Dict[str, object]

@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The reference's ``BertConfig`` without ``tp_size``/``tp_axis`` (the
    port runs tp=1). ``attention_impl``: ``"softmax"`` (the default;
    materialised scores through the fused scaled-masked softmax, any pad
    mask) or ``"flash"`` (the bshd flash kernels; SUFFIX padding only:
    each row's pad mask True only after its last valid token)."""

    vocab_size: int = 30592
    max_seq_len: int = 512
    hidden_size: int = 768
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    num_layers: int = 12
    num_heads: int = 12
    num_token_types: int = 2
    remat: bool = True  # per-block recompute in the backward
    dtype: torch.dtype = torch.float32  # parameter dtype
    attention_impl: str = "softmax"

    def __post_init__(self):
        if self.attention_impl not in ("softmax", "flash"):
            raise ValueError(
                f"attention_impl must be softmax|flash, got "
                f"{self.attention_impl!r}")
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be divisible by "
                f"num_heads ({self.num_heads})")

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class BertModel:
    """Functional BERT: ``init(generator)`` → params;
    ``mlm_loss(params, tokens, targets, loss_mask, token_types, pad_mask)``
    → the masked-LM loss."""

    def __init__(self, config: BertConfig):
        c = self.config = config
        H = c.hidden_size
        self.embedding = VocabParallelEmbedding(c.vocab_size, H)
        self.qkv = ColumnParallelLinear(H, 3 * H)
        self.attn_out = RowParallelLinear(H, H)
        self.mlp_up = ColumnParallelLinear(H, c.ffn)
        self.mlp_down = RowParallelLinear(c.ffn, H)

    # --- params ---------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: Optional[Union[str, torch.device]] = None) -> Params:
        """Random parameters with ``BertModel.init``'s distributions: linear
        and embedding weights U(±1/sqrt(fan_in)) with zero biases, LN
        weights 1 and biases 0, position and token-type embeddings
        N(0, 0.01²), the pooler N(0, 1/H) stored (in, out) as the
        reference's ``hidden @ pooler_w``. Drawn in fp32 from
        ``generator`` (which must live on ``device``), then cast to the
        config's dtype."""
        c = self.config
        dev = _backend.resolve_device(device)
        dt, H = c.dtype, c.hidden_size

        def normal(shape, std):
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            return (t.normal_(0.0, 1.0, generator=generator) * std).to(dt)

        def ones():
            return torch.ones((H,), dtype=dt, device=dev)

        def zeros():
            return torch.zeros((H,), dtype=dt, device=dev)

        layers: List[Dict[str, object]] = []
        for _ in range(c.num_layers):
            layers.append({
                "qkv": self.qkv.init(generator, dt, dev),
                "attn_out": self.attn_out.init(generator, dt, dev),
                "ln1_w": ones(), "ln1_b": zeros(),
                "mlp_up": self.mlp_up.init(generator, dt, dev),
                "mlp_down": self.mlp_down.init(generator, dt, dev),
                "ln2_w": ones(), "ln2_b": zeros(),
            })
        return {
            "embedding": self.embedding.init(generator, dt, dev),
            "pos_embedding": normal((c.max_seq_len, H), 0.01),
            "type_embedding": normal((c.num_token_types, H), 0.01),
            "ln_emb_w": ones(), "ln_emb_b": zeros(),
            "layers": layers,
            "pooler_w": normal((H, H), H ** -0.5),
            "pooler_b": zeros(),
        }

    # --- blocks ---------------------------------------------------------------

    def _attention(self, p, x, pad, impl: str = "auto") -> torch.Tensor:
        """``pad``: the softmax route's (b, s) bool pad mask, or the flash
        route's (b,) lengths; None without padding.

        Softmax (``bert.py:149-158``): the head-batched projection, the
        scores in x's dtype, the fused scaled-masked softmax with the
        (b, 1, 1, s) mask, the context and the output projection
        contracted over (heads, d). Flash (``:132-148``): q, k, v as views
        of the packed projection, flash attention over the per-batch
        lengths, the output projection, then its bias."""
        c = self.config
        h, d = c.num_heads, c.head_dim
        if c.attention_impl == "softmax":
            b, s = x.shape[0], x.shape[1]
            qkv = self.qkv.headwise(p["qkv"], x, 3 * h).reshape(
                b, 3, h, s, d)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
            mask = None if pad is None else pad[:, None, None, :]
            probs = scaled_masked_softmax(scores, mask, 1.0 / float(d) ** 0.5,
                                          impl=impl)
            ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
            return self.attn_out.headwise(p["attn_out"], ctx)
        lens = pad
        q, k, v = bshd_qkv_projection(x, p["qkv"]["weight"],
                                      p["qkv"].get("bias"), h, h, d)
        ctx = flash_attention(q, k, v, kv_lens=lens, layout="bshd",
                              impl=impl)
        y = bshd_output_projection(ctx, p["attn_out"]["weight"], h, d)
        if "bias" in p["attn_out"]:
            y = y + p["attn_out"]["bias"]
        return y

    def _block(self, p, x, pad, impl: str = "auto") -> torch.Tensor:
        """Post-LN (BERT): LN(x + attn(x)), then LN(x + mlp(x))."""
        x = fused_layer_norm(x + self._attention(p, x, pad, impl),
                             p["ln1_w"], p["ln1_b"], impl=impl)
        m = self.mlp_down(p["mlp_down"], F.gelu(
            self.mlp_up(p["mlp_up"], x), approximate="tanh"))
        return fused_layer_norm(x + m, p["ln2_w"], p["ln2_b"], impl=impl)

    def _wrapped(self):
        """The block under the config's ``remat``: recomputed whole in the
        backward (``torch.utils.checkpoint``, non-reentrant: the
        reference's per-block ``jax.checkpoint``)."""
        if not self.config.remat:
            return self._block

        def block(p, x, pad, impl):
            return checkpoint(self._block, p, x, pad, impl,
                              use_reentrant=False)

        return block

    # --- forward --------------------------------------------------------------

    @staticmethod
    def pad_lengths(pad_mask: torch.Tensor) -> torch.Tensor:
        """(b, s) pad mask (True or 1 = padding) → (b,) int32 lengths: each
        row is cut at its FIRST masked position (``bert.py:123-131``).
        Raises ``ValueError`` for an interior mask (a masked position
        followed by an unmasked one), which the flash route cannot express
        (``:179-197``; the softmax route takes it). That check reads the
        mask on the host: on a CUDA mask it is one synchronising read per
        call."""
        mb = pad_mask.bool()
        if bool((mb[..., :-1] & ~mb[..., 1:]).any()):
            raise ValueError(
                "attention_impl='flash' supports suffix padding only (the "
                "pad mask must be monotone per row); use "
                "attention_impl='softmax' for interior masks")
        s = mb.shape[-1]
        return torch.where(mb.any(-1), mb.int().argmax(-1),
                           torch.full_like(mb[..., 0], s, dtype=torch.int64)
                           ).to(torch.int32)

    def hidden_states(self, params: Params, tokens: torch.Tensor,
                      token_types: Optional[torch.Tensor] = None,
                      pad_mask: Optional[torch.Tensor] = None, *,
                      impl: str = "auto") -> torch.Tensor:
        """(b, s) token ids → (b, s, H): word + position (+ token-type)
        embeddings, the embedding LN, then the blocks with the pad mask
        (True or 1 = padding): as the softmax route's key mask, or as the
        flash route's per-batch lengths (padded QUERY rows still compute;
        the loss mask leaves them out)."""
        c = self.config
        s = tokens.shape[1]
        if s > c.max_seq_len:
            raise ValueError(f"sequence {s} exceeds max_seq_len "
                             f"{c.max_seq_len}")
        x = self.embedding(params["embedding"], tokens)
        x = x + params["pos_embedding"][:s]
        if token_types is not None:
            # F.embedding: on the card its backward sums each type's rows
            # in fp32 (an index's bf16 sum over b·s rows loses the table's
            # gradient to rounding)
            x = x + F.embedding(token_types.long(), params["type_embedding"])
        x = fused_layer_norm(x, params["ln_emb_w"], params["ln_emb_b"],
                             impl=impl)
        pad = None
        if pad_mask is not None:
            pad = (pad_mask.bool() if c.attention_impl == "softmax"
                   else self.pad_lengths(pad_mask))
        block = self._wrapped()
        for layer in params["layers"]:
            x = block(layer, x, pad, impl)
        return x

    def pooled(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """The [CLS] pooler: tanh(hidden[:, 0] @ pooler_w + pooler_b)."""
        return torch.tanh(hidden[:, 0] @ params["pooler_w"]
                          + params["pooler_b"])

    def mlm_loss(self, params: Params, tokens: torch.Tensor,
                 targets: torch.Tensor, loss_mask: torch.Tensor,
                 token_types: Optional[torch.Tensor] = None,
                 pad_mask: Optional[torch.Tensor] = None, *,
                 impl: str = "auto") -> torch.Tensor:
        """Masked-LM loss: the tied logits' cross-entropy at every
        position, averaged over those where ``loss_mask`` is 1.
        ``impl="torch"`` runs every kernel's plain version (to hold the
        kernel path against it on the card)."""
        x = self.hidden_states(params, tokens, token_types, pad_mask,
                               impl=impl)
        logits = F.linear(x, params["embedding"]["weight"])
        losses = vocab_parallel_cross_entropy(logits, targets, impl=impl)
        return masked_mean(losses, loss_mask)
