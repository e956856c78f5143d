"""GPT's decode branch: what the serving engine runs, per layer and per token.

Port of ``apex_tpu/models/gpt.py`` at tp=1 with a dense MLP: the config
fields the serving path reads, the parameter initialisation
(``GPTModel.init``, ``:295-328``, same distributions), and the KV-cached
inference branch — :meth:`GPTModel.decode_qkv`, :meth:`GPTModel.
decode_block` (``:684-763``), the tanh-GELU MLP (``:576-582``) and the
tied LM head (``:855``). Parameters are a plain dict of tensors in the
reference's tree layout, except that ``layers`` is a list of per-layer
dicts instead of stacked leaves (:func:`apex_tpu_torch.models.convert.
params_from_jax` converts).

The training forward, its flash-attention kernels and the parallel forms
are later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.attention import (bshd_output_projection,
                                          bshd_qkv_projection)
from apex_tpu_torch.ops.decode_attention import (KERNEL_GROUPS,
                                                 KERNEL_HEAD_DIMS,
                                                 KERNEL_MAX_BLOCK,
                                                 decode_attention)
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    max_seq_len: int = 2048
    hidden_size: int = 1024
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    num_layers: int = 12
    num_heads: int = 16
    # grouped-query attention: None = num_heads (MHA), 1 = MQA
    num_kv_heads: Optional[int] = None
    dtype: torch.dtype = torch.float32  # parameter dtype

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be divisible by "
                f"num_heads ({self.num_heads})")
        if self.num_kv_heads is not None:
            if self.num_kv_heads < 1:
                raise ValueError(
                    f"num_kv_heads must be >= 1, got {self.num_kv_heads}")
            if self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"num_kv_heads ({self.num_kv_heads}) must divide "
                    f"num_heads ({self.num_heads})")

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)

    @property
    def qkv_features(self) -> int:
        """Packed QKV width: h_q + 2*h_kv head groups."""
        return (self.num_heads + 2 * self.kv_heads) * self.head_dim


class GPTModel:
    """Functional GPT: ``init(generator)`` → params dict; the decode
    branch below runs one token per slot through one block."""

    def __init__(self, config: GPTConfig):
        c = self.config = config
        self.embedding = VocabParallelEmbedding(c.vocab_size, c.hidden_size)
        self.qkv = ColumnParallelLinear(c.hidden_size, c.qkv_features)
        self.attn_out = RowParallelLinear(c.hidden_size, c.hidden_size)
        self.mlp_up = ColumnParallelLinear(c.hidden_size, c.ffn)
        self.mlp_down = RowParallelLinear(c.ffn, c.hidden_size)

    # --- params ---------------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: Optional[Union[str, torch.device]] = None) -> Params:
        """Random parameters with ``GPTModel.init``'s distributions: LN
        weights 1 and biases 0, linear and embedding weights
        U(±1/sqrt(fan_in)), linear biases 0, positions N(0, 0.01²). Drawn
        in fp32 from ``generator`` (which must live on ``device``), then
        cast to the config's dtype."""
        c = self.config
        dev = _backend.resolve_device(device)
        dt = c.dtype
        ones = lambda: torch.ones((c.hidden_size,), dtype=dt,  # noqa: E731
                                  device=dev)
        zeros = lambda: torch.zeros((c.hidden_size,), dtype=dt,  # noqa: E731
                                    device=dev)
        layers: List[Dict[str, object]] = []
        for _ in range(c.num_layers):
            layers.append({
                "ln1_w": ones(), "ln1_b": zeros(),
                "qkv": self.qkv.init(generator, dt, dev),
                "attn_out": self.attn_out.init(generator, dt, dev),
                "ln2_w": ones(), "ln2_b": zeros(),
                "mlp_up": self.mlp_up.init(generator, dt, dev),
                "mlp_down": self.mlp_down.init(generator, dt, dev),
            })
        pos = torch.empty((c.max_seq_len, c.hidden_size),
                          dtype=torch.float32, device=dev)
        pos.normal_(0.0, 1.0, generator=generator)
        return {
            "embedding": self.embedding.init(generator, dt, dev),
            "pos_embedding": (pos * 0.01).to(dt),
            "layers": layers,
            "lnf_w": ones(),
            "lnf_b": zeros(),
        }

    # --- KV-cached inference branch -------------------------------------------

    def check_decode_supported(self, device: torch.device,
                               block_size: int) -> None:
        """Eager check that the paged decode kernel takes this model's
        attention shape and the pool's block size on ``device`` (the
        CPU's plain version takes any)."""
        c = self.config
        group = c.num_heads // c.kv_heads
        if device.type == "cuda" and (c.head_dim not in KERNEL_HEAD_DIMS
                                      or group not in KERNEL_GROUPS
                                      or block_size > KERNEL_MAX_BLOCK):
            raise ValueError(
                f"the paged decode kernel takes head_dim in "
                f"{KERNEL_HEAD_DIMS}, {KERNEL_GROUPS} query heads per kv "
                f"head and blocks of at most {KERNEL_MAX_BLOCK} rows; this "
                f"model has head_dim {c.head_dim} and {group} query heads "
                f"per kv head, the pool block_size {block_size}")

    def _proj_qkv_bshd(self, p, x):
        """(b, s, H) → q (b, s, h, d), k/v (b, s, h_kv, d) via the packed
        projection."""
        c = self.config
        return bshd_qkv_projection(x, p["qkv"]["weight"],
                                   p["qkv"].get("bias"), c.num_heads,
                                   c.kv_heads, c.head_dim)

    def _proj_attn_out(self, p, ctx):
        """(b, s, h, d) context → (b, s, H) through the output weight."""
        c = self.config
        y = bshd_output_projection(ctx, p["attn_out"]["weight"],
                                   c.num_heads, c.head_dim)
        if "bias" in p["attn_out"]:
            y = y + p["attn_out"]["bias"]
        return y

    def _mlp(self, p, x):
        h = F.gelu(self.mlp_up(p["mlp_up"], x), approximate="tanh")
        return self.mlp_down(p["mlp_down"], h)

    def decode_qkv(self, p, x
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """ONE token's attention inputs: pre-LN + packed projection of x
        (b, 1, H) → q (b, h, d) and this token's cache rows k/v
        (b, h_kv, 1, d)."""
        h_in = fused_layer_norm(x, p["ln1_w"], p["ln1_b"])
        q, k, v = self._proj_qkv_bshd(p, h_in)
        return q[:, 0], k.transpose(1, 2), v.transpose(1, 2)

    def decode_block(self, p, x, q, k_pool, v_pool, lengths, *,
                     block_tables, impl: str = "auto") -> torch.Tensor:
        """One token through one block against this layer's pool
        (``(num_blocks, h_kv, block_size, d)``, ALREADY holding the
        token's own row): x (b, 1, H) the residual stream, q (b, h, d),
        ``lengths`` (b,) live rows including this token, ``block_tables``
        (b, nb). Returns the block output (b, 1, H)."""
        ctx = decode_attention(q, k_pool, v_pool, lengths,
                               block_tables=block_tables, impl=impl)
        x = x + self._proj_attn_out(p, ctx[:, None])
        m = self._mlp(p, fused_layer_norm(x, p["ln2_w"], p["ln2_b"]))
        return x + m

    def unembed(self, params, x) -> torch.Tensor:
        """Tied LM head: hidden states → logits (…, V)."""
        return F.linear(x, params["embedding"]["weight"])
