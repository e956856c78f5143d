"""GPT: the training forward and the decode branch, at tp=1 with a dense MLP.

Port of ``apex_tpu/models/gpt.py``: the config, the parameter
initialisation (``GPTModel.init``, ``:295-328``, same distributions), the
training forward — :meth:`GPTModel._attention` (the three
``attention_impl`` routes: ``"softmax"``, the reference's default, the
head-batched materialised scores through the fused causal softmax of
``:480-515``; ``"flash"``, the fused packed-QKV flash route of
``:372-407``; ``"naive"``, the plain fp32 softmax composition of
``:500-509``), :meth:`GPTModel._block` (``:621-645``),
:meth:`GPTModel.wrapped_block` (``:647-670``), :meth:`GPTModel.
hidden_states` (``:767-837``), :meth:`GPTModel.logits` and
:meth:`GPTModel.loss_fn` (``:857-880``) — and the KV-cached inference
branch, :meth:`GPTModel.decode_qkv` and :meth:`GPTModel.decode_block`
(``:684-763``), with the tanh-GELU MLP (``:576-582``) and the tied LM
head (``:855``), and :meth:`GPTModel.prefill_block` (``:713-725``), the
decode engine's prompt forward through the bshd flash kernel. Parameters
are a plain dict of tensors in the
reference's tree layout, except that ``layers`` is a list of per-layer
dicts instead of stacked leaves (:mod:`apex_tpu_torch.models.convert`
converts both ways).

A train step is ``loss_fn`` then ``backward()`` then one
:class:`apex_tpu_torch.optimizers.FusedAdam` step over
:func:`param_leaves`. The config carries only the knobs the port runs:
``attention_impl`` (the training forward's route; the decode branch and
the prefill take the flash kernels whatever it says, as the reference's
engines never read it), ``remat`` with the reference's four
``remat_policy`` values (``:69-79``, :meth:`GPTModel.wrapped_block`), and
``dropout``. Later slices add the reference's other knobs (MoE,
tensor/sequence/context parallelism, ``scan_layers``, which has no second
working value in eager PyTorch) together with the code that runs them.

Dropout (``:354-370``, ``:505-516``, ``:621-645``): the reference folds a
``jax.random`` key per (layer, slot); the port takes the seeds those
folds give, explicitly — ``dropout_seeds`` (num_layers, 3) int32 on the
CPU (:meth:`GPTModel.dropout_seeds` draws them from a
``torch.Generator``), read on the host once per layer. Slot 0 drops the
attention probabilities on every route (in the flash kernels; through
:func:`apex_tpu_torch.ops.dropout.dropout` on the softmax and naive
routes), slots 1 and 2 the attention and MLP outputs before their
residual adds. ``dropout_seeds=None`` is the reference's ``key=None``: no
dropout. The masks are pure functions of the seeds, so a recompute under
remat rebuilds the same ones. The decode branch, the prefill and the
engines never drop, as the reference's do not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.amp.lists import apply_op_rules
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.attention import (bshd_output_projection,
                                          bshd_qkv_projection,
                                          flash_attention,
                                          fused_qkv_attention)
from apex_tpu_torch.ops.decode_attention import (KERNEL_CACHE_TILE,
                                                 KERNEL_GROUPS,
                                                 KERNEL_HEAD_DIMS,
                                                 KERNEL_MAX_BLOCK,
                                                 decode_attention)
from apex_tpu_torch.ops.dropout import dropout as drop_out
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.softmax import scaled_upper_triang_masked_softmax
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    masked_mean, vocab_parallel_cross_entropy)

Params = Dict[str, object]
#: the reference's remat policies (``gpt.py:69-79``)
REMAT_POLICIES = ("full", "save_attn", "save_attn_mlp", "mlp_only")
#: the dropout seed slots of a layer: the attention probabilities, the
#: attention output, the MLP output (``gpt.py:366``, ``:630``, ``:643``)
DROPOUT_SLOTS = 3


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
    # training knobs with the reference's defaults. dropout: the rate of
    # the probability and residual dropout (applied when the forward is
    # given seeds). remat_policy: "full" recomputes the whole block,
    # "save_attn"/"save_attn_mlp" keep the attention output (and the MLP
    # hidden) and recompute the rest, "mlp_only" recomputes the MLP half
    # only. "softmax": materialised scores through the fused causal
    # softmax kernel; "flash": the fused packed-QKV flash kernels; "naive":
    # the plain fp32 softmax composition (no kernel)
    dropout: float = 0.0
    remat: bool = True
    remat_policy: str = "full"
    attention_impl: str = "softmax"

    def __post_init__(self):
        if self.attention_impl not in ("softmax", "flash", "naive"):
            raise ValueError(
                f"attention_impl must be softmax|flash|naive, got "
                f"{self.attention_impl!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be full|save_attn|save_attn_mlp|"
                f"mlp_only, got {self.remat_policy!r}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got "
                             f"{self.dropout}")
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

    def check_paged_decode_supported(self, device: torch.device,
                                     block_size: int) -> None:
        """Eager check that the paged decode kernel takes this model's
        attention shape and the pool's ``block_size`` on ``device`` (the
        CPU's plain version takes any)."""
        if device.type != "cuda":
            return
        c = self.config
        group = c.num_heads // c.kv_heads
        if (c.head_dim not in KERNEL_HEAD_DIMS or group not in KERNEL_GROUPS
                or block_size > KERNEL_MAX_BLOCK):
            raise ValueError(
                f"the paged decode kernel takes head_dim in "
                f"{KERNEL_HEAD_DIMS}, {KERNEL_GROUPS} query heads per kv "
                f"head and blocks of at most {KERNEL_MAX_BLOCK} rows; this "
                f"model has head_dim {c.head_dim} and {group} query heads "
                f"per kv head, the pool block_size {block_size}")

    def check_engine_supported(self, device: torch.device,
                               max_s: int) -> None:
        """Eager check that the decode engine's kernels take this model on
        ``device``: the contiguous decode kernel over a ``max_s`` cache and
        the prefill's bshd flash kernel (bfloat16 parameters)."""
        if device.type != "cuda":
            return
        c = self.config
        group = c.num_heads // c.kv_heads
        if (c.head_dim not in KERNEL_HEAD_DIMS or group not in KERNEL_GROUPS
                or c.dtype != torch.bfloat16 or max_s % KERNEL_CACHE_TILE):
            raise ValueError(
                f"the decode engine's kernels take head_dim in "
                f"{KERNEL_HEAD_DIMS} (prefill flash and decode), "
                f"{KERNEL_GROUPS} query heads per kv head and a cache "
                f"length that is a multiple of {KERNEL_CACHE_TILE} (decode), "
                f"bfloat16 (the prefill's flash kernel); this model has "
                f"head_dim {c.head_dim}, {group} query heads per kv head, "
                f"{c.dtype}, cache length {max_s}")

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

    def _gelu_up(self, p, x):
        """gelu(mlp_up(x)): the MLP's hidden ("mlp_h", ``:576-582``)."""
        return F.gelu(self.mlp_up(p["mlp_up"], x), approximate="tanh")

    def _mlp(self, p, x):
        return self.mlp_down(p["mlp_down"], self._gelu_up(p, x))

    def decode_qkv(self, p, x, impl: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """ONE token's attention inputs: pre-LN + packed projection of x
        (b, 1, H) → q (b, h, d) and this token's cache rows k/v
        (b, h_kv, 1, d)."""
        h_in = fused_layer_norm(x, p["ln1_w"], p["ln1_b"], impl=impl)
        q, k, v = self._proj_qkv_bshd(p, h_in)
        return q[:, 0], k.transpose(1, 2), v.transpose(1, 2)

    def prefill_block(self, p, x, impl: str = "auto"
                      ) -> Tuple[torch.Tensor,
                                 Tuple[torch.Tensor, torch.Tensor]]:
        """One block of the PREFILL forward: pre-LN → causal bshd flash
        attention → residual → pre-LN → MLP → residual, returning also
        this layer's (k, v) as (b, h_kv, s, d) views — what the engine
        writes into cache rows [0, s). q, k and v go to the kernel as
        views of the packed projection: no copy."""
        h_in = fused_layer_norm(x, p["ln1_w"], p["ln1_b"], impl=impl)
        q, k, v = self._proj_qkv_bshd(p, h_in)
        ctx = flash_attention(q, k, v, causal=True, layout="bshd",
                              impl=impl)
        x = x + self._proj_attn_out(p, ctx)
        m = self._mlp(p, fused_layer_norm(x, p["ln2_w"], p["ln2_b"],
                                          impl=impl))
        return x + m, (k.transpose(1, 2), v.transpose(1, 2))

    def decode_block(self, p, x, q, k_lay, v_lay, lengths, *,
                     block_tables: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> torch.Tensor:
        """One token through one block against this layer's cache,
        ALREADY holding the token's own row: x (b, 1, H) the residual
        stream, q (b, h, d), ``lengths`` (b,) live rows including this
        token. ``k_lay``/``v_lay`` are the contiguous (b, h_kv, max_s, d)
        cache, or with ``block_tables`` (b, nb) the shared
        (num_blocks, h_kv, block_size, d) pool. Returns (b, 1, H)."""
        ctx = decode_attention(q, k_lay, v_lay, lengths,
                               block_tables=block_tables, impl=impl)
        x = x + self._proj_attn_out(p, ctx[:, None])
        m = self._mlp(p, fused_layer_norm(x, p["ln2_w"], p["ln2_b"],
                                          impl=impl))
        return x + m

    def unembed(self, params, x) -> torch.Tensor:
        """Tied LM head: hidden states → logits (…, V)."""
        return F.linear(x, params["embedding"]["weight"])

    # --- training forward -----------------------------------------------------

    def dropout_seeds(self, generator: torch.Generator) -> torch.Tensor:
        """Fresh dropout seeds for one forward: (num_layers, 3) int32 on
        the CPU, uniform over all int32 values, drawn from ``generator``
        (on the CPU, or on a card: then copied to the CPU once)."""
        seeds = torch.randint(-2 ** 31, 2 ** 31,
                              (self.config.num_layers, DROPOUT_SLOTS),
                              dtype=torch.int32, generator=generator,
                              device=generator.device)
        return seeds.cpu()

    def _layer_seeds(self, dropout_seeds, num_layers: int):
        """Per layer, None (no dropout) or its (probs, attn, mlp) seeds as
        host ints."""
        if dropout_seeds is None or self.config.dropout == 0.0:
            return [None] * num_layers
        seeds = torch.as_tensor(dropout_seeds)
        if seeds.device.type != "cpu" or tuple(seeds.shape) != (
                num_layers, DROPOUT_SLOTS) or seeds.dtype not in (
                torch.int32, torch.int64):
            raise ValueError(
                f"dropout_seeds must be a ({num_layers}, {DROPOUT_SLOTS}) "
                f"integer tensor on the CPU (GPTModel.dropout_seeds); got "
                f"{tuple(seeds.shape)} {seeds.dtype} on {seeds.device}")
        return [tuple(int(v) for v in row) for row in seeds.tolist()]

    def _attention(self, p, x, impl: str = "auto",
                   seeds=None) -> torch.Tensor:
        """The config's ``attention_impl`` route.

        ``"flash"``: the fused route of the reference's flash attention:
        packed QKV GEMM → flash kernels on windows of the packed buffer →
        output GEMM (:func:`fused_qkv_attention`), then the output bias;
        under an O1 policy x and the three weights are cast first (HALF:
        the flash kernels run at the compute dtype, the bias add promotes
        back to fp32).
        On a CUDA tensor a shape the kernels refuse (``packed_kernel_ok``)
        raises.

        ``"softmax"`` and ``"naive"`` (``:480-515``): the head-batched
        projection to (b, h, s, d), k and v repeated over the query heads
        of a group, the scores in x's dtype, then the fused causal
        softmax kernel (``"softmax"``) or the -1e30 fill and an fp32
        softmax (``"naive"``), the context, and the output projection
        contracted over (heads, d).

        ``seeds``: None, or the layer's (probs, attn, mlp) seeds; slot 0
        drops the probabilities — in the flash kernels, or after the
        softmax (``:507-516``)."""
        c = self.config
        h, hkv, d = c.num_heads, c.kv_heads, c.head_dim
        rate = c.dropout if seeds is not None else 0.0
        if c.attention_impl == "flash":
            # the O1 cast comes before the kernels (``:375-386``): under an
            # fp16 O1 policy the flash kernels' fp16 instances run
            xc, w_qkv, b_qkv, w_out = apply_op_rules(
                "attention", x, p["qkv"]["weight"], p["qkv"].get("bias"),
                p["attn_out"]["weight"])
            y = fused_qkv_attention(xc, w_qkv, b_qkv, w_out, h, hkv, d,
                                    1.0 / float(d) ** 0.5, True,
                                    dropout_rate=rate,
                                    dropout_seed=(None if seeds is None
                                                  else seeds[0]),
                                    impl=impl)
            if "bias" in p["attn_out"]:
                y = y + p["attn_out"]["bias"]
            return y
        qkv = self.qkv.headwise(p["qkv"], x, h + 2 * hkv)
        b, s = qkv.shape[0], qkv.shape[2]
        q, k, v = qkv[:, :h], qkv[:, h:h + hkv], qkv[:, h + hkv:]
        if hkv < h:
            k = k.repeat_interleave(h // hkv, dim=1)
            v = v.repeat_interleave(h // hkv, dim=1)
        if c.attention_impl == "naive":
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / float(d) ** 0.5
            keep = torch.ones((s, s), dtype=torch.bool,
                              device=x.device).tril()
            scores = torch.where(keep, scores.float(), -1e30)
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
            probs = scaled_upper_triang_masked_softmax(
                scores.reshape(b * h, s, s), 1.0 / float(d) ** 0.5,
                impl=impl).reshape(b, h, s, s)
        if rate > 0.0:
            probs = drop_out(probs, rate, seeds[0], impl=impl)
        ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self.attn_out.headwise(p["attn_out"], ctx)

    def _attn_half(self, p, x, impl="auto", seeds=None) -> torch.Tensor:
        """The attention output of the block: attn(LN1(x)), undropped."""
        return self._attention(p, fused_layer_norm(
            x, p["ln1_w"], p["ln1_b"], impl=impl), impl, seeds)

    def _mlp_half(self, p, x, impl="auto") -> torch.Tensor:
        return self._mlp(p, fused_layer_norm(x, p["ln2_w"], p["ln2_b"],
                                             impl=impl))

    def _mlp_hidden(self, p, x, impl="auto") -> torch.Tensor:
        return self._gelu_up(p, fused_layer_norm(x, p["ln2_w"], p["ln2_b"],
                                                 impl=impl))

    def _residual(self, x, y, seeds, slot: int, impl: str) -> torch.Tensor:
        """x + dropout(y) with the layer's seed of ``slot`` (1: the
        attention output, 2: the MLP output)."""
        if seeds is not None and self.config.dropout > 0.0:
            y = drop_out(y, self.config.dropout, seeds[slot], impl=impl)
        return x + y

    def _block(self, p, x, impl: str = "auto", seeds=None) -> torch.Tensor:
        """Residual block (``:621-645``): x + drop(attn(LN(x))), then
        + drop(mlp(LN(x)))."""
        x = self._residual(x, self._attn_half(p, x, impl, seeds), seeds, 1,
                           impl)
        return self._residual(x, self._mlp_half(p, x, impl), seeds, 2, impl)

    def wrapped_block(self):
        """The block under the config's ``remat`` and ``remat_policy``
        (``:647-670``), each recompute by ``torch.utils.checkpoint``
        (non-reentrant):

        * ``"full"``: the whole block, recomputed in the backward from its
          input (``jax.checkpoint`` with the default policy);
        * ``"save_attn"``: the attention output is kept (the checkpoint of
          the attention half returns it; the residual after it is what the
          MLP half's checkpoint keeps), the attention half and the MLP half
          are recomputed — as ``save_only_these_names("attn_out")``, where
          the attention's backward needs q, k, v and so reruns it anyway;
        * ``"save_attn_mlp"``: also the MLP hidden gelu(mlp_up(LN(x)))
          ("mlp_h"), kept by the down projection; LN2, the up projection
          and the gelu are recomputed;
        * ``"mlp_only"``: the attention half runs once, its activations
          kept; the MLP half is recomputed.

        Dropout masks are pure functions of the seeds: every recompute
        rebuilds the forward's."""
        c = self.config
        if not c.remat:
            return self._block
        ck = lambda fn, *a: checkpoint(fn, *a,  # noqa: E731
                                       use_reentrant=False)
        if c.remat_policy == "full":
            return lambda p, x, impl="auto", seeds=None: ck(
                self._block, p, x, impl, seeds)

        def block(p, x, impl="auto", seeds=None):
            if c.remat_policy == "mlp_only":
                a = self._attn_half(p, x, impl, seeds)
            else:
                a = ck(self._attn_half, p, x, impl, seeds)
            x = self._residual(x, a, seeds, 1, impl)
            if c.remat_policy == "save_attn_mlp":
                m = self.mlp_down(p["mlp_down"],
                                  ck(self._mlp_hidden, p, x, impl))
            else:
                m = ck(self._mlp_half, p, x, impl)
            return self._residual(x, m, seeds, 2, impl)

        return block

    def hidden_states(self, params: Params, tokens: torch.Tensor, *,
                      dropout_seeds: Optional[torch.Tensor] = None,
                      impl: str = "auto") -> torch.Tensor:
        """(b, s) token ids → final-LN hidden states (b, s, H): embedding
        plus ``pos_embedding[:s]``, the blocks in an unrolled loop, the
        final LN. ``dropout_seeds``: None (no dropout, the reference's
        ``key=None``) or (num_layers, 3) int32 on the CPU
        (:meth:`dropout_seeds`), row i the seeds of layer i."""
        c = self.config
        s = tokens.shape[1]
        if s > c.max_seq_len:
            raise ValueError(f"sequence {s} exceeds max_seq_len "
                             f"{c.max_seq_len}")
        layer_seeds = self._layer_seeds(dropout_seeds,
                                        len(params["layers"]))
        x = self.embedding(params["embedding"], tokens)
        x = x + params["pos_embedding"][:s]
        block = self.wrapped_block()
        for layer, seeds in zip(params["layers"], layer_seeds):
            x = block(layer, x, impl, seeds)
        return fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                                impl=impl)

    def logits(self, params: Params, tokens: torch.Tensor, *,
               dropout_seeds: Optional[torch.Tensor] = None,
               impl: str = "auto") -> torch.Tensor:
        """Tied unembedding of the hidden states: (b, s, V)."""
        return self.unembed(params, self.hidden_states(
            params, tokens, dropout_seeds=dropout_seeds, impl=impl))

    def loss_fn(self, params: Params, tokens: torch.Tensor,
                targets: torch.Tensor,
                loss_mask: Optional[torch.Tensor] = None, *,
                dropout_seeds: Optional[torch.Tensor] = None,
                impl: str = "auto") -> torch.Tensor:
        """Mean LM loss through the vocab-parallel cross-entropy (tp=1);
        ``loss_mask`` (tokens-shaped, 1 = count) weights the mean;
        ``dropout_seeds`` as :meth:`hidden_states`'. ``impl="torch"`` runs
        every kernel's plain version (for holding the kernel path against
        it on the card)."""
        logits = self.logits(params, tokens, dropout_seeds=dropout_seeds,
                             impl=impl)
        losses = vocab_parallel_cross_entropy(logits, targets, impl=impl)
        return masked_mean(losses, loss_mask)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every tensor of a parameter (or gradient) dict, in a fixed
    depth-first order — what an optimizer steps over."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    return [t for item in params for t in param_leaves(item)]
