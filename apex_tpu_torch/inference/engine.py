"""KV-cached autoregressive decode engine for GPT, with speculative
decoding.

Port of ``apex_tpu/inference/engine.py`` (``:82-912``), the tp=1 bodies:

* a pre-allocated cache ``{"k"/"v": (layers, batch, kv_heads, max_s,
  head_dim)}`` (:meth:`DecodeEngine.init_cache`), updated IN PLACE:
  :meth:`DecodeEngine.prefill` writes rows [0, s) and
  :meth:`DecodeEngine.decode_step` writes the token's k and v row at
  ``pos`` before attention reads it (``:286-291``). The cache is never
  rebuilt or copied (the reference gets the same from donation and
  ``dynamic_update_slice``);
* the prefill runs every block through :meth:`GPTModel.prefill_block`
  (the bshd flash kernel), a decode step through the contiguous decode
  kernel (:func:`apex_tpu_torch.ops.decode_attention`);
* ``generate(draft=...)`` speculates at batch 1: a chain drafter's k
  tokens (or a tree drafter's nodes) are scored in one multi-token step
  and the verify kernel (:func:`apex_tpu_torch.ops.fused_verify` /
  :func:`~apex_tpu_torch.ops.fused_verify.fused_verify_tree`) accepts the
  longest valid prefix (path). Greedy spec output is token-identical to
  greedy decoding; :class:`SpecStats` accounts acceptance. On the tree
  path ``adaptive=`` (an :class:`~apex_tpu_torch.spec.tree.
  AdaptiveSpecController`) re-picks each round's (depth, branching).

PyTorch runs eagerly, so nothing here compiles; positions are host
integers. JAX keys become one explicit ``torch.Generator`` per
``generate`` call, drawn in order: the prefill's noise, then each decode
step's or spec round's. A model's ``decode_rel_bias(params)`` hook (a
causal BucketedBias) reaches every decode step's kernel, as the
reference's (``:273-293``); ``generate(draft=)`` refuses such a model. The
prefill, each decode step and each spec round run inside the
``decode_prefill`` / ``decode_step`` / ``spec_verify`` spans, and a
``generate`` call inside one trace id (:mod:`apex_tpu_torch.monitor`). A
:class:`~apex_tpu_torch.spec.tree.PagedModelDrafter` needs a serving
scheduler to bind to, so it drafts for ``ServingEngine.serve`` only.

:func:`jit_encoder` is the encoder-serving entry (``:915-934``): BERT's
hidden states and pooler at fixed padded shapes, eager under
``torch.inference_mode()``.

Not ported yet: the reference's ``DecodeEngine(plan=)`` (tensor-parallel
decode, ROADMAP queue 1, item 6); ``cache_dtype`` has no second value the
decode kernel takes, so it is not in the signature here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.inference.sampling import sample_logits
from apex_tpu_torch.models.gpt import GPTModel
from apex_tpu_torch.monitor import spans as monitor_spans
from apex_tpu_torch.monitor import trace as monitor_trace
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.fused_verify import fused_verify, fused_verify_tree
from apex_tpu_torch.ops.layer_norm import fused_layer_norm

#: masked-score value (``apex_tpu/ops/pallas/attention.py:33``)
NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


@dataclass
class SpecStats:
    """Host-side accounting of one speculative ``generate`` call.
    ``drafted`` counts path depth per round (the chain's k, the tree's
    depth); ``nodes`` counts the verify rows scored besides the root."""

    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    nodes: int = 0

    @property
    def acceptance_rate(self) -> float:
        """Accepted drafts / drafted tokens (0.0 before any round)."""
        return self.accepted / self.drafted if self.drafted else 0.0


class DecodeEngine:
    """Batched greedy/sampled generation over a :class:`GPTModel`.

    ``engine = DecodeEngine(model)``;
    ``tokens = engine.generate(params, prompt, max_new_tokens)``.

    ``max_seq_len`` sizes the cache (default: the model's) and must be a
    multiple of 128 — the decode kernel's cache tile; a cache may be
    rounded up past the position table, and ``generate`` still refuses to
    step positions past the table. The cache holds the model's parameter
    dtype (the decode kernel reads q and the cache in one dtype).
    ``temperature``/``top_k`` select the sampling tail
    (greedy at 0). ``device`` defaults to the card and raises without one;
    ``impl="torch"`` runs every kernel's plain version (for holding the
    kernels against them)."""

    def __init__(self, model: GPTModel, *, max_seq_len: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 impl: str = "auto"):
        if impl not in _backend.IMPLS:
            raise ValueError(f"impl must be one of {_backend.IMPLS}, got "
                             f"{impl!r}")
        self.device = _backend.resolve_device(device)
        self.impl = impl
        self.model = model
        c = self.config = model.config
        self.max_s = int(max_seq_len or c.max_seq_len)
        if self.max_s < 1 or self.max_s % 128:
            raise ValueError(
                f"max_seq_len ({self.max_s}) must be a positive multiple "
                f"of 128 (the decode kernel's cache tile) — round the "
                f"cache up: DecodeEngine(model, max_seq_len="
                f"{((self.max_s + 127) // 128) * 128}); generation is "
                f"still capped by the model's position table "
                f"({c.max_seq_len})")
        if self.max_s > ((c.max_seq_len + 127) // 128) * 128:
            raise ValueError(
                f"cache max_seq_len ({self.max_s}) exceeds the model's "
                f"position table ({c.max_seq_len}) by more than the "
                f"128-rounding slack")
        if impl == "auto":
            model.check_engine_supported(self.device, self.max_s)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.last_spec_stats: Optional[SpecStats] = None

    # --- cache ---------------------------------------------------------------

    def init_cache(self, batch: int) -> Cache:
        """The zeroed cache ``{"k"/"v": (layers, batch, kv_heads, max_s,
        head_dim)}`` on the engine's device."""
        c = self.config
        shape = (c.num_layers, batch, c.kv_heads, self.max_s, c.head_dim)
        return {name: torch.zeros(shape, dtype=c.dtype, device=self.device)
                for name in ("k", "v")}

    def cache_bytes(self, batch: int) -> int:
        """Device footprint of one cache (k and v)."""
        c = self.config
        itemsize = torch.empty((), dtype=c.dtype).element_size()
        return (2 * c.num_layers * batch * c.kv_heads * self.max_s
                * c.head_dim * itemsize)

    # --- sampling ------------------------------------------------------------

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator],
                u: Optional[torch.Tensor]) -> torch.Tensor:
        return sample_logits(logits, temperature=self.temperature,
                             top_k=self.top_k, generator=generator, u=u)

    # --- prefill -------------------------------------------------------------

    def prefill(self, params, tokens: torch.Tensor, *,
                cache: Optional[Cache] = None,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None
                ) -> Tuple[Cache, torch.Tensor, torch.Tensor]:
        """Prompt (b, s) → (cache holding the prompt's k/v at rows
        [0, s), next token (b,), last-position logits (b, V)). ``cache``
        (from :meth:`init_cache`) is written in place; without one a new
        cache is allocated. Rows past s keep what they held: the lengths
        mask them. Runs inside the ``decode_prefill`` span."""
        with monitor_spans.span("decode_prefill"):
            return self._prefill_body(params, tokens, cache, generator, u)

    @torch.no_grad()
    def _prefill_body(self, params, tokens: torch.Tensor,
                      cache: Optional[Cache],
                      generator: Optional[torch.Generator],
                      u: Optional[torch.Tensor]
                      ) -> Tuple[Cache, torch.Tensor, torch.Tensor]:
        model, c = self.model, self.config
        b, s = tokens.shape
        if cache is None:
            cache = self.init_cache(b)
        x = model.embedding(params["embedding"], tokens)
        x = x + params["pos_embedding"][:s]
        for i, layer in enumerate(params["layers"]):
            x, (k, v) = model.prefill_block(layer, x, impl=self.impl)
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        logits = model.unembed(params, x[:, -1:])[:, 0]
        return cache, self._sample(logits, generator, u), logits

    # --- decode --------------------------------------------------------------

    def decode_step(self, params, cache: Cache, tokens: torch.Tensor,
                    pos: int, *, generator: Optional[torch.Generator] = None,
                    u: Optional[torch.Tensor] = None
                    ) -> Tuple[Cache, torch.Tensor, torch.Tensor]:
        """One generation step: ``tokens`` (b,) at position ``pos`` (the
        count of cache rows already live) run through the stack; each
        layer writes their k/v at row ``pos`` in place, then attends rows
        [0, pos]. Returns (cache, next tokens (b,), logits (b, V)). Runs
        inside the ``decode_step`` span."""
        with monitor_spans.span("decode_step"):
            return self._decode_step_body(params, cache, tokens, pos,
                                          generator, u)

    @torch.no_grad()
    def _decode_step_body(self, params, cache: Cache, tokens: torch.Tensor,
                          pos: int, generator: Optional[torch.Generator],
                          u: Optional[torch.Tensor]
                          ) -> Tuple[Cache, torch.Tensor, torch.Tensor]:
        model, c = self.model, self.config
        b = tokens.shape[0]
        pos = int(pos)
        x = model.embedding(params["embedding"], tokens[:, None])
        x = x + params["pos_embedding"][pos]
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=tokens.device)
        ck, cv = cache["k"], cache["v"]
        # the hook's bias reaches every block (:273-293); the prefill stays
        # unbiased, as the reference's
        hook = getattr(model, "decode_rel_bias", None)
        rel_bias = None if hook is None else hook(params)
        for i, layer in enumerate(params["layers"]):
            q, k_row, v_row = model.decode_qkv(layer, x, self.impl)
            ck[i, :, :, pos:pos + 1] = k_row
            cv[i, :, :, pos:pos + 1] = v_row
            x = model.decode_block(layer, x, q, ck[i], cv[i], lengths,
                                   rel_bias=rel_bias, impl=self.impl)
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        logits = model.unembed(params, x)[:, 0]
        return cache, self._sample(logits, generator, u), logits

    def _refuse_rel_bias(self) -> None:
        """``draft=`` with a hooked model (``:689-694``, ``:770-779``): the
        spec scoring does not carry the bias, so verifying biased logits
        against unbiased ones would break the token-identical contract."""
        if getattr(self.model, "decode_rel_bias", None) is not None:
            raise ValueError(
                "draft= speculative decoding cannot run a model with a "
                "decode relative-position bias (the spec verify step does "
                "not carry the bucketed bias) — generate with draft=None "
                "for this model")

    # --- speculative verification --------------------------------------------

    def _spec_verify_step(self, *args) -> Tuple[torch.Tensor, torch.Tensor]:
        """A chain round (:meth:`_spec_verify_body`) inside the
        ``spec_verify`` span."""
        with monitor_spans.span("spec_verify"):
            return self._spec_verify_body(*args)

    def _spec_tree_verify_step(self, *args
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
        """A tree round (:meth:`_spec_tree_verify_body`) inside the
        ``spec_verify`` span."""
        with monitor_spans.span("spec_verify"):
            return self._spec_tree_verify_body(*args)

    def _embed_at(self, params, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """(1, n) tokens at ``positions`` (n,): token plus position
        embedding, positions clamped into the table."""
        ptab = params["pos_embedding"]
        x = self.model.embedding(params["embedding"], tokens)
        return x + ptab[positions.clamp_max(ptab.shape[0] - 1)][None]

    def _layer_tail(self, layer, x, ctx):
        """Output projection, residual, MLP, residual."""
        model = self.model
        x = x + model._proj_attn_out(layer, ctx)
        return x + model._mlp(layer, fused_layer_norm(
            x, layer["ln2_w"], layer["ln2_b"], impl=self.impl))

    def _scores(self, q: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """fp32 scaled scores: q (1, n, h, d) against keys (h_kv, m, d) →
        (h_kv, group, n, m)."""
        c = self.config
        h_kv, d = c.kv_heads, c.head_dim
        n = q.shape[1]
        qg = q[0].reshape(n, h_kv, c.num_heads // h_kv, d).permute(1, 2, 0, 3)
        return torch.einsum("hgcd,hsd->hgcs", qg.float(),
                            keys.float()) * (1.0 / d ** 0.5)

    def _merge(self, ctx: torch.Tensor) -> torch.Tensor:
        """(h_kv, group, n, d) context → (1, n, h, d)."""
        n = ctx.shape[2]
        return ctx.permute(2, 0, 1, 3).reshape(1, n, self.config.num_heads,
                                               self.config.head_dim)

    @torch.no_grad()
    def _spec_verify_body(self, params, cache: Cache, tokens: torch.Tensor,
                          pos: int, drafted: torch.Tensor,
                          generator: Optional[torch.Generator]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chain round (``:505-555``): score ``tokens`` (1, k+1) — the
        pending token then the k drafts — at cache rows [pos, pos+k] in
        ONE multi-token step (each row's k/v written in place, each query
        attending keys [0, pos + i] with prefix-causal fp32 scores), then
        the verify kernel. Rows past the accepted frontier hold rejected
        drafts that the next round's lengths mask and its writes
        overwrite. Returns (accept_len (1,), next_token (1,))."""
        model, c = self.model, self.config
        K1 = tokens.shape[1]
        dev = tokens.device
        positions = pos + torch.arange(K1, device=dev)
        x = self._embed_at(params, tokens, positions)
        js = torch.arange(self.max_s, device=dev)
        mask = js[None, None, None, :] <= positions[None, None, :, None]
        for i, layer in enumerate(params["layers"]):
            h_in = fused_layer_norm(x, layer["ln1_w"], layer["ln1_b"],
                                    impl=self.impl)
            q, k, v = model._proj_qkv_bshd(layer, h_in)
            cache["k"][i, 0, :, pos:pos + K1] = k[0].transpose(0, 1)
            cache["v"][i, 0, :, pos:pos + K1] = v[0].transpose(0, 1)
            k_all, v_all = cache["k"][i, 0], cache["v"][i, 0]
            s = torch.where(mask, self._scores(q, k_all), NEG_INF)
            p = torch.softmax(s, dim=-1)
            ctx = torch.einsum("hgcs,hsd->hgcd", p.to(v_all.dtype), v_all)
            x = self._layer_tail(layer, x, self._merge(ctx))
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        logits = model.unembed(params, x)  # (1, K1, V)
        return fused_verify(logits, drafted, generator,
                            temperature=self.temperature, top_k=self.top_k,
                            impl=self.impl)

    @torch.no_grad()
    def _spec_tree_verify_body(self, params, cache: Cache,
                               tokens: torch.Tensor, pos: int,
                               parents: torch.Tensor, anc: torch.Tensor,
                               depth: int,
                               generator: Optional[torch.Generator]
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
        """One tree round (``:587-658``): score ``tokens`` (1, N+1) — the
        pending token (the root) and N drafted nodes at their depths'
        positions — in ONE forward: each node attends the committed cache
        rows [0, pos) and its own root path (``anc``) under one softmax.
        Then the tree verify kernel, and the winning path's k/v is
        committed to rows [pos, pos + depth] (levels past the accepted
        length write zeros, which the lengths mask). Returns (accept_len,
        j_star, next_token), each (1,)."""
        model, c = self.model, self.config
        N1 = tokens.shape[1]
        dev = tokens.device
        depth_vec = anc.to(torch.int32).sum(dim=-1) - 1  # (1, N1)
        positions = pos + depth_vec[0]
        x = self._embed_at(params, tokens, positions)
        js = torch.arange(self.max_s, device=dev)
        cache_mask = js < pos
        tree_mask = anc[0] != 0  # (N1 queries, N1 nodes)
        tks, tvs = [], []
        for i, layer in enumerate(params["layers"]):
            h_in = fused_layer_norm(x, layer["ln1_w"], layer["ln1_b"],
                                    impl=self.impl)
            q, k, v = model._proj_qkv_bshd(layer, h_in)  # (1, N1, h, d)
            tks.append(k)
            tvs.append(v)
            k_all, v_all = cache["k"][i, 0], cache["v"][i, 0]
            kt, vt = k[0].transpose(0, 1), v[0].transpose(0, 1)
            s_c = torch.where(cache_mask, self._scores(q, k_all), NEG_INF)
            s_t = torch.where(tree_mask, self._scores(q, kt), NEG_INF)
            p = torch.softmax(torch.cat([s_c, s_t], dim=-1), dim=-1)
            p_c, p_t = p[..., :self.max_s], p[..., self.max_s:]
            ctx = (torch.einsum("hgcs,hsd->hgcd", p_c.to(v_all.dtype), v_all)
                   + torch.einsum("hgcn,hnd->hgcd", p_t.to(vt.dtype), vt))
            x = self._layer_tail(layer, x, self._merge(ctx))
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        logits = model.unembed(params, x)  # (1, N1, V)
        a, j_star, nxt = fused_verify_tree(
            logits, tokens, parents, anc, generator,
            temperature=self.temperature, top_k=self.top_k, impl=self.impl)
        # level l of j_star's root path lands at row pos + l: a one-hot
        # (depth+1, N1) selection, all zeros past the accepted length
        onpath = anc[0].index_select(0, j_star.long())[0].float()  # (N1,)
        levels = torch.arange(depth + 1, device=dev)
        lvl = onpath[None] * (depth_vec == levels[:, None]).float()
        for i in range(c.num_layers):
            for name, t in (("k", tks[i]), ("v", tvs[i])):
                sel = torch.einsum("ln,nhd->hld", lvl.to(t.dtype), t[0])
                cache[name][i, 0, :, pos:pos + depth + 1] = sel
        return a, j_star, nxt

    # --- generation ----------------------------------------------------------

    @staticmethod
    def _check_batch1(prompt: torch.Tensor) -> None:
        if prompt.shape[0] != 1:
            raise ValueError(
                f"draft= speculative generation runs batch 1 (accepted "
                f"lengths diverge across rows, and the contiguous cache "
                f"carries one scalar position); got batch "
                f"{prompt.shape[0]} — split the batch")

    def _check_rows(self, prompt: torch.Tensor, max_new_tokens: int,
                    rows: int, what: str) -> None:
        s = prompt.shape[1]
        if s + max_new_tokens + rows - 1 > self.max_s:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) + "
                f"{what} ({rows}) - 1 exceeds the cache ({self.max_s}): a "
                f"spec round writes rows past the live frontier — raise "
                f"max_seq_len or lower the drafter's {what}")
        if s + max_new_tokens + rows - 1 > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) + "
                f"{what} ({rows}) - 1 steps past the model's position "
                f"table ({self.config.max_seq_len}); drafted rows hold "
                f"real positions too — lower the drafter's {what} or the "
                f"request")

    def _generate_spec(self, params, prompt: torch.Tensor,
                       max_new_tokens: int,
                       generator: Optional[torch.Generator],
                       draft) -> torch.Tensor:
        """The chain loop behind ``generate(draft=...)``."""
        from apex_tpu_torch.spec.drafter import validate_drafter

        self._check_batch1(prompt)
        self._refuse_rel_bias()
        s = prompt.shape[1]
        K = validate_drafter(draft, self.config,
                             needed_rows=s + max_new_tokens
                             + getattr(draft, "k", 1))
        self._check_rows(prompt, max_new_tokens, K, "draft.k")
        cache, tok, _ = self.prefill(params, prompt, generator=generator)
        stats = SpecStats()
        gen = [int(tok[0])]
        context = [int(t) for t in prompt[0].tolist()] + gen
        dev = self.device
        while len(gen) < max_new_tokens:
            drafted = np.asarray(draft.propose(0, context),
                                 np.int32).reshape(-1)
            if drafted.shape != (K,):
                raise ValueError(
                    f"drafter proposed {drafted.shape} tokens; the "
                    f"contract is exactly k={K} per round")
            pos = s + len(gen) - 1
            d_t = torch.as_tensor(drafted, device=dev)[None]
            tokens = torch.cat([torch.tensor([[gen[-1]]], dtype=torch.int32,
                                             device=dev), d_t], dim=1)
            a, nxt = self._spec_verify_step(params, cache, tokens, pos, d_t,
                                            generator)
            a = int(a[0])
            emitted = [int(t) for t in drafted[:a]] + [int(nxt[0])]
            gen.extend(emitted)
            context.extend(emitted)
            stats.rounds += 1
            stats.drafted += K
            stats.accepted += a
            stats.nodes += K
        draft.release(0)
        self.last_spec_stats = stats
        return torch.tensor([gen[:max_new_tokens]], dtype=torch.int32,
                            device=dev)

    def _generate_spec_tree(self, params, prompt: torch.Tensor,
                            max_new_tokens: int,
                            generator: Optional[torch.Generator],
                            draft, adaptive) -> torch.Tensor:
        """The tree loop behind ``generate(draft=<tree drafter>)``
        (``:663-756``); ``adaptive`` re-picks (depth, branching) per round
        from its choices."""
        from apex_tpu_torch.spec.drafter import validate_drafter
        from apex_tpu_torch.spec.tree import draft_tree

        self._check_batch1(prompt)
        self._refuse_rel_bias()
        s = prompt.shape[1]
        shapes = (adaptive.choices if adaptive is not None
                  else ((int(draft.depth), int(draft.branching)),))
        depth_max = max(dd for dd, _ in shapes)
        validate_drafter(draft, self.config,
                         needed_rows=s + max_new_tokens + depth_max)
        self._check_rows(prompt, max_new_tokens, depth_max, "tree depth")
        dev = self.device
        cache, tok, _ = self.prefill(params, prompt, generator=generator)
        stats = SpecStats()
        gen = [int(tok[0])]
        context = [int(t) for t in prompt[0].tolist()] + gen
        while len(gen) < max_new_tokens:
            depth, branching = (adaptive.choice(0) if adaptive is not None
                                else (int(draft.depth), int(draft.branching)))
            tree = draft_tree(branching, depth)
            node_tokens = np.asarray(
                draft.propose_tree(0, context, shape=(depth, branching)),
                np.int32).reshape(-1)
            if node_tokens.shape != (tree.num_nodes,):
                raise ValueError(
                    f"drafter proposed {node_tokens.shape} node tokens; the "
                    f"({branching}, {depth}) topology needs exactly "
                    f"{tree.num_nodes}")
            parents_np, anc_np = tree.operands(1)
            pos = s + len(gen) - 1
            tokens = torch.as_tensor(
                np.concatenate([[gen[-1]], node_tokens]).astype(np.int32),
                device=dev)[None]
            a, j_star, nxt = self._spec_tree_verify_step(
                params, cache, tokens, pos,
                torch.as_tensor(parents_np, device=dev),
                torch.as_tensor(anc_np, device=dev), depth, generator)
            a = int(a[0])
            emitted = tree.path_tokens(node_tokens, a, int(j_star[0]),
                                       int(nxt[0]))
            gen.extend(emitted)
            context.extend(emitted)
            stats.rounds += 1
            stats.drafted += depth
            stats.accepted += a
            stats.nodes += tree.num_nodes
            if adaptive is not None:
                adaptive.note_round(0, a, depth)
        draft.release(0)
        if adaptive is not None:
            adaptive.release(0)
        self.last_spec_stats = stats
        return torch.tensor([gen[:max_new_tokens]], dtype=torch.int32,
                            device=dev)

    def generate(self, params, prompt, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None,
                 draft=None, adaptive=None) -> torch.Tensor:
        """Greedy/sampled continuation: prompt (b, s) → generated tokens
        (b, max_new_tokens) int32 on the engine's device. ``generator``
        (on the engine's device) draws the sampling noise and is required
        when ``temperature > 0``. ``draft`` attaches a drafter for
        speculative decoding at batch 1 — a chain drafter
        (:class:`~apex_tpu_torch.spec.drafter.NGramDrafter`,
        :class:`~apex_tpu_torch.spec.drafter.ModelDrafter`) or a tree
        drafter (:class:`~apex_tpu_torch.spec.tree.NGramTreeDrafter`);
        acceptance is accounted in :attr:`last_spec_stats`. ``adaptive``
        (tree drafters only) attaches an
        :class:`~apex_tpu_torch.spec.tree.AdaptiveSpecController` that
        re-picks (depth, branching) per round from its choices."""
        prompt = torch.as_tensor(prompt, device=self.device)
        b, s = prompt.shape
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens} (the "
                f"prefill itself samples the first token)")
        if s + max_new_tokens > self.max_s:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the cache ({self.max_s})")
        if s + max_new_tokens - 1 > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) steps "
                f"past the model's position table "
                f"({self.config.max_seq_len}); the cache's 128-rounding "
                f"slack holds no positions")
        if self.temperature > 0 and generator is None:
            raise ValueError("temperature > 0 generation requires a "
                             "generator")
        # one trace id per generate() call: every span the loop emits
        # (decode_prefill, decode_step, spec_verify) joins to this call; an
        # already-ambient id (a caller's serve or step context) is reused
        tid = (monitor_trace.current_trace_id()
               or monitor_trace.new_trace_id("gen"))
        with monitor_trace.trace_context(tid):
            return self._generate(params, prompt, max_new_tokens, generator,
                                  draft, adaptive)

    def _generate(self, params, prompt: torch.Tensor, max_new_tokens: int,
                  generator: Optional[torch.Generator], draft,
                  adaptive) -> torch.Tensor:
        s = prompt.shape[1]
        if draft is not None:
            from apex_tpu_torch.spec.tree import is_tree_drafter
            if is_tree_drafter(draft):
                return self._generate_spec_tree(params, prompt,
                                                max_new_tokens, generator,
                                                draft, adaptive)
            if adaptive is not None:
                raise ValueError(
                    "adaptive= (k, b) selection needs a tree-capable "
                    "drafter (propose_tree + depth/branching); this "
                    "drafter only proposes chains — use "
                    "NGramTreeDrafter, or drop adaptive=")
            return self._generate_spec(params, prompt, max_new_tokens,
                                       generator, draft)
        if adaptive is not None:
            raise ValueError(
                "adaptive= requires draft= (there is no draft shape to "
                "adapt without a drafter)")
        cache, tok, _ = self.prefill(params, prompt, generator=generator)
        out = [tok]
        for t in range(1, max_new_tokens):
            cache, tok, _ = self.decode_step(params, cache, tok, s + t - 1,
                                             generator=generator)
            out.append(tok)
        return torch.stack(out, dim=1)



def jit_encoder(model, *, with_pooler: bool = True,
                device: Optional[Union[str, torch.device]] = None
                ) -> Callable:
    """BERT-style encoder serving (``engine.py:915-934``): encoders have no
    autoregressive structure, so the serving entry is the model's own
    forward. Returns ``encode(params, tokens, token_types=None,
    pad_mask=None)`` → (hidden (b, s, H), pooled (b, H) or None), run
    eagerly under ``torch.inference_mode()`` (no autograd state, nothing
    compiled: the name is the reference's). As the reference says, pad
    every request batch to a few fixed (b, s) buckets and pass
    ``pad_mask`` (True = padding): the kernels then see the same shapes
    call after call.

    ``device`` defaults to the card and raises without one; the CPU runs
    the plain versions only when asked (``device="cpu"``). ``params`` must
    live on that device (``tokens`` and the masks are moved to it)."""
    dev = _backend.resolve_device(device)

    @torch.inference_mode()
    def encode(params, tokens, token_types=None, pad_mask=None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        pdev = params["embedding"]["weight"].device
        if pdev.type != dev.type or (dev.index is not None
                                     and pdev.index != dev.index):
            raise ValueError(
                f"jit_encoder runs on {dev}, but the params live on {pdev} "
                f"— build the encoder with device={str(pdev)!r} or move "
                f"the params")

        def on_dev(x):
            return None if x is None else torch.as_tensor(x, device=pdev)

        hidden = model.hidden_states(params, on_dev(tokens),
                                     token_types=on_dev(token_types),
                                     pad_mask=on_dev(pad_mask))
        pooled = model.pooled(params, hidden) if with_pooler else None
        return hidden, pooled

    return encode
