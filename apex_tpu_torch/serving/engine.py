"""ServingEngine: continuous-batching generation over a paged KV cache.

Port of ``apex_tpu/serving/engine.py`` at tp=1, with a float pool or a
quantized one (``kv_dtype="int8"`` / ``"fp8_e4m3"``: 1-byte cells and one
fp32 scale a block row, :func:`_quant_rows` at every write site, the
decode kernel's quantized instances and dequantizing gathers at every
read). Its device steps, run eagerly:

* :meth:`ServingEngine.prefill_chunk` — one fixed-size chunk of ONE slot's
  prompt through the stack: the chunk's k/v land in the slot's pool blocks
  (blocks with no live token are redirected to the dead block, so a ragged
  final chunk never touches another slot's memory), attention runs the
  chunk's queries against the slot's gathered cache under the
  prefix-causal mask ``key_pos <= start + i`` (a plain einsum, as in the
  reference), and the chunk's last live row samples a token.
* :meth:`ServingEngine.decode_step` — one token for EVERY slot at once:
  per-slot cache writes resolve ``(block, row)`` through the table (dead
  slots write the dead block), attention is the paged
  :func:`~apex_tpu_torch.ops.decode_attention.decode_attention` (the CUDA
  kernel on the card), and the fused sampling tail
  (:func:`~apex_tpu_torch.ops.sampling.fused_sample`, the CUDA kernel when
  ``temperature > 0``) turns logits into tokens.
* :meth:`ServingEngine.spec_step` — the chain speculative round
  (``serve(draft=...)``): every decoding slot's pending token and its k
  drafts scored in one k+1-wide forward (their k/v scattered into the
  pool first, past the live frontier; attention as the prefill chunk's,
  prefix-causal over the gathered cache), then the verify kernel
  (:func:`~apex_tpu_torch.ops.fused_verify.fused_verify`) emits each
  slot's accepted length and next token; the scheduler rewinds the
  reservation to the accepted frontier.
* :meth:`ServingEngine.spec_tree_step` — the tree round: each node
  attends the committed cache rows and its own root path under one
  softmax, the tree verify kernel picks the deepest accepted path, and
  only that path's k/v is written to the pool.

``serve(draft=..., adaptive=...)`` degrades tree → chain → plain per round
on row headroom and on the drafter's pool headroom; a
:class:`~apex_tpu_torch.spec.tree.PagedModelDrafter` takes its KV blocks
from this serve's own allocator.

The pool is updated IN PLACE — the port's analog of the reference's pool
donation: a step's memory traffic is the live cache read plus one token's
writes, never a pool copy. Everything dynamic about traffic stays in the
host-side :class:`~apex_tpu_torch.serving.scheduler.Scheduler`.

A model's ``decode_rel_bias(params)`` hook (a causal BucketedBias, T5's
relative positions at decode) reaches every decode step's kernel, as the
reference's (``:647-674``); a quantized pool and ``serve(draft=)`` refuse
such a model, as the reference does.

``serve(telemetry=)`` attaches a :class:`~apex_tpu_torch.serving.telemetry.
ServeTelemetry` (lifecycle records, windows, the anomaly layer; one is
auto-attached while the monitor registry is enabled), and every step runs
inside its ``serve_prefill`` / ``serve_decode`` / ``serve_spec`` /
``serve_spec_tree`` span. :meth:`ServingEngine.request_swap` hot-swaps the
weights between dispatch steps: a contents-only replacement of the params
tree (same keys, shapes, dtypes and device), to which the engine rebinds;
the pool and every in-flight request stay.

Not ported yet (a caller asking for them gets an error):
tensor-parallel serving (``plan.tp > 1``), the reference's
``ReplanPolicy`` and ``serve(pool=)`` (the disaggregated decode role).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTModel
from apex_tpu_torch.monitor import registry as monitor_registry
from apex_tpu_torch.monitor import spans as monitor_spans
from apex_tpu_torch.monitor import trace as monitor_trace
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.decode_attention import NEG_INF
from apex_tpu_torch.ops.fused_verify import fused_verify, fused_verify_tree
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.sampling import fused_sample
from apex_tpu_torch.serving.kv_blocks import (DEAD_BLOCK, BlockAllocator,
                                              PrefixCache)
from apex_tpu_torch.serving.scheduler import Request, Scheduler, SLOPolicy
from apex_tpu_torch.serving.telemetry import ServeTelemetry
from apex_tpu_torch.utils.pytree import tree_paths

Pool = Dict[str, torch.Tensor]

#: legal kv_dtype values and their (qmax, storage dtype): int8 rounds into
#: [-127, 127]; fp8_e4m3 keeps a mantissa and scales amax onto the
#: format's finite ceiling (448) — the same per-block-row fp32 scale
#: planes, the same 1 byte a cell, so the two pools share every write and
#: gather site (``:82-88``)
KV_QUANT_SPECS = {
    "int8": (127.0, torch.int8),
    "fp8_e4m3": (448.0, torch.float8_e4m3fn),
}


def _quant_rows(x: torch.Tensor, dims: Tuple[int, ...], *,
                qmax: float = 127.0, qdtype: torch.dtype = torch.int8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization (``:92-109``): one fp32 scale a row,
    ``dims`` reduced away (the kv heads and head_dim share it: the write
    sites land one token row at a time). An integer target rounds half to
    even into [-qmax, qmax]; fp8 clips at qmax and casts (round to nearest
    even). The 1e-20 floor keeps an all-zero row's scale finite (dead-block
    writes, padding): it dequantizes back to exact zeros. Returns (cells,
    scales)."""
    xf = x.float()
    scale = xf.abs().amax(dim=dims, keepdim=True).clamp_min(1e-20) / qmax
    y = xf / scale
    if qdtype.is_floating_point:
        q = y.clamp(-qmax, qmax).to(qdtype)
    else:
        q = torch.round(y).clamp(-qmax, qmax).to(qdtype)
    return q, scale.squeeze(dims)


@dataclasses.dataclass
class ServeStats:
    """Host-side accounting of one :meth:`ServingEngine.serve` call.
    ``prefill_s``/``decode_s`` sum the host time of the dispatches (spec
    rounds among the decode dispatches), each ending in the device→host
    copy of its tokens; ``draft_s`` the drafter's proposals.

    Speculative rounds (``serve(draft=...)``, as the reference's
    ``:112-160``): ``spec_rounds`` counts round dispatches (each also a
    ``decode_steps``), ``tree_rounds`` the tree ones; ``spec_drafted``
    the drafted DEPTH rows per live slot (k for a chain round, depth for
    a tree round), ``spec_accepted`` the accepted ones, ``spec_nodes``
    the drafted verify rows scored, ``spec_slot_rounds`` the live slots
    over all rounds, ``spec_degraded`` the rounds the tree → chain →
    plain ladder stepped down. ``swaps`` counts the weight hot-swaps
    applied (:meth:`ServingEngine.request_swap`)."""

    decode_steps: int = 0
    prefill_chunks: int = 0
    blocks_high_water: int = 0
    swaps: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    draft_s: float = 0.0
    spec_rounds: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    tree_rounds: int = 0
    spec_nodes: int = 0
    spec_degraded: int = 0
    spec_slot_rounds: int = 0

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted drafts / drafted rows (0.0 before any round)."""
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)

    @property
    def spec_efficiency(self) -> float:
        """Emitted tokens per verify row scored (each slot-round scores
        ``nodes + 1`` rows and emits ``accepted + 1`` tokens); 0.0 before
        any round."""
        rows = self.spec_nodes + self.spec_slot_rounds
        return ((self.spec_accepted + self.spec_slot_rounds) / rows
                if rows else 0.0)


class ServingEngine:
    """Continuous-batching serving over a :class:`GPTModel`.

    ``engine = ServingEngine(model, num_slots=8, block_size=128)``;
    ``results = engine.serve(params, requests)`` — each
    :class:`~apex_tpu_torch.serving.scheduler.Request` comes back with its
    generated tokens and latency stamps. Knobs as in the reference:
    ``num_slots`` (decode batch width), ``block_size`` (each slot holds
    the position table rounded down to it), ``num_blocks`` (pool capacity
    + 1 dead block; default full capacity),
    ``prefill_chunk`` (a ``block_size`` multiple), and the sampling tail's
    ``temperature``/``top_k``/``top_p`` (greedy at ``temperature == 0``).

    ``device`` defaults to the card and raises without one; the CPU runs
    the plain versions only when asked (``device="cpu"``). ``impl="torch"``
    runs the plain versions on the card too — for holding the kernels
    against them, never a default.
    """

    def __init__(self, model: GPTModel, *, num_slots: int,
                 block_size: int = 128, num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_dtype: Optional[str] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, plan=None,
                 device: Optional[Union[str, torch.device]] = None,
                 impl: str = "auto"):
        # quantized pools: 1 byte a cell instead of 2, halving the bytes the
        # decode kernel streams and doubling the live tokens a pool holds;
        # validated here, naming the knob (:218-231)
        if kv_dtype not in (None, *KV_QUANT_SPECS):
            legal = ", ".join(repr(k) for k in KV_QUANT_SPECS)
            raise ValueError(
                f"kv_dtype must be None (the float pool, in the model's "
                f"dtype) or one of {legal} (per-block-row scales, "
                f"dequantized in-kernel); got {kv_dtype!r}")
        if kv_dtype is not None \
                and getattr(model, "decode_rel_bias", None) is not None:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} cannot serve a model with a decode "
                f"relative-position bias (the quantized paged kernel path "
                f"does not carry the bucketed bias) — serve this model "
                f"with the float pool (kv_dtype=None)")
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype is not None
        self._qmax, self._qdtype = KV_QUANT_SPECS.get(kv_dtype, (None, None))
        if plan is not None and int(getattr(plan, "tp", 1)) > 1:
            raise NotImplementedError(
                "tensor-parallel serving (plan.tp > 1) is a later slice of "
                "the port")
        if impl not in _backend.IMPLS:
            raise ValueError(f"impl must be one of {_backend.IMPLS}, got "
                             f"{impl!r}")
        self.device = _backend.resolve_device(device)
        self.impl = impl
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        kernels = impl == "auto"
        model.check_paged_decode_supported(
            self.device, block_size, quantized=self.quantized and kernels,
            rel=kernels and getattr(model, "decode_rel_bias",
                                    None) is not None)
        self.model = model
        c = self.config = model.config
        self.block_size = int(block_size)
        max_s = c.max_seq_len - c.max_seq_len % self.block_size
        if max_s < self.block_size:
            raise ValueError(
                f"block_size ({self.block_size}) exceeds the model's "
                f"position table ({c.max_seq_len})")
        self.max_s = max_s
        self.max_blocks_per_slot = max_s // self.block_size
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        full = self.num_slots * self.max_blocks_per_slot + 1
        self.num_blocks = int(num_blocks if num_blocks is not None else full)
        self.prefill_chunk_size = int(
            prefill_chunk if prefill_chunk is not None else self.block_size)
        if (self.prefill_chunk_size < self.block_size
                or self.prefill_chunk_size % self.block_size):
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk_size}) must be a "
                f"positive multiple of block_size ({self.block_size})")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.last_stats: Optional[ServeStats] = None
        # the last serve's final pool, as the reference keeps it (:320-322)
        self.last_pool: Optional[Pool] = None
        # (at_step, new params, source) of a queued hot-swap
        self._pending_swap: Optional[tuple] = None

    # --- pool ----------------------------------------------------------------

    def init_pool(self) -> Pool:
        """The zeroed block pool ``{"k"/"v": (layers, num_blocks,
        kv_heads, block_size, head_dim)}`` on the engine's device — block
        0 is the dead block (see kv_blocks). Cells are in the model's
        parameter dtype; under a quantized ``kv_dtype`` they are 1-byte
        and ``k_scale``/``v_scale`` ``(layers, num_blocks, block_size)``
        fp32 ride alongside (``:345-369``)."""
        c = self.config
        shape = (c.num_layers, self.num_blocks, c.kv_heads,
                 self.block_size, c.head_dim)
        dtype = self._qdtype if self.quantized else c.dtype
        pool = {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name in ("k", "v")}
        if self.quantized:
            for name in ("k_scale", "v_scale"):
                pool[name] = torch.zeros(shape[:2] + shape[3:4],
                                         dtype=torch.float32,
                                         device=self.device)
        return pool

    def pool_bytes(self) -> int:
        """Device footprint of the whole pool (k and v, plus the scale
        planes of a quantized pool)."""
        c = self.config
        cells = (c.num_layers * self.num_blocks * c.kv_heads
                 * self.block_size * c.head_dim)
        if self.quantized:
            scales = c.num_layers * self.num_blocks * self.block_size
            return 2 * cells + 2 * scales * 4
        return 2 * cells * torch.empty((), dtype=c.dtype).element_size()

    # --- the pool's writes and gathers ---------------------------------------

    def _write_rows(self, pool: Pool, i: int, bid: torch.Tensor,
                    row: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Layer i's token rows k/v (bid.shape + (h_kv, d)) into pool
        blocks ``bid`` at rows ``row``, in place; a quantized pool takes
        the cells and each row's scale at the same ids, so the dead-block
        redirect covers the scale planes too."""
        for name, x in (("k", k), ("v", v)):
            if self.quantized:
                xq, xs = _quant_rows(x, (-2, -1), qmax=self._qmax,
                                     qdtype=self._qdtype)
                pool[name][i][bid, :, row] = xq
                pool[name + "_scale"][i][bid, row] = xs
            else:
                pool[name][i][bid, :, row] = x.to(pool[name].dtype)

    def _gather_cache(self, pool: Pool, name: str, i: int,
                      tables: torch.Tensor, dtype: torch.dtype
                      ) -> torch.Tensor:
        """Layer i's ``name`` pool gathered through the tables (S, nb) into
        each slot's padded cache (S, h_kv, max_s, d). A quantized pool's
        cells dequantize in fp32 (cell × its row's scale); its keys are
        then rounded to ``dtype`` (the queries'), its values stay fp32, as
        the reference's gathers (``:581-590``, ``:754-760``)."""
        c = self.config
        S = tables.shape[0]
        g = pool[name][i][tables]  # (S, nb, h_kv, B, d)
        if self.quantized:
            g = g.float() * pool[name + "_scale"][i][tables][:, :, None, :,
                                                             None]
            if name == "k":
                g = g.to(dtype)
        return g.transpose(1, 2).reshape(S, c.kv_heads, self.max_s,
                                         c.head_dim)

    # --- weight hot-swap -----------------------------------------------------

    @staticmethod
    def _validate_swap_avals(old, new) -> None:
        """The hot-swap contract (``engine.py:407-437``): the new tree is a
        contents-only replacement — the same keys, and per leaf the same
        shape, dtype and device. Every mismatch names its leaf path
        eagerly, before a step could run on a tree the steps were not
        written for."""
        old_paths, new_paths = tree_paths(old), tree_paths(new)
        ok = [p for p, _ in old_paths]
        nk = [p for p, _ in new_paths]
        if ok != nk:
            extra = sorted(set(nk) - set(ok))
            missing = sorted(set(ok) - set(nk))
            raise ValueError(
                f"hot-swap params tree mismatch: new tree "
                f"{'adds ' + str(extra) if extra else ''}"
                f"{' and ' if extra and missing else ''}"
                f"{'drops ' + str(missing) if missing else ''}"
                f"{'' if extra or missing else 'has a different structure'}"
                f" — a swap is contents-only (same model, new weights)")
        for (path, a), (_, b) in zip(old_paths, new_paths):
            ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
            if ta != tb or (ta and (a.shape != b.shape or a.dtype != b.dtype
                                    or a.device != b.device)):
                desc = (lambda x: f"{tuple(x.shape)}/{x.dtype}/{x.device}"
                        if isinstance(x, torch.Tensor) else type(x).__name__)
                raise ValueError(
                    f"hot-swap aval mismatch at {path}: serving {desc(a)}, "
                    f"new params {desc(b)} — a swap must keep every leaf's "
                    f"shape, dtype and device")

    def request_swap(self, new_params, *, at_step: Optional[int] = None,
                     source: Optional[str] = None) -> None:
        """Queue a weight hot-swap for the live serve loop
        (``engine.py:439-463``): the NEXT loop iteration whose dispatch
        counter has reached ``at_step`` (immediately when ``None``)
        replaces the params BETWEEN dispatch steps — in-flight requests
        keep their KV cache and finish against the new weights. The tree is
        validated against the live params at apply time (an eager,
        leaf-naming ``ValueError``); ``source`` labels the ``swap``
        lifecycle event. The engine rebinds to ``new_params``' tensors: the
        caller's old tensors are never written, and the pool stays.

        One swap is pending at a time (a newer request replaces an
        unapplied one), and an unapplied swap does NOT outlive the serve
        call: if ``at_step`` is never reached it is dropped when ``serve``
        returns or raises (``last_stats.swaps == 0`` is the tell)."""
        self._pending_swap = (at_step, new_params, source)

    def _maybe_swap(self, params, nstep: int, tel, stats: ServeStats,
                    now: float):
        if self._pending_swap is None:
            return params
        at_step, new_params, source = self._pending_swap
        if at_step is not None and nstep < at_step:
            return params
        self._pending_swap = None
        t0 = time.perf_counter()
        self._validate_swap_avals(params, new_params)
        stats.swaps += 1
        if tel is not None:
            # the measured validate+rebind pause: attribution carves it out
            # of the decode time of every mid-decode request
            tel.on_swap(nstep, now, source=source,
                        dur_ms=(time.perf_counter() - t0) * 1e3)
        return new_params

    # --- sampling tail -------------------------------------------------------

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        return fused_sample(logits, temperature=self.temperature,
                            top_k=self.top_k, top_p=self.top_p,
                            generator=generator, impl=self.impl)

    # --- prefill chunk -------------------------------------------------------

    def prefill_chunk(self, params, pool: Pool, table_row: torch.Tensor,
                      tokens: torch.Tensor, start: int, live: int,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk of ONE slot's prompt: ``tokens`` (C,) are prompt
        positions [start, start+C) with the first ``live`` valid. Writes
        the chunk's k/v into ``pool`` in place and returns
        ``(token, last_logits)`` — meaningful on the prompt's LAST chunk
        (row ``live - 1`` is then its final token). Runs inside the
        ``serve_prefill`` span."""
        with monitor_spans.span("serve_prefill"):
            return self._prefill_chunk_body(params, pool, table_row, tokens,
                                            start, live, generator)

    @torch.no_grad()
    def _prefill_chunk_body(self, params, pool: Pool,
                            table_row: torch.Tensor, tokens: torch.Tensor,
                            start: int, live: int,
                            generator: Optional[torch.Generator]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        model, c = self.model, self.config
        C, B = self.prefill_chunk_size, self.block_size
        nb, max_s = self.max_blocks_per_slot, self.max_s
        h_kv, d = c.kv_heads, c.head_dim
        group = c.num_heads // h_kv
        dev = self.device

        x = model.embedding(params["embedding"], tokens[None])  # (1, C, H)
        pos = start + torch.arange(C, device=dev)
        ptab = params["pos_embedding"]
        x = x + ptab[pos.clamp_max(ptab.shape[0] - 1)][None]

        # the chunk's target blocks: C/B table entries from start/B on;
        # blocks with no live token redirect to the dead block. The start
        # index is CLAMPED so the C/B entries fit in the row, exactly as
        # the reference's lax.dynamic_slice clamps it (engine.py:543-544)
        nblk = C // B
        first = min(max(start // B, 0), nb - nblk)
        ids = table_row[first:first + nblk].long()
        blk_live = torch.arange(nblk, device=dev) * B < live
        ids = torch.where(blk_live, ids, DEAD_BLOCK)

        scale = 1.0 / d ** 0.5
        js = torch.arange(max_s, device=dev)
        mask = js[None, None, None, :] <= pos[None, None, :, None]
        rows = table_row.long()
        bids = ids[:, None].expand(nblk, B)
        brows = torch.arange(B, device=dev)[None, :].expand(nblk, B)
        for i, layer in enumerate(params["layers"]):
            h_in = fused_layer_norm(x, layer["ln1_w"], layer["ln1_b"],
                                    impl=self.impl)
            q, k, v = model._proj_qkv_bshd(layer, h_in)
            # chunk k/v → (C/B, B) rows of blocks at the ids
            self._write_rows(pool, i, bids, brows,
                             k[0].reshape(nblk, B, h_kv, d),
                             v[0].reshape(nblk, B, h_kv, d))
            # chunk queries × the slot's gathered padded cache (the chunk's
            # own rows included — causal within the chunk falls out of the
            # same mask); scores in fp32, p cast to v's dtype for PV (fp32
            # from a quantized pool, whose context is then cast back)
            k_all = self._gather_cache(pool, "k", i, rows[None], q.dtype)[0]
            v_all = self._gather_cache(pool, "v", i, rows[None], q.dtype)[0]
            qg = q[0].reshape(C, h_kv, group, d).permute(1, 2, 0, 3)
            s = torch.einsum("hgcd,hsd->hgcs", qg.float(),
                             k_all.float()) * scale
            s = torch.where(mask, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            ctx = torch.einsum("hgcs,hsd->hgcd", p.to(v_all.dtype), v_all)
            ctx = ctx.permute(2, 0, 1, 3).reshape(1, C, c.num_heads, d).to(
                q.dtype)
            x = x + model._proj_attn_out(layer, ctx)
            x = x + model._mlp(layer, fused_layer_norm(
                x, layer["ln2_w"], layer["ln2_b"], impl=self.impl))
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        last = x[:, live - 1:live]
        logits = model.unembed(params, last)[:, 0]  # (1, V)
        return self._sample(logits, generator)[0], logits[0]

    # --- decode step ---------------------------------------------------------

    def decode_step(self, params, pool: Pool, tables: torch.Tensor,
                    tokens: torch.Tensor, lengths: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One token for EVERY slot: ``tokens`` (S,) each slot's incoming
        token, ``lengths`` (S,) live rows INCLUDING it (0 = dead slot: its
        write lands in the dead block, its output is ignored). Writes the
        pool in place; returns ``(next_tokens, logits)``. Runs inside the
        ``serve_decode`` span."""
        with monitor_spans.span("serve_decode"):
            return self._decode_step_body(params, pool, tables, tokens,
                                          lengths, generator)

    @torch.no_grad()
    def _decode_step_body(self, params, pool: Pool, tables: torch.Tensor,
                          tokens: torch.Tensor, lengths: torch.Tensor,
                          generator: Optional[torch.Generator]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        model = self.model
        B = self.block_size
        lengths = lengths.to(torch.int32)
        pos = (lengths - 1).clamp_min(0).long()  # the incoming position
        x = model.embedding(params["embedding"], tokens[:, None])
        ptab = params["pos_embedding"]
        x = x + ptab[pos.clamp_max(ptab.shape[0] - 1)][:, None]
        tables = tables.to(torch.int32)
        bid = tables.gather(1, (pos // B)[:, None])[:, 0].long()
        # dead slots write to the dead block NO MATTER what their table
        # row says: a slot mid-prefill is dead for decode but its table
        # already names real blocks
        bid = torch.where(lengths > 0, bid, DEAD_BLOCK)
        row = pos % B
        hook = getattr(model, "decode_rel_bias", None)
        rel_bias = None if hook is None else hook(params)
        for i, layer in enumerate(params["layers"]):
            q, k_row, v_row = model.decode_qkv(layer, x, self.impl)
            self._write_rows(pool, i, bid, row, k_row[:, :, 0],
                             v_row[:, :, 0])
            scales = ((pool["k_scale"][i], pool["v_scale"][i])
                      if self.quantized else None)
            x = model.decode_block(layer, x, q, pool["k"][i], pool["v"][i],
                                   lengths, rel_bias=rel_bias,
                                   block_tables=tables, kv_scales=scales,
                                   impl=self.impl)
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        logits = model.unembed(params, x)[:, 0]  # (S, V)
        return self._sample(logits, generator), logits

    # --- speculative rounds --------------------------------------------------

    def _heads(self, q: torch.Tensor) -> torch.Tensor:
        """(S, n, h, d) queries → (S, h_kv, group, n, d)."""
        c = self.config
        S, n = q.shape[:2]
        return q.reshape(S, n, c.kv_heads, c.num_heads // c.kv_heads,
                         c.head_dim).permute(0, 2, 3, 1, 4)

    def _merge_heads(self, ctx: torch.Tensor) -> torch.Tensor:
        """(S, h_kv, group, n, d) context → (S, n, h, d)."""
        S, n = ctx.shape[0], ctx.shape[3]
        c = self.config
        return ctx.permute(0, 3, 1, 2, 4).reshape(S, n, c.num_heads,
                                                  c.head_dim)

    def spec_step(self, params, pool: Pool, tables: torch.Tensor,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  drafted: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One CHAIN speculative round for EVERY slot at once
        (``engine.py:693-784``): ``tokens`` (S, k+1) are each slot's
        pending token followed by its k drafts, ``lengths`` (S,) the live
        rows INCLUDING the pending token (0 = dead slot: its writes land
        in the dead block, its outputs are ignored), ``drafted`` (S, k).
        The k+1 rows' k/v land in the slots' pool blocks past the live
        frontier (the scheduler reserved them), row j of slot i attends
        keys [0, base_i + j] of the gathered cache, and the verify kernel
        emits ``(accept_len (S,), next_token (S,))``. Rows past the
        accepted frontier hold rejected drafts: the scheduler rewinds.
        Runs inside the ``serve_spec`` span."""
        with monitor_spans.span("serve_spec"):
            return self._spec_step_body(params, pool, tables, tokens,
                                        lengths, drafted, generator)

    @torch.no_grad()
    def _spec_step_body(self, params, pool: Pool, tables: torch.Tensor,
                        tokens: torch.Tensor, lengths: torch.Tensor,
                        drafted: torch.Tensor,
                        generator: Optional[torch.Generator]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        model, c = self.model, self.config
        B = self.block_size
        S, K1 = tokens.shape
        dev = self.device
        lengths = lengths.to(torch.int32)
        base = (lengths - 1).clamp_min(0).long()
        pos = base[:, None] + torch.arange(K1, device=dev)[None, :]
        x = model.embedding(params["embedding"], tokens)  # (S, K1, H)
        ptab = params["pos_embedding"]
        x = x + ptab[pos.clamp_max(ptab.shape[0] - 1)]
        tables = tables.long()
        bid = tables.gather(1, pos // B)
        # dead slots write to the dead block NO MATTER what their table
        # row says (the decode step's redirect)
        bid = torch.where(lengths[:, None] > 0, bid, DEAD_BLOCK)
        row = pos % B
        scale = 1.0 / c.head_dim ** 0.5
        js = torch.arange(self.max_s, device=dev)
        # prefix-causal: row j of slot i sees keys [0, base_i + j]
        mask = js[None, None, None, None, :] <= pos[:, None, None, :, None]
        for i, layer in enumerate(params["layers"]):
            h_in = fused_layer_norm(x, layer["ln1_w"], layer["ln1_b"],
                                    impl=self.impl)
            q, k, v = model._proj_qkv_bshd(layer, h_in)  # (S, K1, h, d)
            self._write_rows(pool, i, bid, row, k, v)
            k_all = self._gather_cache(pool, "k", i, tables, q.dtype)
            v_all = self._gather_cache(pool, "v", i, tables, q.dtype)
            sc = torch.einsum("bhgcd,bhsd->bhgcs", self._heads(q).float(),
                              k_all.float()) * scale
            p = torch.softmax(torch.where(mask, sc, NEG_INF), dim=-1)
            ctx = torch.einsum("bhgcs,bhsd->bhgcd", p.to(v_all.dtype), v_all)
            x = x + model._proj_attn_out(layer, self._merge_heads(ctx).to(
                q.dtype))
            x = x + model._mlp(layer, fused_layer_norm(
                x, layer["ln2_w"], layer["ln2_b"], impl=self.impl))
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        logits = model.unembed(params, x)  # (S, K1, V)
        return fused_verify(logits, drafted, generator,
                            temperature=self.temperature, top_k=self.top_k,
                            top_p=self.top_p, impl=self.impl)

    def spec_tree_step(self, params, pool: Pool, tables: torch.Tensor,
                       tokens: torch.Tensor, lengths: torch.Tensor,
                       parents: torch.Tensor, anc: torch.Tensor, depth: int,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One TREE speculative round for EVERY slot at once
        (``engine.py:795-921``): ``tokens`` (S, N+1) are each slot's
        pending token (the root) and its N drafted nodes, ``parents``
        (S, N+1) and ``anc`` (S, N+1, N+1) the topology tiled over the
        slots, ``depth`` its depth. Nothing is written before the verdict
        (siblings share positions): each node attends the committed rows
        (``js < base``) and its own root path under ONE softmax, the tree
        verify kernel picks the deepest accepted path, and only that
        path's k/v lands in the pool (level l at row base + l; levels past
        the accepted length, and dead slots, go to the dead block).
        Returns ``(accept_len, j_star, next_token)``, each (S,). Runs
        inside the ``serve_spec_tree`` span."""
        with monitor_spans.span("serve_spec_tree"):
            return self._spec_tree_step_body(params, pool, tables, tokens,
                                             lengths, parents, anc, depth,
                                             generator)

    @torch.no_grad()
    def _spec_tree_step_body(self, params, pool: Pool, tables: torch.Tensor,
                             tokens: torch.Tensor, lengths: torch.Tensor,
                             parents: torch.Tensor, anc: torch.Tensor,
                             depth: int,
                             generator: Optional[torch.Generator]
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        model, c = self.model, self.config
        B = self.block_size
        S, N1 = tokens.shape
        dev = self.device
        lengths = lengths.to(torch.int32)
        base = (lengths - 1).clamp_min(0).long()
        anc = anc.to(torch.int32)
        depth_vec = (anc.sum(dim=-1) - 1).long()  # (S, N1)
        positions = base[:, None] + depth_vec  # siblings share positions
        x = model.embedding(params["embedding"], tokens)  # (S, N1, H)
        ptab = params["pos_embedding"]
        x = x + ptab[positions.clamp_max(ptab.shape[0] - 1)]
        tables = tables.long()
        scale = 1.0 / c.head_dim ** 0.5
        js = torch.arange(self.max_s, device=dev)
        # committed rows only: the root's own k/v rides the tree part
        cache_mask = js[None, None, None, None, :] \
            < base[:, None, None, None, None]
        tree_mask = (anc != 0)[:, None, None]  # (S, 1, 1, N1, N1)
        tks, tvs = [], []
        for i, layer in enumerate(params["layers"]):
            h_in = fused_layer_norm(x, layer["ln1_w"], layer["ln1_b"],
                                    impl=self.impl)
            q, k, v = model._proj_qkv_bshd(layer, h_in)  # (S, N1, h, d)
            tks.append(k)
            tvs.append(v)
            k_all = self._gather_cache(pool, "k", i, tables, q.dtype)
            v_all = self._gather_cache(pool, "v", i, tables, q.dtype)
            qg = self._heads(q).float()
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # (S, h, N1, d)
            s_c = torch.einsum("bhgcd,bhsd->bhgcs", qg, k_all.float()) * scale
            s_t = torch.einsum("bhgcd,bhnd->bhgcn", qg, kt.float()) * scale
            # ONE softmax across cache and tree keys
            p = torch.softmax(torch.cat(
                [torch.where(cache_mask, s_c, NEG_INF),
                 torch.where(tree_mask, s_t, NEG_INF)], dim=-1), dim=-1)
            p_c, p_t = p[..., :self.max_s], p[..., self.max_s:]
            ctx = (torch.einsum("bhgcs,bhsd->bhgcd", p_c.to(v_all.dtype),
                                v_all)
                   + torch.einsum("bhgcn,bhnd->bhgcd", p_t.to(vt.dtype), vt))
            x = x + model._proj_attn_out(layer, self._merge_heads(ctx).to(
                q.dtype))
            x = x + model._mlp(layer, fused_layer_norm(
                x, layer["ln2_w"], layer["ln2_b"], impl=self.impl))
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        logits = model.unembed(params, x)  # (S, N1, V)
        a, j_star, nxt = fused_verify_tree(
            logits, tokens, parents, anc, generator,
            temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, impl=self.impl)
        # the winning path: the node of j_star's root path at each level l
        # (root = level 0 = the pending token) lands at pool row base + l
        levels = torch.arange(depth + 1, device=dev)
        onpath = anc.gather(1, j_star.long()[:, None, None].expand(
            S, 1, N1))[:, 0] != 0  # (S, N1)
        at_level = onpath[:, None, :] \
            & (depth_vec[:, None, :] == levels[None, :, None])
        node = (at_level.long()
                * torch.arange(N1, device=dev)).sum(dim=-1)  # (S, depth+1)
        wpos = base[:, None] + levels[None, :]
        valid = (levels[None, :] <= a[:, None].long()) \
            & (lengths[:, None] > 0)
        bid = torch.where(valid, tables.gather(1, wpos // B), DEAD_BLOCK)
        row = wpos % B
        pick = node[:, :, None, None].expand(S, depth + 1, c.kv_heads,
                                             c.head_dim)
        for i in range(c.num_layers):
            self._write_rows(pool, i, bid, row, tks[i].gather(1, pick),
                             tvs[i].gather(1, pick))
        return a, j_star, nxt

    # --- the serving loop ----------------------------------------------------

    def make_scheduler(self) -> Scheduler:
        """A fresh scheduler + allocator matching this engine's pool, with
        a :class:`~apex_tpu_torch.serving.kv_blocks.PrefixCache` over the
        same allocator and a default
        :class:`~apex_tpu_torch.serving.scheduler.SLOPolicy`, which an
        attached telemetry drives."""
        alloc = BlockAllocator(self.num_blocks)
        return Scheduler(
            num_slots=self.num_slots, block_size=self.block_size,
            max_blocks_per_slot=self.max_blocks_per_slot,
            allocator=alloc, prefill_chunk=self.prefill_chunk_size,
            prefix_cache=PrefixCache(alloc, self.block_size),
            policy=SLOPolicy())

    def _attach_telemetry(self, telemetry, sched: Scheduler):
        """The serve's tracker (``engine.py:1346-1377``): ``False`` detaches
        even a tracker the scheduler carries; ``None`` adopts the
        scheduler's, else auto-attaches one while the monitor registry is
        enabled — claiming OK only on the card, SKIP with the device named
        elsewhere. An explicit OK tracker on a serve off the card is
        refused: its windows would pass host-CPU rates off as the card's."""
        tel = telemetry
        if tel is False:
            sched.telemetry = None
            return None
        if tel is None and sched.telemetry is not None:
            tel = sched.telemetry
        elif tel is None and monitor_registry.enabled():
            tel = (ServeTelemetry(slots=self.num_slots)
                   if self.device.type == "cuda" else ServeTelemetry(
                       slots=self.num_slots, status="SKIP",
                       reason=f"auto-attached serve telemetry on "
                              f"{self.device}: serving windows are "
                              f"measurements on the card"))
        if tel is None:
            return None
        if tel.status == "OK" and self.device.type != "cuda":
            raise ValueError(
                f"ServeTelemetry(status='OK') claims measurements on the "
                f"card, but this serve runs on {self.device} — pass "
                f"status='SKIP' with a reason naming the device")
        sched.telemetry = tel
        # the pool-quantization knob the record names (absent on float)
        tel.kv_dtype = self.kv_dtype
        return tel

    def serve(self, params, requests: List[Request], *,
              generator: Optional[torch.Generator] = None,
              clock: Optional[Callable[[], float]] = None,
              scheduler: Optional[Scheduler] = None,
              telemetry=None, draft=None, adaptive=None) -> List[Request]:
        """Run ``requests`` to completion; returns them in completion
        order with tokens and latency stamps filled in.

        Each loop iteration runs at most ``policy.prefill_share`` prefill
        chunks and ONE decode step (or speculative round) over the whole
        slot array. ``clock`` (``() -> seconds``, default
        ``time.perf_counter``) drives arrival replay and the stamps.
        ``generator`` (on the engine's device) draws the sampling noise and
        is required when ``temperature > 0``. ``scheduler`` injects a
        pre-built scheduler (tests script churn through it).

        ``telemetry`` attaches a :class:`~apex_tpu_torch.serving.telemetry.
        ServeTelemetry`: request lifecycle events, streaming latency
        histograms, periodic ``serve_window`` records and the anomaly
        layer, all host-side (the steps launch the same kernels with it on
        or off); at each window edge the scheduler's policy folds in its
        signals (:meth:`~apex_tpu_torch.serving.scheduler.SLOPolicy.
        update`). While the monitor registry is enabled and no tracker is
        passed or carried by ``scheduler``, one is attached; pass
        ``telemetry=False`` to suppress even that. A pending
        :meth:`request_swap` lands between dispatch steps.

        ``draft`` attaches a drafter: spec rounds replace plain decode
        steps whenever every decoding slot has the rows for them, and
        greedy output stays token-identical to ``draft=None``. A tree
        drafter (``propose_tree`` plus static ``depth``/``branching``)
        runs tree rounds, degrading per round tree → chain → plain on row
        headroom or on the pool headroom of a
        :class:`~apex_tpu_torch.spec.tree.PagedModelDrafter`, which is
        bound here to the scheduler's allocator. ``adaptive`` (an
        :class:`~apex_tpu_torch.spec.tree.AdaptiveSpecController`, tree
        drafters only) re-picks each round's (depth, branching) from its
        choices. Acceptance is accounted in :attr:`last_stats`."""
        if self.temperature > 0 and generator is None:
            raise ValueError("temperature > 0 serving requires a generator")
        from apex_tpu_torch.spec.drafter import validate_drafter
        from apex_tpu_torch.spec.tree import is_tree_drafter

        if draft is not None:
            if getattr(self.model, "decode_rel_bias", None) is not None:
                raise ValueError(
                    "serve(draft=...) cannot speculate for a model "
                    "with a decode relative-position bias (the spec "
                    "verify step does not carry the bucketed bias) — "
                    "serve this model with draft=None")
            # eager, knob-naming validation: max_s rows suffice, as spec
            # rounds run only with the rows for them
            validate_drafter(draft, self.config, needed_rows=self.max_s,
                             block_size=self.block_size)
        if adaptive is not None:
            if draft is None:
                raise ValueError(
                    "serve(adaptive=...) needs a drafter: the controller "
                    "picks the DRAFT shape per round — pass draft= a "
                    "tree drafter alongside it")
            if not is_tree_drafter(draft):
                raise ValueError(
                    "serve(adaptive=...) needs a TREE drafter (one with "
                    "propose_tree + static depth/branching): the "
                    "controller's choices are (depth, branching) tree "
                    "shapes — NGramTreeDrafter / PagedModelDrafter")
            for dd, _ in adaptive.choices:
                if dd > draft.depth:
                    raise ValueError(
                        f"adaptive choice set reaches depth {dd} but the "
                        f"drafter's static depth is {draft.depth} — the "
                        f"drafter cannot draft deeper than it was built "
                        f"for; shrink the choice set or deepen the "
                        f"drafter")
        wall = clock is None
        clock = time.perf_counter if clock is None else clock
        t0 = clock()
        now = lambda: clock() - t0  # noqa: E731
        sched = scheduler if scheduler is not None else self.make_scheduler()
        if draft is not None and hasattr(draft, "bind"):
            # a paged drafter joins THIS scheduler's block economy; bind
            # sets cache_rows, so validate again after it
            draft.bind(sched, block_size=self.block_size)
            validate_drafter(draft, self.config, needed_rows=self.max_s,
                             block_size=self.block_size)
        try:
            tel = self._attach_telemetry(telemetry, sched)
            for r in requests:
                if tel is not None:
                    r.submit_s = now()
                    tel.on_submit(r, r.submit_s)
                sched.submit(r)
            stats = ServeStats()
            pool = self.init_pool()
            # per-transition lifecycle records skip the per-line sink flush
            # inside the loop (one flush at the end)
            reg = monitor_registry.get_registry()
            flush_scope = (reg.buffered()
                           if reg is not None and tel is not None
                           else contextlib.nullcontext())
            if tel is not None:
                # prime the first window's clock BEFORE any work
                tel.maybe_window(now(), sched)
            # the serve-CALL trace context: engine-level records with no
            # per-request id (spans, windows, rid -1 events) share one
            # ambient id; per-request events carry their own
            with flush_scope, monitor_trace.trace_context(
                    monitor_trace.new_trace_id("serve")):
                self._serve_loop(params, generator, sched, tel, stats, now,
                                 wall, pool, draft, adaptive)
        finally:
            # an unapplied swap does NOT survive into a later serve() call,
            # on a clean return or a raise: stats.swaps == 0 is the tell
            self._pending_swap = None
        self.last_stats = stats
        self.last_pool = pool
        return sched.completed

    def _spec_mode(self, sched: Scheduler, stats: ServeStats, draft,
                   adaptive, tree_capable: bool):
        """The round's rung of the tree → chain → plain ladder by row
        headroom, before ``decode_batch``: (mode, tree shape or None)."""
        mode, shape = "plain", None
        dec = sched.decoding_slots()
        if draft is None or not dec:
            return mode, shape
        if tree_capable:
            shape = (adaptive.round_shape([sched.slot_rid(i) for i in dec])
                     if adaptive is not None
                     else (draft.depth, draft.branching))
            if all(sched.slot_length(i) + shape[0] + 1 <= self.max_s
                   for i in dec):
                mode = "tree"
        if mode == "plain" and all(
                sched.slot_length(i) + draft.k + 1 <= self.max_s
                for i in dec):
            mode = "chain"
            if tree_capable:
                stats.spec_degraded += 1
        return mode, shape

    def _serve_loop(self, params, generator, sched: Scheduler, tel,
                    stats: ServeStats, now, wall: bool, pool: Pool,
                    draft=None, adaptive=None) -> None:
        from apex_tpu_torch.spec.tree import is_tree_drafter

        dev = self.device
        as_dev = lambda a: torch.tensor(a, device=dev)  # noqa: E731 (copies)
        tree_capable = draft is not None and is_tree_drafter(draft)
        K = draft.k if draft is not None else 0
        policy = sched.policy
        nstep = 0  # the dispatch counter: prefill chunks and decode steps
        ncompleted = len(sched.completed)
        while not sched.idle():
            # a weight hot-swap lands HERE, between dispatch steps
            params = self._maybe_swap(params, nstep, tel, stats, now())
            sched.admit(now())
            did_work = False
            share = policy.prefill_share if policy is not None else 1
            for _ in range(share):
                work = sched.next_prefill(now())
                if work is None:
                    break
                sched.note_step(nstep)
                t_dispatch = now()
                t = time.perf_counter()
                tok, _ = self.prefill_chunk(
                    params, pool, as_dev(sched.tables.row(work.slot)),
                    as_dev(work.tokens), work.start, work.live, generator)
                tok = int(tok)  # waits for the chunk to finish
                stats.prefill_s += time.perf_counter() - t
                if tel is not None:
                    tel.on_prefill_chunk(
                        work.rid, work.slot, now() - t_dispatch,
                        sched.blocks_held(work.slot), nstep, now())
                nstep += 1
                stats.prefill_chunks += 1
                sched.note_prefill(work, tok, now())
                did_work = True
            mode, shape = self._spec_mode(sched, stats, draft, adaptive,
                                          tree_capable)
            lookahead = (shape[0] if mode == "tree"
                         else K if mode == "chain" else 0)
            batch = sched.decode_batch(now(), lookahead=lookahead)
            # the drafter's pool headroom comes AFTER decode_batch, which
            # can preempt: a short pool steps the round down the same
            # ladder (blocks reserved for the wider lookahead stay with
            # their slots, reused as the streams grow)
            if batch is not None and mode != "plain" \
                    and hasattr(draft, "round_blocks_needed"):
                while mode != "plain":
                    d_rows = shape[0] if mode == "tree" else K
                    need = sum(draft.round_blocks_needed(
                        sched.slot_rid(i), len(sched.slot_context(i)),
                        depth=d_rows) for i in sched.decoding_slots())
                    if need <= sched.allocator.num_free:
                        break
                    mode = "chain" if mode == "tree" else "plain"
                    stats.spec_degraded += 1
            if batch is not None and mode != "plain":
                self._spec_round(params, pool, generator, sched, tel, stats,
                                 now, nstep, batch, mode, shape, draft,
                                 adaptive)
                nstep += 1
                did_work = True
            elif batch is not None:
                toks, lens = batch
                ndec = len(sched.decoding_slots())
                sched.note_step(nstep)
                t_dispatch = now()
                t = time.perf_counter()
                sampled, _ = self.decode_step(
                    params, pool, as_dev(sched.tables.asarray()),
                    as_dev(toks), as_dev(lens), generator)
                sampled = sampled.cpu().numpy()  # waits for the step
                stats.decode_s += time.perf_counter() - t
                if tel is not None:
                    tel.on_decode_step(now() - t_dispatch, ndec, nstep,
                                       now())
                nstep += 1
                stats.decode_steps += 1
                sched.note_decode(sampled, now())
                did_work = True
            if draft is not None and len(sched.completed) > ncompleted:
                # finished streams' drafter and controller state go
                for r in sched.completed[ncompleted:]:
                    draft.release(r.rid)
                    if adaptive is not None:
                        adaptive.release(r.rid)
                ncompleted = len(sched.completed)
            stats.blocks_high_water = max(stats.blocks_high_water,
                                          sched.allocator.num_live)
            if tel is not None and tel.maybe_window(now(), sched) \
                    is not None and policy is not None:
                # window edge: fold the fresh SLO/anomaly signals into the
                # dispatch knobs (SLO-aware scheduling)
                policy.update(tel)
            if not did_work and wall:
                # nothing runnable: only future arrivals remain
                time.sleep(1e-4)

    def _spec_round(self, params, pool: Pool, generator, sched: Scheduler,
                    tel, stats: ServeStats, now, nstep: int, batch,
                    mode: str, shape, draft, adaptive) -> None:
        """One chain or tree round over the slot array (dispatch
        ``nstep``): the drafts from the host drafter, the step, the commit
        and its accounting."""
        from apex_tpu_torch.spec.tree import draft_tree

        dev = self.device
        toks, lens = batch
        live = [i for i in range(self.num_slots) if lens[i] > 0]
        rids = {i: sched.slot_rid(i) for i in live}
        t = time.perf_counter()
        if mode == "tree":
            depth, branching = shape
            tree = draft_tree(branching, depth)
            node_toks = np.zeros((self.num_slots, tree.num_nodes), np.int32)
            for i in live:
                node_toks[i] = draft.propose_tree(
                    rids[i], sched.slot_context(i), shape=(depth, branching))
            rows, drafted_rows = tree.num_nodes, depth
        else:
            K = draft.k
            node_toks = np.zeros((self.num_slots, K), np.int32)
            for i in live:
                node_toks[i] = draft.propose(rids[i], sched.slot_context(i))
            rows, drafted_rows = K, K
        tok_mat = np.zeros((self.num_slots, rows + 1), np.int32)
        tok_mat[:, 0] = toks
        tok_mat[:, 1:] = node_toks
        t_step = time.perf_counter()
        stats.draft_s += t_step - t
        sched.note_step(nstep)
        t_dispatch = now()
        tables = torch.tensor(sched.tables.asarray(), device=dev)
        tok_dev = torch.tensor(tok_mat, device=dev)
        lens_dev = torch.tensor(lens, device=dev)
        if mode == "tree":
            parents, anc = tree.operands(self.num_slots)
            acc, jst, nxt = self.spec_tree_step(
                params, pool, tables, tok_dev, lens_dev,
                torch.tensor(parents, device=dev),
                torch.tensor(anc, device=dev), depth, generator)
            acc, jst, nxt = (x.cpu().numpy() for x in (acc, jst, nxt))
        else:
            acc, nxt = self.spec_step(params, pool, tables, tok_dev,
                                      lens_dev, tok_dev[:, 1:], generator)
            acc, nxt = acc.cpu().numpy(), nxt.cpu().numpy()  # waits
        stats.decode_s += time.perf_counter() - t_step
        round_dur = now() - t_dispatch
        if tel is not None:
            tel.on_decode_step(round_dur, len(live), nstep, now())
        stats.decode_steps += 1
        stats.spec_rounds += 1
        stats.tree_rounds += int(mode == "tree")
        emitted = {}
        for i in live:
            a = int(acc[i])
            stats.spec_drafted += drafted_rows
            stats.spec_accepted += a
            stats.spec_nodes += rows
            stats.spec_slot_rounds += 1
            if adaptive is not None:
                # a degraded (chain) round still teaches the controller
                adaptive.note_round(rids[i], a, drafted_rows)
            if tel is not None:
                # the round's full wall time for EVERY live slot (the
                # concurrent wall time a per-request partition must bill)
                tel.on_spec_round(
                    rids[i], i, a, drafted_rows, nstep, now(),
                    dur_ms=round_dur * 1e3,
                    **(dict(nodes=tree.num_nodes, branching=branching)
                       if mode == "tree" else {}))
            if mode == "tree":
                emitted[i] = tree.path_tokens(node_toks[i], a, int(jst[i]),
                                              int(nxt[i]))
        if mode == "tree":
            sched.note_spec_tokens(emitted, now())
        else:
            sched.note_spec(node_toks, acc, nxt, now())
