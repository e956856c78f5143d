"""ServingEngine: continuous-batching generation over a paged KV cache.

Port of ``apex_tpu/serving/engine.py`` at tp=1 with a float pool. Two
device programs, run eagerly:

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

The pool is updated IN PLACE — the port's analog of the reference's pool
donation: a step's memory traffic is the live cache read plus one token's
writes, never a pool copy. Everything dynamic about traffic stays in the
host-side :class:`~apex_tpu_torch.serving.scheduler.Scheduler`.

Not in this slice (raising where a caller could ask for them): quantized
pools (``kv_dtype``), tensor-parallel serving (``plan.tp > 1``),
speculative rounds (``draft``), serving telemetry and weight hot-swap.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from apex_tpu_torch.models.gpt import GPTModel
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.decode_attention import NEG_INF
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.sampling import fused_sample
from apex_tpu_torch.serving.kv_blocks import (DEAD_BLOCK, BlockAllocator,
                                              PrefixCache)
from apex_tpu_torch.serving.scheduler import Request, Scheduler, SLOPolicy

Pool = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ServeStats:
    """Host-side accounting of one :meth:`ServingEngine.serve` call.
    ``prefill_s``/``decode_s`` sum the host time of the dispatches, each
    ending in the device→host copy of its sampled tokens."""

    decode_steps: int = 0
    prefill_chunks: int = 0
    blocks_high_water: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0


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
        if kv_dtype is not None:
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: quantized pools are a later slice "
                f"of the port; serve with the float pool (kv_dtype=None)")
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
        model.check_paged_decode_supported(self.device, block_size)
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

    # --- pool ----------------------------------------------------------------

    def init_pool(self) -> Pool:
        """The zeroed block pool ``{"k"/"v": (layers, num_blocks,
        kv_heads, block_size, head_dim)}`` on the engine's device — block
        0 is the dead block (see kv_blocks). Cells are in the model's
        parameter dtype."""
        c = self.config
        shape = (c.num_layers, self.num_blocks, c.kv_heads,
                 self.block_size, c.head_dim)
        return {name: torch.zeros(shape, dtype=c.dtype, device=self.device)
                for name in ("k", "v")}

    def pool_bytes(self) -> int:
        """Device footprint of the whole pool (k and v)."""
        c = self.config
        cells = (c.num_layers * self.num_blocks * c.kv_heads
                 * self.block_size * c.head_dim)
        return 2 * cells * torch.empty((), dtype=c.dtype).element_size()

    # --- sampling tail -------------------------------------------------------

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        return fused_sample(logits, temperature=self.temperature,
                            top_k=self.top_k, top_p=self.top_p,
                            generator=generator, impl=self.impl)

    # --- prefill chunk -------------------------------------------------------

    @torch.no_grad()
    def prefill_chunk(self, params, pool: Pool, table_row: torch.Tensor,
                      tokens: torch.Tensor, start: int, live: int,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk of ONE slot's prompt: ``tokens`` (C,) are prompt
        positions [start, start+C) with the first ``live`` valid. Writes
        the chunk's k/v into ``pool`` in place and returns
        ``(token, last_logits)`` — meaningful on the prompt's LAST chunk
        (row ``live - 1`` is then its final token)."""
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
        for i, layer in enumerate(params["layers"]):
            ck, cv = pool["k"][i], pool["v"][i]
            h_in = fused_layer_norm(x, layer["ln1_w"], layer["ln1_b"],
                                    impl=self.impl)
            q, k, v = model._proj_qkv_bshd(layer, h_in)
            # chunk k/v → (C/B, h_kv, B, d) block writes at the ids
            ck[ids] = k[0].reshape(nblk, B, h_kv, d).transpose(1, 2).to(
                ck.dtype)
            cv[ids] = v[0].reshape(nblk, B, h_kv, d).transpose(1, 2).to(
                cv.dtype)
            # chunk queries × the slot's gathered padded cache (the chunk's
            # own rows included — causal within the chunk falls out of the
            # same mask); scores in fp32, p cast to v's dtype for PV
            k_all = ck[rows].transpose(0, 1).reshape(h_kv, max_s, d)
            v_all = cv[rows].transpose(0, 1).reshape(h_kv, max_s, d)
            qg = q[0].reshape(C, h_kv, group, d).permute(1, 2, 0, 3)
            s = torch.einsum("hgcd,hsd->hgcs", qg.float(),
                             k_all.float()) * scale
            s = torch.where(mask, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            ctx = torch.einsum("hgcs,hsd->hgcd", p.to(v_all.dtype), v_all)
            ctx = ctx.permute(2, 0, 1, 3).reshape(1, C, c.num_heads, d)
            x = x + model._proj_attn_out(layer, ctx)
            x = x + model._mlp(layer, fused_layer_norm(
                x, layer["ln2_w"], layer["ln2_b"], impl=self.impl))
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        last = x[:, live - 1:live]
        logits = model.unembed(params, last)[:, 0]  # (1, V)
        return self._sample(logits, generator)[0], logits[0]

    # --- decode step ---------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, params, pool: Pool, tables: torch.Tensor,
                    tokens: torch.Tensor, lengths: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One token for EVERY slot: ``tokens`` (S,) each slot's incoming
        token, ``lengths`` (S,) live rows INCLUDING it (0 = dead slot: its
        write lands in the dead block, its output is ignored). Writes the
        pool in place; returns ``(next_tokens, logits)``."""
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
        for i, layer in enumerate(params["layers"]):
            ck, cv = pool["k"][i], pool["v"][i]
            q, k_row, v_row = model.decode_qkv(layer, x, self.impl)
            ck[bid, :, row] = k_row[:, :, 0].to(ck.dtype)
            cv[bid, :, row] = v_row[:, :, 0].to(cv.dtype)
            x = model.decode_block(layer, x, q, ck, cv, lengths,
                                   block_tables=tables, impl=self.impl)
        x = fused_layer_norm(x, params["lnf_w"], params["lnf_b"],
                             impl=self.impl)
        logits = model.unembed(params, x)[:, 0]  # (S, V)
        return self._sample(logits, generator), logits

    # --- the serving loop ----------------------------------------------------

    def make_scheduler(self) -> Scheduler:
        """A fresh scheduler + allocator matching this engine's pool, with
        a :class:`~apex_tpu_torch.serving.kv_blocks.PrefixCache` over the
        same allocator."""
        alloc = BlockAllocator(self.num_blocks)
        return Scheduler(
            num_slots=self.num_slots, block_size=self.block_size,
            max_blocks_per_slot=self.max_blocks_per_slot,
            allocator=alloc, prefill_chunk=self.prefill_chunk_size,
            prefix_cache=PrefixCache(alloc, self.block_size),
            policy=SLOPolicy())

    def serve(self, params, requests: List[Request], *,
              generator: Optional[torch.Generator] = None,
              clock: Optional[Callable[[], float]] = None,
              scheduler: Optional[Scheduler] = None,
              draft=None) -> List[Request]:
        """Run ``requests`` to completion; returns them in completion
        order with tokens and latency stamps filled in.

        Each loop iteration runs at most ``policy.prefill_share`` prefill
        chunks and ONE decode step over the whole slot array. ``clock``
        (``() -> seconds``, default ``time.perf_counter``) drives arrival
        replay and the stamps. ``generator`` (on the engine's device)
        draws the sampling noise and is required when ``temperature > 0``.
        ``scheduler`` injects a pre-built scheduler (tests script churn
        through it)."""
        if draft is not None:
            raise NotImplementedError(
                "speculative serving (draft=...) is a later slice of the "
                "port")
        if self.temperature > 0 and generator is None:
            raise ValueError("temperature > 0 serving requires a generator")
        wall = clock is None
        clock = time.perf_counter if clock is None else clock
        t0 = clock()
        now = lambda: clock() - t0  # noqa: E731
        sched = scheduler if scheduler is not None else self.make_scheduler()
        for r in requests:
            sched.submit(r)
        stats = ServeStats()
        self._serve_loop(params, generator, sched, stats, now, wall,
                         self.init_pool())
        self.last_stats = stats
        return sched.completed

    def _serve_loop(self, params, generator, sched: Scheduler,
                    stats: ServeStats, now, wall: bool, pool: Pool) -> None:
        dev = self.device
        as_dev = lambda a: torch.tensor(a, device=dev)  # noqa: E731 (copies)
        while not sched.idle():
            sched.admit(now())
            did_work = False
            share = sched.policy.prefill_share if sched.policy else 1
            for _ in range(share):
                work = sched.next_prefill(now())
                if work is None:
                    break
                t = time.perf_counter()
                tok, _ = self.prefill_chunk(
                    params, pool, as_dev(sched.tables.row(work.slot)),
                    as_dev(work.tokens), work.start, work.live, generator)
                tok = int(tok)  # waits for the chunk to finish
                stats.prefill_s += time.perf_counter() - t
                stats.prefill_chunks += 1
                sched.note_prefill(work, tok, now())
                did_work = True
            batch = sched.decode_batch(now())
            if batch is not None:
                toks, lens = batch
                t = time.perf_counter()
                sampled, _ = self.decode_step(
                    params, pool, as_dev(sched.tables.asarray()),
                    as_dev(toks), as_dev(lens), generator)
                sampled = sampled.cpu().numpy()  # waits for the step
                stats.decode_s += time.perf_counter() - t
                stats.decode_steps += 1
                sched.note_decode(sampled, now())
                did_work = True
            stats.blocks_high_water = max(stats.blocks_high_water,
                                          sched.allocator.num_live)
            if not did_work and wall:
                # nothing runnable: only future arrivals remain
                time.sleep(1e-4)
