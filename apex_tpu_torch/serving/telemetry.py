"""Request-level serving telemetry: lifecycle traces, streaming latency
histograms, live SLO windows, and anomaly detection.

Port of ``apex_tpu/serving/telemetry.py`` (plain host Python):
:class:`ServeTelemetry` is the observability layer of
:meth:`~apex_tpu_torch.serving.engine.ServingEngine.serve`:

* **Lifecycle event stream** — one rank-tagged ``serve_event`` JSONL
  record per request transition (``submit → admit → prefill_chunk*k →
  first_token → decode → finish``, with ``evict`` → re-``admit`` →
  resumed ``decode`` when preemption strikes) carrying queue wait, chunk
  count, blocks held, per-phase durations, and the engine step index of
  the dispatch that produced it. The engine's steps run inside the
  ``serve_prefill`` / ``serve_decode`` / ``serve_spec`` /
  ``serve_spec_tree`` spans (``torch.profiler`` ranges), so a profile of
  the serve splits the card's time by step kind.
* **Streaming histograms** — inter-token latency and TTFT land in
  bounded-memory :class:`~apex_tpu_torch.monitor.histogram.
  StreamingHistogram` pairs (cumulative for the final record, per window
  for the live records).
* **Live SLO windows** — a periodic ``serve_window`` record (sliding
  window tokens/s, TTFT / per-token quantiles, queue depth, slot
  occupancy, pool high-water, admission-blocked-by {slots|blocks}
  counts) with a ``serve_anomaly`` section.
* **Anomaly layer** — straggler decode steps against a rolling median,
  queue-buildup and SLO-burn flags (sustained TTFT over threshold), and
  free-list leak / fragmentation accounting from
  :class:`~apex_tpu_torch.serving.kv_blocks.BlockAllocator`.

Everything here is host-side bookkeeping driven from outside the device
steps: the steps launch the same kernels the same number of times with
telemetry on or off, and the cost is O(1) dict/histogram work per token
plus one JSONL write per transition/window, accumulated in
:attr:`ServeTelemetry.overhead_ns` (the hooks are a single ``is None``
test when no telemetry is attached). Records only reach a file while the
process-wide monitor registry is enabled; the histograms and anomaly
counters accumulate regardless. The records are the reference's, field
for field (``tests/test_torch_serve_telemetry.py`` replays one hook trace
into both).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

from apex_tpu_torch.monitor import registry as _reg
from apex_tpu_torch.monitor import trace as _trace
from apex_tpu_torch.monitor.histogram import StreamingHistogram
# the unified clock (== time.perf_counter_ns): overhead accounting and
# every monitor stream measure on the same CLOCK_MONOTONIC base
from apex_tpu_torch.monitor.trace import monotonic_ns as _mono

__all__ = ["ServeTelemetry"]

# lifecycle phases, in order (evict fires on preemption: the request
# releases its blocks and re-queues for evict-and-recompute; swap is an
# ENGINE-level transition, rid -1 — a weight hot-swap landed between
# dispatch steps)
PHASES = ("submit", "admit", "prefill_chunk", "first_token", "decode",
          "finish", "evict", "swap", "spec", "handoff", "replan")


class _InFlight:
    """Per-request scratch while the request is live (freed at finish —
    the tracker's memory is bounded by concurrent requests, never by
    request history)."""

    __slots__ = ("queued_at", "admit_at", "chunks", "prefill_s",
                 "first_token_at", "requeued_at", "trace_id")

    def __init__(self, queued_at: float, trace_id: Optional[str] = None):
        self.queued_at = queued_at
        self.admit_at: Optional[float] = None
        self.chunks = 0
        self.prefill_s = 0.0
        self.first_token_at: Optional[float] = None
        # set on evict: re-admission measures queue wait from HERE, not
        # from the original submit (the prior in-slot service time is
        # not queueing)
        self.requeued_at: Optional[float] = None
        # the request-scoped trace id (minted at submit, mirrored on
        # the Request itself): rides every lifecycle record of this
        # request — across evict → re-admit → resume, because both this
        # tracker entry and the Request object survive the eviction
        self.trace_id = trace_id


class ServeTelemetry:
    """Request-level telemetry for one :meth:`ServingEngine.serve` call.

    Construct one per serve run and pass it as
    ``engine.serve(..., telemetry=tel)`` (the engine also auto-attaches
    one when the monitor registry is enabled). Knobs:

    * ``slots`` — the engine's slot count (occupancy denominator).
    * ``window_s`` — ``serve_window`` emission period on the serve
      clock (0 disables periodic records; stats still accumulate).
    * ``slo_ttft_ms`` — the TTFT service-level objective; ``None``
      disables SLO-burn detection.
    * ``slo_burn_count`` — consecutive over-SLO first tokens that flip
      the ``slo_burn`` flag (sustained breach, not a single outlier).
    * ``straggler_ratio`` / ``straggler_window`` — a decode step slower
      than ``ratio`` x the rolling median of the last ``window`` steps
      counts as a straggler (after the window has filled once).
    * ``status`` / ``reason`` — the claim the emitted ``serve_window``
      records carry ("OK" engages the no-nan honesty rule, and is for
      serves on the card; a serve on the CPU passes ``status="SKIP"``
      with a reason naming the device — the engine's auto-attached
      tracker does).
    """

    def __init__(self, *, slots: int, window_s: float = 0.5,
                 slo_ttft_ms: Optional[float] = None,
                 slo_burn_count: int = 3,
                 straggler_ratio: float = 3.0,
                 straggler_window: int = 32,
                 status: str = "OK", reason: Optional[str] = None,
                 collect_events: bool = False):
        if status not in ("OK", "SKIP"):
            raise ValueError(f"status must be OK|SKIP, got {status!r}")
        if status == "SKIP" and not reason:
            raise ValueError("SKIP serve_window records need a reason")
        self.slots = int(slots)
        self.window_s = float(window_s)
        self.slo_ttft_ms = slo_ttft_ms
        self.slo_burn_count = int(slo_burn_count)
        self.straggler_ratio = float(straggler_ratio)
        self.straggler_window = int(straggler_window)
        self.status = status
        self.reason = reason
        # collect_events=True keeps an in-memory ledger of every emitted
        # event's fields (same dict shape as the JSONL records), so
        # trace.serve_attribution() can run without any sink — how the
        # a caller emits serve_attribution when no stream was requested
        self.collect_events = bool(collect_events)
        self.events: list = []

        # cumulative histograms back the final serve record; the window
        # pair resets at every serve_window emission (sliding view).
        # TTFT additionally splits by prefix-cache outcome: the
        # hit-vs-miss p50 gap IS the prefix cache's headline claim
        self.itl_ms = StreamingHistogram()
        self.ttft_ms = StreamingHistogram()
        self.ttft_hit_ms = StreamingHistogram()
        self.ttft_miss_ms = StreamingHistogram()
        self._win_itl = StreamingHistogram()
        self._win_ttft = StreamingHistogram()

        self._inflight: Dict[int, _InFlight] = {}
        self._recent_steps = deque(maxlen=self.straggler_window)
        self._queue_depths = deque(maxlen=4)  # at window emissions

        # counters surfaced on windows and the final record
        self.tokens = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.finished = 0
        self.admission_blocked_slots = 0
        self.admission_blocked_blocks = 0
        self.queue_peak = 0
        self.straggler_steps = 0
        self.straggler_last_ratio = 0.0
        self._ttft_over_slo_run = 0
        self.ttft_over_slo = 0
        self.slo_burn = False
        self.queue_buildup = False
        self.leaked_blocks = 0
        self.windows_emitted = 0
        # serving-tier-2 counters: preemption + prefix-cache outcomes
        self.preemptions = 0
        self.resumes = 0
        self.prefix_hit_requests = 0
        self.prefix_miss_requests = 0
        # weight hot-swaps applied between dispatch steps
        self.swaps = 0
        # online re-plans: ReplanPolicy ladder switches at window edges
        # (the port has no ReplanPolicy yet: stays 0)
        self.replans = 0
        # disaggregated prefill→decode handoff legs this engine played
        # (either role; the port has no disaggregated roles yet: stays 0)
        self.handoffs = 0
        self.handoff_blocks = 0
        self.handoff_bytes = 0
        self.handoff_transfer_ms = 0.0
        # speculative-decoding rounds: per SLOT-round
        # accepted lengths accumulate into the serve record's
        # acceptance rate (spec_slot_rounds counts slot×dispatch —
        # distinct from ServeStats.spec_rounds, which counts dispatches)
        self.spec_slot_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.draft_k = 0
        # tree speculative rounds: verify rows actually
        # scored (chain rounds count k) and how many rounds were trees
        self.spec_nodes = 0
        self.spec_tree_rounds = 0
        # the engine stamps its pool-quantization knob here at serve
        # start so the record names the pool it measured
        self.kv_dtype: Optional[str] = None

        self._win_t0: Optional[float] = None
        self._win_tokens = 0
        self._win_steps = 0
        self._win_chunks = 0
        self.overhead_ns = 0  # real host ns spent inside the hooks

    # --- internals -----------------------------------------------------------

    @property
    def overhead_s(self) -> float:
        return self.overhead_ns * 1e-9

    def _emit(self, kind: str, **fields) -> None:
        if self.collect_events:
            self.events.append({"kind": kind, **fields})
        r = _reg.get_registry()
        if r is None:
            return
        if kind == "serve_window":
            r.emit_serve_window(self.status, **fields)
        else:
            r.emit(kind, **fields)

    @staticmethod
    def _tid(fl: Optional[_InFlight]) -> Dict[str, str]:
        """The trace-id field of a lifecycle record ({} when the
        tracker never saw a submit — explicit ids beat the ambient
        serve-level id the registry would otherwise stamp)."""
        if fl is not None and fl.trace_id:
            return {"trace_id": fl.trace_id}
        return {}

    @staticmethod
    def _skip_or(value, why: str):
        return value if value is not None else ("skipped", why)

    # --- lifecycle hooks (called by Scheduler / ServingEngine) ---------------

    def on_submit(self, req, now: float) -> None:
        t = _mono()
        # mint the request's trace id HERE (unless the caller already
        # stamped one) and mirror it on the Request object: the object
        # survives evict → re-admit → resume, so continuity is free
        tid = getattr(req, "trace_id", None)
        if not tid:
            tid = _trace.new_trace_id("req")
            try:
                req.trace_id = tid
            except AttributeError:
                pass  # slotted/frozen stand-ins: the tracker still has it
        self._inflight[req.rid] = _InFlight(
            queued_at=max(now, float(req.arrival_s)), trace_id=tid)
        self._emit("serve_event", rid=req.rid, phase="submit", at_s=now,
                   trace_id=tid,
                   prompt_len=int(len(req.prompt)),
                   max_new_tokens=int(req.max_new_tokens))
        self.overhead_ns += _mono() - t

    def on_admit(self, req, slot: int, now: float,
                 prefix_hit_blocks: int = 0, resumed: bool = False
                 ) -> None:
        t = _mono()
        fl = self._inflight.get(req.rid)
        if fl is None:  # submitted before the tracker attached
            fl = self._inflight[req.rid] = _InFlight(
                float(req.arrival_s), getattr(req, "trace_id", None))
        fl.admit_at = now
        # a re-admission waited since its EVICTION, not since submit —
        # billing the prior in-slot service time as queueing would
        # inflate exactly the rows preemption analysis looks at
        since = fl.requeued_at if fl.requeued_at is not None \
            else fl.queued_at
        fl.requeued_at = None
        queue_wait_ms = max(now - since, 0.0) * 1e3
        fields = dict(rid=req.rid, phase="admit", at_s=now,
                      slot=int(slot),
                      queue_wait_ms=round(queue_wait_ms, 3),
                      **self._tid(fl))
        if prefix_hit_blocks:
            fields["prefix_hit_blocks"] = int(prefix_hit_blocks)
        if resumed:  # re-admission after an evict
            fields["resumed"] = True
        self._emit("serve_event", **fields)
        self.overhead_ns += _mono() - t

    def on_evict(self, req, slot: int, blocks_released: int, reason: str,
                 requeue_pos: int, step: int, now: float) -> None:
        """The reserved preemption transition: slot ``slot``'s request
        released ``blocks_released`` block references and re-queued at
        ``requeue_pos`` for evict-and-recompute."""
        t = _mono()
        self.preemptions += 1
        fl = self._inflight.get(req.rid)
        if fl is not None:
            fl.requeued_at = now
        self._emit("serve_event", rid=req.rid, phase="evict", at_s=now,
                   slot=int(slot), step=int(step),
                   evict_reason=str(reason),
                   blocks_released=int(blocks_released),
                   requeue_pos=int(requeue_pos),
                   generated=len(req.tokens), **self._tid(fl))
        self.overhead_ns += _mono() - t

    def on_resume(self, req, slot: int, blocks_held: int, step: int,
                  now: float) -> None:
        """An evicted request finished its re-prefill and re-entered
        steady decode (the recompute's sampled token was discarded —
        the stream continues exactly where it left off)."""
        t = _mono()
        self.resumes += 1
        self._emit("serve_event", rid=req.rid, phase="decode", at_s=now,
                   slot=int(slot), blocks_held=int(blocks_held),
                   step=int(step), resumed=True,
                   **self._tid(self._inflight.get(req.rid)))
        self.overhead_ns += _mono() - t

    def on_swap(self, step: int, now: float,
                source: Optional[str] = None,
                dur_ms: Optional[float] = None) -> None:
        """A weight hot-swap landed between dispatch steps (rid -1:
        engine-level, like straggler events). ``source`` names where
        the weights came from (e.g. the checkpoint step directory);
        ``dur_ms`` is the measured validate+rebind pause — attribution
        carves it out of the decode time of every request that was
        mid-decode when the swap landed."""
        t = _mono()
        self.swaps += 1
        fields = dict(rid=-1, phase="swap", at_s=now, step=int(step))
        if source:
            fields["swap_source"] = str(source)
        if dur_ms is not None:
            fields["dur_ms"] = round(float(dur_ms), 3)
        self._emit("serve_event", **fields)
        self.overhead_ns += _mono() - t

    def on_replan(self, step: int, now: float, *, plan_from: str,
                  plan_to: str, trigger: str,
                  live_knobs: Optional[list] = None,
                  deferred_knobs: Optional[list] = None,
                  dur_ms: Optional[float] = None) -> None:
        """An online re-plan landed at a window edge (rid -1,
        engine-level, like ``swap``): the reference's
        ``ReplanPolicy`` switched the active ServePlan.
        ``plan_from``/``plan_to`` are plan content digests and
        ``trigger`` names the load signal (``queue_buildup`` /
        ``slo_burn`` / ``calm``); ``live_knobs`` lists the aval-stable
        diffs applied in place, ``deferred_knobs`` the aval-changing
        diffs REPORTED but not applied (they wait for a
        ``request_swap``-style engine rebuild)."""
        t = _mono()
        self.replans += 1
        fields = dict(rid=-1, phase="replan", at_s=now, step=int(step),
                      plan_from=str(plan_from), plan_to=str(plan_to),
                      replan_trigger=str(trigger))
        if live_knobs:
            fields["live_knobs"] = [str(k) for k in live_knobs]
        if deferred_knobs:
            fields["deferred_knobs"] = [str(k) for k in deferred_knobs]
        if dur_ms is not None:
            fields["dur_ms"] = round(float(dur_ms), 3)
        self._emit("serve_event", **fields)
        self.overhead_ns += _mono() - t

    def on_spec_round(self, rid: int, slot: int, accepted: int, k: int,
                      step: int, now: float,
                      dur_ms: Optional[float] = None,
                      nodes: Optional[int] = None,
                      branching: Optional[int] = None) -> None:
        """One slot's speculative round: ``accepted`` of ``k`` drafted
        tokens survived verification (the round emitted
        ``accepted + 1`` tokens up to the request's budget). Feeds the
        acceptance-rate accounting and one ``spec``-phase lifecycle
        record. ``dur_ms`` is the round's dispatch wall time (the same
        value for every live slot of the round — concurrent wall time,
        which is what a per-request e2e partition must bill); an
        all-rejected round (``accepted == 0``) is attributed to
        ``spec_rewind_ms``, the others to ``spec_ms``. A TREE round
        additionally passes ``nodes`` (verify rows scored, branching x
        depth) and ``branching`` — ``k`` is then the tree DEPTH, so the
        acceptance accounting stays chain-comparable while the record
        still prices the wider verify."""
        t = _mono()
        self.spec_slot_rounds += 1
        self.spec_drafted += k
        self.spec_accepted += accepted
        self.draft_k = k
        if nodes is not None:
            self.spec_tree_rounds += 1
            self.spec_nodes += nodes
        else:
            self.spec_nodes += k
        fields = dict(rid=rid, phase="spec", at_s=now,
                      slot=int(slot), step=int(step),
                      accepted_len=int(accepted), draft_k=int(k),
                      **self._tid(self._inflight.get(rid)))
        if nodes is not None:
            fields["tree_nodes"] = int(nodes)
        if branching is not None:
            fields["tree_branching"] = int(branching)
        if dur_ms is not None:
            fields["dur_ms"] = round(float(dur_ms), 3)
        self._emit("serve_event", **fields)
        self.overhead_ns += _mono() - t

    def on_handoff(self, rid: int, role: str, blocks: int, nbytes: int,
                   now: float, dur_ms: Optional[float] = None,
                   trace_id: Optional[str] = None) -> None:
        """One request's KV-block handoff leg (disaggregated serving):
        ``role`` names which side this engine played (``"export"`` on
        the prefill engine, ``"ingest"`` on the decode engine). The
        SAME ``trace_id`` rides both roles' records — the caller
        carries it across the process boundary inside the handoff
        payload, so a merged timeline joins the export and ingest legs
        of one request on one id."""
        t = _mono()
        if role not in ("export", "ingest"):
            raise ValueError(
                f"handoff role must be export|ingest, got {role!r}")
        self.handoffs += 1
        self.handoff_blocks += int(blocks)
        self.handoff_bytes += int(nbytes)
        fl = self._inflight.get(rid)
        tid = trace_id or (fl.trace_id if fl is not None else None)
        fields = dict(rid=int(rid), phase="handoff", at_s=now,
                      handoff_role=role, blocks=int(blocks),
                      transfer_bytes=int(nbytes),
                      **({"trace_id": tid} if tid else {}))
        if dur_ms is not None:
            self.handoff_transfer_ms += float(dur_ms)
            fields["dur_ms"] = round(float(dur_ms), 3)
        self._emit("serve_event", **fields)
        self.overhead_ns += _mono() - t

    def on_blocked(self, why: str, n: int = 1) -> None:
        if why == "slots":
            self.admission_blocked_slots += n
        elif why == "blocks":
            self.admission_blocked_blocks += n
        else:
            raise ValueError(f"unknown admission block reason {why!r}")

    def on_prefill_chunk(self, rid: int, slot: int, dur_s: float,
                         blocks_held: int, step: int, now: float) -> None:
        t = _mono()
        self.prefill_chunks += 1
        self._win_chunks += 1
        fl = self._inflight.get(rid)
        chunk = 0
        if fl is not None:
            chunk = fl.chunks
            fl.chunks += 1
            fl.prefill_s += dur_s
        self._emit("serve_event", rid=rid, phase="prefill_chunk", at_s=now,
                   slot=int(slot), chunk=chunk,
                   dur_ms=round(dur_s * 1e3, 3),
                   blocks_held=int(blocks_held), step=int(step),
                   **self._tid(fl))
        self.overhead_ns += _mono() - t

    def on_first_token(self, req, slot: int, blocks_held: int, step: int,
                       now: float) -> None:
        t = _mono()
        was_burning = self.slo_burn
        fl = self._inflight.get(req.rid)
        if fl is None:
            fl = self._inflight[req.rid] = _InFlight(
                float(req.arrival_s), getattr(req, "trace_id", None))
        fl.first_token_at = now
        ttft_ms = max(now - fl.queued_at, 0.0) * 1e3
        self.ttft_ms.add(ttft_ms)
        self._win_ttft.add(ttft_ms)
        # the prefix-cache witness: TTFT split by whether the request's
        # first admission mapped shared blocks out of the cache
        if getattr(req, "prefix_hit_blocks", 0) > 0:
            self.prefix_hit_requests += 1
            self.ttft_hit_ms.add(ttft_ms)
        else:
            self.prefix_miss_requests += 1
            self.ttft_miss_ms.add(ttft_ms)
        self.tokens += 1
        self._win_tokens += 1
        if self.slo_ttft_ms is not None:
            if ttft_ms > self.slo_ttft_ms:
                self.ttft_over_slo += 1
                self._ttft_over_slo_run += 1
                if self._ttft_over_slo_run >= self.slo_burn_count:
                    self.slo_burn = True
            else:
                self._ttft_over_slo_run = 0
        self._emit("serve_event", rid=req.rid, phase="first_token",
                   at_s=now, slot=int(slot),
                   ttft_ms=round(ttft_ms, 3), chunks=fl.chunks,
                   prefill_ms=round(fl.prefill_s * 1e3, 3),
                   blocks_held=int(blocks_held), step=int(step),
                   **self._tid(fl))
        if req.max_new_tokens > 1:  # the request enters steady decode
            self._emit("serve_event", rid=req.rid, phase="decode",
                       at_s=now, slot=int(slot),
                       blocks_held=int(blocks_held), step=int(step),
                       **self._tid(fl))
        self.overhead_ns += _mono() - t
        if self.slo_burn and not was_burning:
            # first flip of the anomaly flag: preserve the last-N raw
            # events for post-hoc debugging (no-op without a recorder;
            # once=True keeps repeats from re-dumping)
            _trace.flight_dump("serve_anomaly:slo_burn")

    def observe_itl(self, itl_s: float) -> None:
        """One inter-token gap (decode token ``i`` → ``i+1`` of one
        request) into the latency histograms."""
        t = _mono()
        ms = itl_s * 1e3
        self.itl_ms.add(ms)
        self._win_itl.add(ms)
        self.tokens += 1
        self._win_tokens += 1
        self.overhead_ns += _mono() - t

    def on_decode_step(self, dur_s: float, live_slots: int, step: int,
                       now: float) -> None:
        """One full-width decode step's wall time: feeds the straggler
        detector (vs the rolling median of recent steps)."""
        t = _mono()
        self.decode_steps += 1
        self._win_steps += 1
        straggled = False
        recent = self._recent_steps
        if len(recent) == recent.maxlen:
            med = sorted(recent)[len(recent) // 2]
            if med > 0 and dur_s > self.straggler_ratio * med:
                straggled = True
                self.straggler_steps += 1
                self.straggler_last_ratio = round(dur_s / med, 2)
                self._emit("serve_event", rid=-1, phase="decode",
                           at_s=now, step=int(step), straggler=True,
                           dur_ms=round(dur_s * 1e3, 3),
                           ratio_to_median=self.straggler_last_ratio,
                           slots=int(live_slots))
        recent.append(dur_s)
        self.overhead_ns += _mono() - t
        if straggled:
            _trace.flight_dump("serve_anomaly:straggler")

    def on_finish(self, req, slot: int, blocks_held: int, step: int,
                  now: float) -> None:
        t = _mono()
        self.finished += 1
        fl = self._inflight.pop(req.rid, None)
        decode_ms = None
        if fl is not None and fl.first_token_at is not None:
            decode_ms = round(max(now - fl.first_token_at, 0.0) * 1e3, 3)
        fields = dict(rid=req.rid, phase="finish", at_s=now,
                      slot=int(slot), tokens=len(req.tokens),
                      blocks_held=int(blocks_held), step=int(step),
                      total_ms=round(
                          max(now - float(req.arrival_s), 0.0) * 1e3, 3),
                      **self._tid(fl))
        if decode_ms is not None:
            fields["decode_ms"] = decode_ms
        if fl is not None:
            fields["chunks"] = fl.chunks
        self._emit("serve_event", **fields)
        self.overhead_ns += _mono() - t

    # --- windows + anomalies -------------------------------------------------

    @property
    def slo_burning(self) -> bool:
        """The LIVE burn signal: the current run of consecutive
        over-SLO first tokens has reached the burn count. Unlike the
        sticky :attr:`slo_burn` record flag, this clears when a first
        token lands back under the SLO — it is what the
        :class:`~apex_tpu_torch.serving.scheduler.SLOPolicy` keys its
        deprioritize-long-prompts knob on (a policy must be able to
        stand down)."""
        return (self.slo_ttft_ms is not None
                and self._ttft_over_slo_run >= self.slo_burn_count)

    def anomaly_section(self, allocator=None) -> Dict[str, Any]:
        """The ``serve_anomaly`` object riding ``serve_window`` records
        and the final ``serve`` record. With an ``allocator``, folds in
        the free-list leak / fragmentation accounting."""
        if allocator is not None and allocator.leaked:
            # counter drift is a leak whenever it shows; the idle-pool
            # flavor (live blocks with no active requests) is detected
            # at window time and sticks in self.leaked_blocks
            self.leaked_blocks = allocator.leaked
        if self.leaked_blocks:
            _trace.flight_dump("serve_anomaly:leak")
        out: Dict[str, Any] = {
            "straggler_steps": self.straggler_steps,
            "straggler_last_ratio": self.straggler_last_ratio,
            "queue_buildup": self.queue_buildup,
            "slo_burn": self.slo_burn,
            "ttft_over_slo": self.ttft_over_slo,
            "leaked_blocks": self.leaked_blocks,
        }
        if allocator is not None:
            out["free_list_frag_pct"] = round(
                allocator.fragmentation_pct(), 2)
        return out

    def maybe_window(self, now: float, sched) -> Optional[Dict[str, Any]]:
        """Emit a ``serve_window`` record when ``window_s`` has elapsed
        on the serve clock; returns the fields dict when one was
        emitted. ``sched`` is the live :class:`Scheduler` (queue depth,
        occupancy, allocator state are read from it). Queue depth
        counts requests that have ARRIVED and are waiting
        (:meth:`Scheduler.num_queued` — not the unarrived replay tail,
        which would saturate the peak at the trace length) and is
        sampled on EVERY call (the peak must not depend on window
        cadence); the record only on the window edge. The engine calls
        this once BEFORE its loop so the first window's clock starts
        before the first work, not after it."""
        queued = sched.num_queued(now)
        if queued > self.queue_peak:
            self.queue_peak = queued
        if self.window_s <= 0:
            return None
        if self._win_t0 is None:
            self._win_t0 = now
            return None
        if now - self._win_t0 < self.window_s:
            return None
        t = _mono()
        fields = self._window_fields(now, sched)
        self._emit("serve_window", **fields)
        self.windows_emitted += 1
        self._win_t0 = now
        self._win_tokens = 0
        self._win_steps = 0
        self._win_chunks = 0
        self._win_itl.reset()
        self._win_ttft.reset()
        self.overhead_ns += _mono() - t
        return fields

    def _window_fields(self, now: float, sched) -> Dict[str, Any]:
        window = max(now - (self._win_t0 if self._win_t0 is not None
                            else now), 0.0)
        queue = sched.num_queued(now)
        self.queue_peak = max(self.queue_peak, queue)
        self._queue_depths.append(queue)
        qd = list(self._queue_depths)
        self.queue_buildup = (
            len(qd) >= 3 and qd[-1] > 0
            and all(b > a for a, b in zip(qd[-3:], qd[-2:])))
        active = sched.num_active
        alloc = sched.allocator
        # a pool leak only means something when nothing SHOULD hold
        # blocks: counter drift is a leak at any time, and live blocks
        # with zero active requests are one too — MINUS the blocks the
        # prefix cache keeps resident (refcounted warm capacity is the
        # cache doing its job, not a leak; num_resident counts exactly
        # the cache-pinned live blocks)
        if alloc.leaked:
            self.leaked_blocks = alloc.leaked
        elif (active == 0 and queue == 0
                and alloc.num_live > getattr(alloc, "num_resident", 0)):
            self.leaked_blocks = (alloc.num_live
                                  - getattr(alloc, "num_resident", 0))
        cache = getattr(sched, "prefix_cache", None)
        hit_rate = cache.hit_rate() if cache is not None else None
        itl = self._win_itl
        ttft = self._win_ttft
        no_itl = "no inter-token samples in window"
        no_ttft = "no first tokens in window"
        return dict(
            at_s=round(now, 6),  # serve clock: joins the request rows
            window_s=round(window, 6),
            steps=self._win_steps,
            prefill_chunks=self._win_chunks,
            tokens=self._win_tokens,
            tokens_per_s=round(self._win_tokens / window, 1) if window > 0
            else ("skipped", "zero-length window"),
            latency_p50_ms=self._skip_or(
                _r3(itl.quantile(0.5)), no_itl),
            latency_p99_ms=self._skip_or(
                _r3(itl.quantile(0.99)), no_itl),
            ttft_p50_ms=self._skip_or(_r3(ttft.quantile(0.5)), no_ttft),
            ttft_p99_ms=self._skip_or(_r3(ttft.quantile(0.99)), no_ttft),
            queue_depth=queue,
            active_slots=active,
            slots=self.slots,
            occupancy_pct=round(100.0 * active / self.slots, 2),
            blocks_live=alloc.num_live,
            blocks_high_water=alloc.high_water,
            blocks_resident=getattr(alloc, "num_resident", 0),
            admission_blocked_slots=self.admission_blocked_slots,
            admission_blocked_blocks=self.admission_blocked_blocks,
            # serving tier 2: prefix-cache effectiveness + preemption
            # pressure, live per window
            prefix_hit_rate=self._skip_or(
                None if hit_rate is None else round(hit_rate, 4),
                "no prefix cache attached or nothing queried yet"),
            preemptions=getattr(sched, "preemptions", self.preemptions),
            recompute_tokens=getattr(sched, "recompute_tokens", 0),
            serve_anomaly=self.anomaly_section(alloc),
            **({"reason": self.reason} if self.reason else {}),
        )

    # --- the final serve-record fields ---------------------------------------

    def final_fields(self, allocator=None,
                     scheduler=None) -> Dict[str, Any]:
        """The telemetry-derived fields of the final ``serve`` record:
        cumulative streaming-histogram quantiles (replacing the
        sample-list percentile math), the hit-vs-miss TTFT split,
        preemption/recompute pressure, anomaly section, admission
        pressure counts, and the measured hook overhead.

        Call AFTER the serve run completed: every request has finished,
        so any block still live on the allocator BEYOND the prefix
        cache's residents IS a leak (the finish-path-stopped-freeing
        regression this flag exists for — the in-loop idle check can
        only fire on a window edge, which the last iteration rarely
        lands on; a warm prefix cache holding refcounted residents is
        NOT a leak)."""
        resident = getattr(allocator, "num_resident", 0) \
            if allocator is not None else 0
        if allocator is not None and allocator.num_live > resident:
            self.leaked_blocks = max(self.leaked_blocks,
                                     allocator.num_live - resident)
        cache = getattr(scheduler, "prefix_cache", None)
        hit_rate = cache.hit_rate() if cache is not None else None
        no_itl = "no inter-token samples (single-token outputs)"
        no_ttft = "no requests reached a first token"
        no_hit = "no prefix-hit requests reached a first token"
        no_miss = "no prefix-miss requests reached a first token"
        return dict(
            latency_p50_ms=self._skip_or(
                _r3(self.itl_ms.quantile(0.5)), no_itl),
            latency_p99_ms=self._skip_or(
                _r3(self.itl_ms.quantile(0.99)), no_itl),
            ttft_p50_ms=self._skip_or(
                _r3(self.ttft_ms.quantile(0.5)), no_ttft),
            ttft_p99_ms=self._skip_or(
                _r3(self.ttft_ms.quantile(0.99)), no_ttft),
            prefix_hit_ttft_p50_ms=self._skip_or(
                _r3(self.ttft_hit_ms.quantile(0.5)), no_hit),
            prefix_hit_ttft_p99_ms=self._skip_or(
                _r3(self.ttft_hit_ms.quantile(0.99)), no_hit),
            prefix_miss_ttft_p50_ms=self._skip_or(
                _r3(self.ttft_miss_ms.quantile(0.5)), no_miss),
            prefix_miss_ttft_p99_ms=self._skip_or(
                _r3(self.ttft_miss_ms.quantile(0.99)), no_miss),
            prefix_hit_rate=self._skip_or(
                None if hit_rate is None else round(hit_rate, 4),
                "no prefix cache attached or nothing queried yet"),
            prefix_hit_requests=self.prefix_hit_requests,
            prefix_miss_requests=self.prefix_miss_requests,
            preemptions=getattr(scheduler, "preemptions",
                                self.preemptions),
            recompute_tokens=getattr(scheduler, "recompute_tokens", 0),
            swaps=self.swaps,
            replans=self.replans,
            blocks_resident=resident,
            # speculative serving: acceptance accounting (only when spec
            # rounds actually ran — a plain serve record stays unchanged)
            **({"spec_slot_rounds": self.spec_slot_rounds,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "spec_acceptance_rate": round(
                    self.spec_accepted / self.spec_drafted, 4),
                "draft_k": self.draft_k}
               if self.spec_drafted else {}),
            # the pool-quantization knob the run served with (stamped
            # by the engine; absent on float pools)
            **({"kv_dtype": self.kv_dtype} if self.kv_dtype else {}),
            serve_anomaly=self.anomaly_section(allocator),
            admission_blocked_slots=self.admission_blocked_slots,
            admission_blocked_blocks=self.admission_blocked_blocks,
            queue_peak=self.queue_peak,
            serve_windows=self.windows_emitted,
        )


def _r3(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 3)
