"""Request-scoped tracing: one trace id end-to-end, a unified clock,
Chrome-trace export, TTFT attribution, and the anomaly flight recorder.

Port of ``apex_tpu/monitor/trace.py`` (plain host Python). The serving
stack emits three streams — ``span`` records
(:mod:`apex_tpu_torch.monitor.spans`), ``serve_event`` lifecycle records
(:mod:`apex_tpu_torch.serving.telemetry`) and step/bench records — joined
here by one correlation key and one clock:

* **Trace ids** — :func:`new_trace_id` mints a process-unique id per
  serve request (the telemetry stamps it on the
  :class:`~apex_tpu_torch.serving.scheduler.Request` at submit, where it
  survives evict → re-admit → resume), per serve call and per generate
  call (ambient, via :func:`trace_context`). The registry stamps the
  innermost ambient id on every record it emits; explicit ``trace_id=``
  fields win.
* **Unified clock** — every emitted record carries ``t_ns`` from
  :func:`monotonic_ns` (``time.perf_counter_ns``, the same
  ``CLOCK_MONOTONIC`` base as span ``t0_ns`` and the serve clock), and
  :func:`~apex_tpu_torch.monitor.registry.enable` emits one per-process
  ``clock_sync`` record (``mono_ns`` ↔ ``wall_s``).
* **Chrome/Perfetto export** — :func:`chrome_trace` /
  :func:`write_chrome_trace` turn a JSONL stream into trace-event JSON:
  one track per rank (span records), one per serve engine (rid -1
  events), one per request (queue / prefill / decode / spec / preempt
  slices, each carrying the request's ``trace_id``). Merging a device
  trace (the reference's ``device_events``, a ``prof.trace_reader``
  result) waits for the port of ``prof/``: passing one raises
  ``TypeError``.
* **TTFT/latency attribution** — :func:`serve_attribution` partitions
  each request's ``[submit, finish]`` into queue / prefill / decode /
  spec / spec-rewind / preempt-wait / recompute / swap-pause components
  that sum to the measured e2e latency up to rounding.
* **Anomaly flight recorder** — :class:`FlightRecorder`, a bounded ring
  of the most recent raw records (fed by the registry's emit path, so it
  accumulates even when no JSONL sink is attached), dumped to a
  timestamped JSON file when the anomaly layer fires, on SIGTERM
  (:func:`install_signal_handler`), or on demand.

Disabled-path contract: the ambient stack is consulted only inside an
already-emitting registry, the flight ring only when one was enabled, and
a process that never calls :func:`~apex_tpu_torch.monitor.registry.enable`
builds no records at all.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import itertools
import json
import os
import signal as _signal
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "monotonic_ns", "monotonic_s", "new_trace_id", "current_trace_id",
    "trace_context", "FlightRecorder", "enable_flight_recorder",
    "disable_flight_recorder", "get_flight_recorder", "flight_dump",
    "install_signal_handler", "serve_attribution", "ATTR_COMPONENTS",
    "chrome_trace", "write_chrome_trace",
]

# THE clock: every stream measures on this one monotonic base —
# registry `t_ns`, span `t0_ns`, the serve clock, telemetry overhead
# accounting. One symbol, imported everywhere, so the unification is a
# grep-able fact rather than a convention.
monotonic_ns = time.perf_counter_ns
monotonic_s = time.perf_counter

# --- trace ids + ambient context ---------------------------------------------

_RUN = f"{os.getpid():x}"
_COUNTER = itertools.count(1)

# the ambient trace-id stack, innermost last (mirrors spans._STACK:
# serving/training are single-threaded per process, so a plain list
# keeps the cost at one attribute load + truthiness test per emit)
_STACK: List[str] = []


def new_trace_id(prefix: str = "req") -> str:
    """A process-unique trace id: ``<prefix>-<pid hex>-<seq hex>``.
    Cheap (one counter increment), monotone within a process, and
    collision-free across processes via the pid component."""
    return f"{prefix}-{_RUN}-{next(_COUNTER):04x}"


def current_trace_id() -> Optional[str]:
    """The innermost ambient trace id (None outside any context)."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def trace_context(trace_id: str):
    """Make ``trace_id`` ambient for the block: every record the
    registry emits inside (spans, windows, step/ckpt/spec records)
    carries it unless the emitter stamped an explicit ``trace_id=``
    field (per-request serve events do — interleaved requests cannot
    share one ambient id). Nests; two list ops per block."""
    _STACK.append(str(trace_id))
    try:
        yield trace_id
    finally:
        _STACK.pop()


# --- anomaly flight recorder -------------------------------------------------

class FlightRecorder:
    """Bounded ring of the most recent raw monitor records, dumped to a
    timestamped JSON file on demand. The registry's emit path feeds the
    ring directly (post-jsonify, pre-sink), so it accumulates even when
    the registry has NO sink attached — a degraded run is debuggable
    post-hoc without paying for a full JSONL stream.

    The dump is one ``flight_recorder_dump`` record, field for field the
    reference's (whose schema module validates it), carrying the ring
    verbatim plus the dump instant on both clocks.
    """

    def __init__(self, capacity: int = 256, out_dir: str = ".",
                 prefix: str = "flight"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.out_dir = str(out_dir)
        self.prefix = str(prefix)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.dumps: List[str] = []
        self._seen_reasons: set = set()

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: Dict[str, Any]) -> None:
        self._ring.append(rec)

    def dump(self, reason: str, *, once: bool = False) -> Optional[str]:
        """Write the ring to ``<out_dir>/<prefix>-<pid>-<n>-<wall>.json``
        and return the path. ``once=True`` dedups by reason (the anomaly
        layer's mode: the FIRST SLO burn dumps, the thousandth does
        not). The ring is NOT cleared — a later, worse anomaly still
        sees the full recent history."""
        if once and reason in self._seen_reasons:
            return None
        self._seen_reasons.add(reason)
        from apex_tpu_torch.monitor.registry import (SCHEMA_VERSION,
                                               _process_index, _rank_info)
        events = list(self._ring)
        wall = time.time()
        rec = {
            "schema": SCHEMA_VERSION,
            "kind": "flight_recorder_dump",
            "reason": str(reason),
            "capacity": self.capacity,
            "num_events": len(events),
            "mono_ns": monotonic_ns(),
            "wall_s": wall,
            "pid": os.getpid(),
            "process": _process_index(),
            "rank": _rank_info(),
            "events": events,
        }
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir,
            f"{self.prefix}-{os.getpid()}-{len(self.dumps)}-{int(wall)}.json")
        with open(path, "w") as fh:
            json.dump(rec, fh)
        self.dumps.append(path)
        return path


# the process-wide recorder; None = no ring, zero cost on the emit path
# beyond one attribute load + is-None test
_FLIGHT: Optional[FlightRecorder] = None


def enable_flight_recorder(capacity: int = 256, out_dir: str = ".", *,
                           prefix: str = "flight",
                           signals: bool = False) -> FlightRecorder:
    """Install the process-wide flight recorder (the registry's emit
    path starts feeding it immediately). ``signals=True`` additionally
    chains a SIGTERM handler that dumps before the previous disposition
    runs. Records only accumulate while the monitor registry is
    enabled — a sink is NOT required (that is the point)."""
    global _FLIGHT
    _FLIGHT = FlightRecorder(capacity, out_dir, prefix=prefix)
    if signals:
        install_signal_handler()
    return _FLIGHT


def disable_flight_recorder() -> None:
    global _FLIGHT
    _FLIGHT = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _FLIGHT


def flight_dump(reason: str, *, once: bool = True) -> Optional[str]:
    """Dump the process-wide ring (no-op returning None when no
    recorder is installed). ``once=True`` (the default — what the
    anomaly layer uses) dedups by reason."""
    fr = _FLIGHT
    if fr is None:
        return None
    return fr.dump(reason, once=once)


def install_signal_handler(signum: int = _signal.SIGTERM):
    """Chain a flight-recorder dump in front of the existing ``signum``
    disposition: the ring is written with reason ``signal:<n>`` and the
    previous handler (or the default action) then runs, so a SIGTERM'd
    degraded run leaves its last-N events behind. Returns the previous
    handler."""
    prev = _signal.getsignal(signum)

    def _handler(sig, frame):
        flight_dump(f"signal:{sig}", once=False)
        if callable(prev):
            prev(sig, frame)
        elif prev == _signal.SIG_DFL:
            _signal.signal(sig, _signal.SIG_DFL)
            os.kill(os.getpid(), sig)

    _signal.signal(signum, _handler)
    return prev


# --- TTFT / latency attribution ----------------------------------------------

# the closed component set (mirrors schema._ATTR_COMPONENTS): every
# request's [submit, finish] wall time is partitioned into exactly
# these, so their sum IS the measured e2e latency up to rounding
ATTR_COMPONENTS = ("queue_ms", "prefill_ms", "decode_ms", "spec_ms",
                   "spec_rewind_ms", "preempt_wait_ms", "recompute_ms",
                   "swap_pause_ms")


def _request_timelines(records: Iterable[Dict[str, Any]]
                       ) -> Tuple[Dict[int, Dict[str, Any]],
                                  List[Dict[str, Any]]]:
    """Reconstruct each request's lifecycle from ``serve_event``
    records (a JSONL stream's dicts, or the telemetry's in-memory
    ledger — same shape): per rid, the component ledger, the named
    phase intervals (for the Chrome export), the spec round slices,
    and the submit/finish stamps. Engine-level events (rid -1) return
    separately; ``swap`` events with a duration are carved out of any
    decode interval that contains them (the whole slot array pauses
    for a hot-swap)."""
    serve_events: List[Tuple[float, int, Dict[str, Any]]] = []
    for idx, r in enumerate(records):
        if r.get("kind") != "serve_event" or "rid" not in r:
            continue
        serve_events.append((float(r.get("at_s", 0.0)), idx, r))
    serve_events.sort(key=lambda t: (t[0], t[1]))  # stable on emit order

    by_rid: Dict[int, List[Dict[str, Any]]] = {}
    engine: List[Dict[str, Any]] = []
    for _, _, e in serve_events:
        rid = int(e["rid"])
        (engine if rid == -1 else by_rid.setdefault(rid, [])).append(e)
    swaps = [e for e in engine if e.get("phase") == "swap"]

    out: Dict[int, Dict[str, Any]] = {}
    for rid, evs in sorted(by_rid.items()):
        row = {c: 0.0 for c in ATTR_COMPONENTS}
        intervals: List[Tuple[str, float, float]] = []
        decode_ivs: List[Tuple[float, float]] = []
        spec_slices: List[Tuple[float, float, str]] = []
        state: Optional[str] = None  # queued|prefill|recompute|decode|preempt
        mark: Optional[float] = None
        submit_at = finish_at = None
        trace_id: Optional[str] = None
        evictions = spec_rounds = 0

        def close(upto: float) -> None:
            # fold the open interval [mark, upto) into its component
            nonlocal mark
            if state is None or mark is None:
                return
            if state == "decode":
                decode_ivs.append((mark, upto))
            else:
                key = {"queued": "queue_ms", "prefill": "prefill_ms",
                       "recompute": "recompute_ms",
                       "preempt": "preempt_wait_ms"}[state]
                row[key] += (upto - mark) * 1e3
                name = {"queued": "queue", "preempt": "preempt"}.get(
                    state, state)
                intervals.append((name, mark, upto))
            mark = upto

        for e in evs:
            ph, at = e.get("phase"), float(e.get("at_s", 0.0))
            if trace_id is None and e.get("trace_id"):
                trace_id = e["trace_id"]
            if ph == "submit":
                submit_at = at
                state, mark = "queued", at
            elif ph == "admit":
                close(at)
                state = "recompute" if e.get("resumed") else "prefill"
                mark = at
            elif ph == "first_token":
                close(at)
                state, mark = "decode", at
            elif ph == "decode":
                if e.get("resumed"):
                    close(at)  # the re-prefill's recompute ends here
                if state != "decode":
                    state, mark = "decode", at
            elif ph == "spec":
                spec_rounds += 1
                dur_s = float(e.get("dur_ms") or 0.0) * 1e-3
                key = ("spec_ms" if int(e.get("accepted_len") or 0) > 0
                       else "spec_rewind_ms")
                row[key] += dur_s * 1e3
                spec_slices.append((at - dur_s, at, key))
            elif ph == "evict":
                evictions += 1
                close(at)
                state, mark = "preempt", at
            elif ph == "finish":
                finish_at = at
                close(at)
                state, mark = None, None

        # decode is the interval REMAINDER: raw decode wall minus the
        # spec rounds and swap pauses that ran inside it — the
        # partition property (components sum to e2e) falls out
        decode_raw_s = sum(b - a for a, b in decode_ivs)
        for s in swaps:
            s_at = float(s.get("at_s", 0.0))
            s_dur = float(s.get("dur_ms") or 0.0)
            if s_dur and any(a <= s_at <= b for a, b in decode_ivs):
                row["swap_pause_ms"] += s_dur
        carve = (row["spec_ms"] + row["spec_rewind_ms"]
                 + row["swap_pause_ms"])
        row["decode_ms"] = max(decode_raw_s * 1e3 - carve, 0.0)
        intervals.extend(("decode", a, b) for a, b in decode_ivs)

        out[rid] = dict(row=row, intervals=intervals,
                        spec_slices=spec_slices, submit_at=submit_at,
                        finish_at=finish_at, trace_id=trace_id,
                        evictions=evictions, spec_rounds=spec_rounds)
    return out, engine


def serve_attribution(records: Iterable[Dict[str, Any]], *,
                      per_request: bool = True) -> Dict[str, Any]:
    """The ``serve_attribution`` record's fields from a record stream
    (or the telemetry's in-memory event ledger). Pass the result to
    :meth:`MetricsRegistry.emit_serve_attribution` with a status (OK
    only for real-hardware measurements, like every bench record).
    Requests without both a ``submit`` and a ``finish`` event are
    counted in ``unattributed``, never silently rowed."""
    timelines, _ = _request_timelines(records)
    rows: List[Dict[str, Any]] = []
    unattributed = 0
    for rid, t in sorted(timelines.items()):
        if t["submit_at"] is None or t["finish_at"] is None:
            unattributed += 1
            continue
        e2e = (t["finish_at"] - t["submit_at"]) * 1e3
        comp = sum(t["row"].values())
        r: Dict[str, Any] = {"rid": rid}
        if t["trace_id"]:
            r["trace_id"] = t["trace_id"]
        r.update({k: round(v, 3) for k, v in t["row"].items()})
        r.update(e2e_ms=round(e2e, 3), components_ms=round(comp, 3),
                 residual_pct=(round(abs(comp - e2e) / e2e * 100.0, 3)
                               if e2e > 0 else 0.0),
                 evictions=t["evictions"], spec_rounds=t["spec_rounds"])
        rows.append(r)
    fields: Dict[str, Any] = dict(
        requests=len(rows),
        unattributed=unattributed,
        components={c: round(sum(r[c] for r in rows), 3)
                    for c in ATTR_COMPONENTS},
        e2e_ms_total=round(sum(r["e2e_ms"] for r in rows), 3),
        components_ms_total=round(sum(r["components_ms"] for r in rows),
                                  3),
        max_residual_pct=(max(r["residual_pct"] for r in rows)
                          if rows else
                          ("skipped", "no finished requests in stream")),
    )
    if per_request:
        fields["per_request"] = rows
    return fields


# --- Chrome/Perfetto trace-event export --------------------------------------

def chrome_trace(records: Iterable[Dict[str, Any]],
                 device_events=None) -> Dict[str, Any]:
    """Merge a monitor JSONL stream into Chrome trace-event JSON
    (``chrome://tracing`` / Perfetto): one track per rank (span
    records on the unified ``t_ns`` clock), one per serve engine
    (rid -1 lifecycle events: stragglers, swaps), and one NAMED track
    per request whose queue / prefill / decode / spec / preempt slices
    all carry the request's ``trace_id``. ``device_events`` must be
    None: the reference merges a ``prof.trace_reader`` device trace
    there, which the port does not have yet (``TypeError`` otherwise).

    Serve-clock events join the span clock through each record's
    ``t_ns`` stamp (the median ``t_ns - at_s`` offset of the stream);
    streams predating the unified clock export with a zero offset —
    request tracks stay mutually consistent, only rank↔request skew is
    then unknowable."""
    if device_events is not None:
        raise TypeError(
            "chrome_trace(device_events=...) merges a prof.trace_reader "
            "device trace; apex_tpu_torch has no prof/ module yet, so "
            "there is no device trace to pass — export the host stream "
            "alone (device_events=None)")
    recs = list(records)
    spans = [r for r in recs if r.get("kind") == "span"]
    clock_syncs = [r for r in recs if r.get("kind") == "clock_sync"]
    offs = sorted(
        r["t_ns"] - float(r.get("at_s", 0.0)) * 1e9
        for r in recs
        if r.get("kind") == "serve_event"
        and isinstance(r.get("t_ns"), int) and "at_s" in r)
    off_ns = offs[len(offs) // 2] if offs else 0.0

    events: List[Dict[str, Any]] = []
    pids: Dict[Any, int] = {}

    def pid_of(key: Any, name: str) -> int:
        if key not in pids:
            pids[key] = len(pids) + 1
            events.append({"ph": "M", "pid": pids[key],
                           "name": "process_name",
                           "args": {"name": name}})
        return pids[key]

    def us(at_s: float) -> float:
        return (at_s * 1e9 + off_ns) / 1e3

    for s in spans:
        pid = pid_of(("rank", s.get("process", 0), s.get("rank", "")),
                     f"rank {s.get('rank', '?')} "
                     f"(process {s.get('process', 0)})")
        args = {k: s[k] for k in ("coll", "axis", "bytes", "traced",
                                  "step", "trace_id") if k in s}
        events.append({"ph": "X", "pid": pid, "tid": 1,
                       "name": s.get("name", "span"),
                       "ts": s.get("t0_ns", 0) / 1e3,
                       "dur": max(s.get("dur_ns", 0), 1) / 1e3,
                       "args": args})

    timelines, engine = _request_timelines(recs)
    for e in engine:  # stragglers + swaps: the engine's own track
        pid = pid_of(("engine", e.get("process", 0)),
                     f"serve engine (process {e.get('process', 0)})")
        dur_ms = float(e.get("dur_ms") or 0.0)
        at = float(e.get("at_s", 0.0))
        name = e.get("phase", "event")
        if e.get("straggler"):
            name = "straggler_step"
        args = {k: e[k] for k in ("step", "swap_source",
                                  "ratio_to_median", "trace_id")
                if k in e}
        events.append({"ph": "X", "pid": pid, "tid": 1, "name": name,
                       "ts": us(at - dur_ms * 1e-3),
                       "dur": max(dur_ms * 1e3, 1.0), "args": args})

    for rid, t in sorted(timelines.items()):
        label = f"req {rid}"
        if t["trace_id"]:
            label += f" [{t['trace_id']}]"
        pid = pid_of(("req", rid), label)
        args = {"rid": rid}
        if t["trace_id"]:
            args["trace_id"] = t["trace_id"]
        for name, a, b in sorted(t["intervals"], key=lambda x: x[1]):
            events.append({"ph": "X", "pid": pid, "tid": 1, "name": name,
                           "ts": us(a),
                           "dur": max((b - a) * 1e6, 0.001),
                           "args": dict(args)})
        for a, b, key in t["spec_slices"]:
            events.append({"ph": "X", "pid": pid, "tid": 2,
                           "name": ("spec" if key == "spec_ms"
                                    else "spec_rewind"),
                           "ts": us(a),
                           "dur": max((b - a) * 1e6, 0.001),
                           "args": dict(args)})
        if t["spec_slices"]:
            events.append({"ph": "M", "pid": pid, "tid": 2,
                           "name": "thread_name",
                           "args": {"name": "spec rounds"}})

    out: Dict[str, Any] = {"traceEvents": events,
                           "displayTimeUnit": "ms"}
    if clock_syncs:
        out["otherData"] = {"clock_sync": clock_syncs[0]}
    return out


def write_chrome_trace(path: str, records: Iterable[Dict[str, Any]],
                       device_events=None, *,
                       doc: Optional[Dict[str, Any]] = None) -> str:
    """Write :func:`chrome_trace` to ``path`` (gzipped when it ends in
    ``.gz`` — both chrome://tracing and Perfetto load either form).
    Returns the path. ``doc`` short-circuits the build when the caller
    already holds the :func:`chrome_trace` result (the CLI inspects it
    before writing)."""
    trace = chrome_trace(records, device_events) if doc is None else doc
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as fh:
            json.dump(trace, fh)
    else:
        with open(path, "w") as fh:
            json.dump(trace, fh)
    return path
