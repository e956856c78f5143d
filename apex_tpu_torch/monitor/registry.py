"""Host-side metrics registry + structured JSONL event stream.

Port of ``apex_tpu/monitor/registry.py`` (plain host Python): a single
process-wide :class:`MetricsRegistry` holding

* **counters**   — monotonically increasing totals;
* **gauges**     — last-value observations;
* **timers**     — (count, total seconds) accumulators driven by the
  :meth:`MetricsRegistry.timer` context manager;

and a structured **JSONL emitter**: every record is one JSON object per
line, stamped with the schema version, wall-clock offset, host process
index and the rank string registered via
:func:`apex_tpu_torch.utils.logging.set_rank_info`. The records are the
reference's, field for field, so the reference's validator
(``apex_tpu/monitor/schema.py``) accepts the port's stream. The records
here are those the port emits today (``meta``, ``event``, ``serve_event``
through :meth:`MetricsRegistry.emit`, and ``serve_window``); each other
``emit_*`` of the reference comes with the slice whose code emits it.

Design constraints (in priority order):

1. **Near-zero overhead when disabled.** The module-level registry is
   ``None`` until :func:`enable` is called; every public entry point and
   every instrumentation hook starts with a single attribute load and
   ``is None`` test — no dict lookups, no string formatting, no device
   syncs.
2. **Honest artifacts.** :func:`check_record_honesty` refuses any record
   that claims success (``ok: true`` / ``status: "OK"``) while carrying a
   non-finite number anywhere in its payload; the emitter enforces it on
   every write.
3. **Host-side by construction.** Hooks read state the caller already
   holds on the host; a tensor handed to a record is read back once, when
   the record is built.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Any, Dict, Optional, TextIO

# trace imports nothing from the monitor package at module level (it
# lazy-imports this module inside functions), so this edge is acyclic;
# emit() reads its ambient trace-id stack and flight-recorder ring
# directly as attribute loads to keep the per-record cost flat
from apex_tpu_torch.monitor import trace as _trace

SCHEMA_VERSION = 1

# The process-wide registry. ``None`` means monitoring is disabled and every
# hook is a two-instruction no-op.
_REGISTRY: Optional["MetricsRegistry"] = None


def _rank_info() -> str:
    from apex_tpu_torch.utils import logging as log_util

    return log_util.get_rank_info()


def _process_index() -> int:
    from apex_tpu_torch.utils import logging as log_util

    try:
        return int(log_util.process_index())
    except (TypeError, ValueError):
        return 0


# --- honesty checks ----------------------------------------------------------

def _nonfinite_paths(obj: Any, path: str = "") -> list:
    """Paths of every non-finite float inside ``obj`` (dicts/lists/floats)."""
    bad = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            bad.extend(_nonfinite_paths(v, f"{path}.{k}" if path else str(k)))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            bad.extend(_nonfinite_paths(v, f"{path}[{i}]"))
    elif isinstance(obj, float) and not math.isfinite(obj):
        bad.append(path or "<root>")
    return bad


_NONFINITE_STRINGS = {"nan", "inf", "-inf", "infinity", "-infinity"}


def _stringified_nonfinite_paths(obj: Any, path: str = "") -> list:
    """Paths of stringified non-finite values ('nan'/'inf'...) — what
    :func:`_jsonify` turns non-finite floats into. Skip-reason prose
    (``reason`` keys) is exempt."""
    bad = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "reason":
                continue
            bad.extend(_stringified_nonfinite_paths(
                v, f"{path}.{k}" if path else str(k)))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            bad.extend(_stringified_nonfinite_paths(v, f"{path}[{i}]"))
    elif isinstance(obj, str) and obj.strip().lower() in _NONFINITE_STRINGS:
        bad.append(path or "<root>")
    return bad


def _claims_success(record: Dict[str, Any]) -> bool:
    if record.get("ok") is True:
        return True
    status = record.get("status")
    return isinstance(status, str) and status.upper() == "OK"


def check_record_honesty(record: Dict[str, Any]) -> None:
    """Raise ``ValueError`` if ``record`` reports success but contains a
    non-finite number — as a float OR already stringified (the emitter
    checks the post-:func:`_jsonify` form, so numpy or torch nan scalars
    cannot slip through as strings). A metric that could not be measured must be
    encoded as an explicit skip (``{"skipped": true, "reason": ...}``),
    never as ``nan`` riding inside an OK artifact."""
    if _claims_success(record):
        bad = _nonfinite_paths(record) + _stringified_nonfinite_paths(record)
        if bad:
            raise ValueError(
                "refusing to emit a success record carrying non-finite "
                f"values at {bad}; encode unmeasured metrics as "
                '{"skipped": true, "reason": ...} instead'
            )


def _jsonify(obj: Any) -> Any:
    """Make ``obj`` strictly JSON-serializable: numpy scalars, torch
    scalars and 0-d (or one-element) tensors become Python numbers, and
    non-finite floats become explicit strings (plain ``json`` would emit
    the invalid literal ``NaN``). A larger tensor or array becomes its
    ``str``."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, (int, str)):
        return obj
    if isinstance(obj, float):
        # float() first: numpy's float64 subclasses float, and under numpy
        # 2 its repr is 'np.float64(nan)', which the honesty check would
        # not recognise (the reference's registry lets it through)
        obj = float(obj)
        if math.isfinite(obj):
            return obj
        return repr(obj)  # 'nan' / 'inf' / '-inf', flagged by validators
    # numpy scalars and 0-d arrays; torch 0-d tensors (a CUDA one is read
    # back to the host here: the caller asked for its value)
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return _jsonify(item())
        except (TypeError, ValueError, RuntimeError):
            # numpy raises ValueError, torch RuntimeError, for more than
            # one element
            pass
    return str(obj)


class MetricsRegistry:
    """Counters, gauges and timers with an optional JSONL sink.

    All mutation happens on the host; values are plain Python numbers.
    One registry is typically installed process-wide via :func:`enable`,
    but standalone instances work too (tests construct their own).
    """

    def __init__(self, sink: Optional[TextIO] = None, *,
                 clock=time.perf_counter):
        self._sink = sink
        self._owns_sink = False
        self._buffering = 0
        self._clock = clock
        self._t0 = clock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.timers: Dict[str, list] = {}  # name -> [count, total_s]

    # -- primitive metrics ---------------------------------------------------

    def counter(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe_seconds(self, name: str, seconds: float) -> None:
        slot = self.timers.setdefault(name, [0, 0.0])
        slot[0] += 1
        slot[1] += seconds

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.observe_seconds(name, self._clock() - t0)

    # -- event stream --------------------------------------------------------

    def emit(self, kind: str, **fields) -> Dict[str, Any]:
        """Emit one structured record; returns the record dict (written as
        one JSONL line when a sink is attached)."""
        record = {
            "schema": SCHEMA_VERSION,
            "kind": kind,
            "t_s": round(self._clock() - self._t0, 6),
            # the unified clock: perf_counter_ns shares CLOCK_MONOTONIC
            # with span t0_ns and the serve clock, so every stream joins
            # on one base (the per-process clock_sync record anchors it
            # to wall time)
            "t_ns": _trace.monotonic_ns(),
            "process": _process_index(),
            "rank": _rank_info(),
        }
        if _trace._STACK:
            record["trace_id"] = _trace._STACK[-1]
        record.update(fields)  # explicit trace_id=/t_ns= fields win
        # jsonify BEFORE the honesty check: numpy/torch nan scalars become
        # python floats/strings first, so they cannot evade the check
        record = _jsonify(record)
        check_record_honesty(record)
        fr = _trace._FLIGHT
        if fr is not None:
            # the flight ring sees every record even with NO sink — that
            # is what makes degraded sink-less runs debuggable post-hoc
            fr._ring.append(record)
        if self._sink is not None:
            self._sink.write(json.dumps(record) + "\n")
            if not self._buffering:
                self._sink.flush()
        return record

    @contextlib.contextmanager
    def buffered(self):
        """Suppress the per-record sink flush inside the block (one
        flush on exit). High-rate emitters (the serving telemetry's
        per-transition lifecycle records) wrap their hot loop in this:
        the OS still sees every line in order, just without an fsync-ish
        flush per token-scale event. Nests; flushes when the outermost
        block exits."""
        self._buffering += 1
        try:
            yield
        finally:
            self._buffering -= 1
            if self._buffering == 0 and self._sink is not None:
                self._sink.flush()

    def emit_meta(self, **fields) -> Dict[str, Any]:
        """Run header: device/model facts the report needs (device kind,
        peak FLOP/s, model FLOPs per token, config)."""
        return self.emit("meta", **fields)

    def emit_event(self, name: str, **fields) -> Dict[str, Any]:
        return self.emit("event", name=name, **fields)

    def _emit_status_record(self, kind: str, status: str,
                            **fields) -> Dict[str, Any]:
        """Shared construction for the status-carrying records
        (``serve_window`` here): "OK" puts the record under the
        honesty rule (finite numbers or explicit ``("skipped", reason)``
        tuples only); "SKIP" requires a ``reason``."""
        if status not in ("OK", "SKIP"):
            raise ValueError(f"status must be OK|SKIP, got {status!r}")
        if status == "SKIP" and not fields.get("reason"):
            raise ValueError(f"a SKIP {kind} record must carry a reason")
        for name, v in list(fields.items()):
            if (isinstance(v, tuple) and len(v) == 2
                    and v[0] == "skipped"):
                fields[name] = {"skipped": True, "reason": str(v[1])}
        return self.emit(kind, status=status, **fields)

    def emit_serve_window(self, status: str, **fields) -> Dict[str, Any]:
        """The live ``serve_window`` record
        (:meth:`apex_tpu_torch.serving.telemetry.ServeTelemetry.
        maybe_window`): sliding-window tokens/s, latency quantiles,
        queue/occupancy/pool state and the ``serve_anomaly`` section."""
        return self._emit_status_record("serve_window", status, **fields)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self._sink is not None and self._owns_sink:
            self._sink.close()
        self._sink = None


# --- module-level enable/disable ---------------------------------------------

def enable(path: Optional[str] = None, *,
           stream: Optional[TextIO] = None,
           append: bool = False) -> MetricsRegistry:
    """Install the process-wide registry.

    ``path`` opens a JSONL file — truncated by default so one file is one
    run and ``monitor report`` never mixes a stale run's steps into this
    run's headline; pass ``append=True`` to accumulate runs (the report
    then only aggregates the last run, split at ``meta`` records).
    ``stream`` attaches an already-open text sink; with neither, metrics
    accumulate in memory only. Returns the registry. Idempotent in the
    sense that a second call replaces the first registry (closing its
    sink if owned).
    """
    global _REGISTRY
    # open the new sink BEFORE tearing down the old registry: a failed
    # enable (bad path, path+stream) must leave the active stream intact
    sink = stream
    owns = False
    if path is not None:
        if stream is not None:
            raise ValueError("pass either path or stream, not both")
        sink = open(path, "a" if append else "w")
        owns = True
    if _REGISTRY is not None:
        _REGISTRY.close()
    reg = MetricsRegistry(sink)
    reg._owns_sink = owns
    _REGISTRY = reg
    # one clock_sync per process: the monotonic<->wall anchor that lets
    # `monitor trace` join streams from different processes (and a
    # device trace) without skew. Emitted before any meta record, so
    # consumers must read the whole stream, not the last-run split.
    reg.emit("clock_sync", mono_ns=_trace.monotonic_ns(),
             wall_s=time.time(), clock="perf_counter_ns",
             pid=os.getpid())
    return reg


def disable() -> None:
    """Tear down the process-wide registry; hooks return to no-ops."""
    global _REGISTRY
    if _REGISTRY is not None:
        _REGISTRY.close()
    _REGISTRY = None


def enabled() -> bool:
    return _REGISTRY is not None


def get_registry() -> Optional[MetricsRegistry]:
    return _REGISTRY


def enable_from_env(env_var: str = "APEX_TPU_MONITOR") -> Optional[MetricsRegistry]:
    """Enable when ``$APEX_TPU_MONITOR`` names a JSONL path; no-op
    otherwise."""
    path = os.environ.get(env_var)
    if not path:
        return None
    return enable(path)


# module-level conveniences mirroring the registry methods; all are no-ops
# while disabled (one load + one is-None test on the fast path)

def counter(name: str, value: float = 1) -> None:
    r = _REGISTRY
    if r is not None:
        r.counter(name, value)


def gauge(name: str, value: float) -> None:
    r = _REGISTRY
    if r is not None:
        r.gauge(name, value)


def observe_seconds(name: str, seconds: float) -> None:
    r = _REGISTRY
    if r is not None:
        r.observe_seconds(name, seconds)


@contextlib.contextmanager
def timer(name: str):
    r = _REGISTRY
    if r is None:
        yield
    else:
        with r.timer(name):
            yield


def emit_event(name: str, **fields) -> Optional[Dict[str, Any]]:
    r = _REGISTRY
    if r is not None:
        return r.emit_event(name, **fields)
    return None


def emit_meta(**fields) -> Optional[Dict[str, Any]]:
    r = _REGISTRY
    if r is not None:
        return r.emit_meta(**fields)
    return None


def emit_serve_window(status: str, **fields) -> Optional[Dict[str, Any]]:
    r = _REGISTRY
    if r is not None:
        return r.emit_serve_window(status, **fields)
    return None
