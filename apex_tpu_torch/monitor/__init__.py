"""Port of :mod:`apex_tpu.monitor`: the host-side telemetry layer.

* :mod:`~apex_tpu_torch.monitor.registry` — the process-wide metrics
  registry (counters / gauges / timers) and its JSONL record stream,
  rank-tagged, near-zero cost when disabled, with the honesty rule on
  every success record;
* :mod:`~apex_tpu_torch.monitor.histogram` — bounded-memory streaming
  latency histograms;
* :mod:`~apex_tpu_torch.monitor.spans` — host spans inside
  ``torch.profiler.record_function`` ranges;
* :mod:`~apex_tpu_torch.monitor.trace` — request trace ids, the unified
  clock, per-request latency attribution, Chrome-trace export and the
  anomaly flight recorder.

The reference's ``hooks``, ``schema``, ``report``, the ``python -m``
entry, ``collective_span`` and the ``emit_*`` of records nothing in the
port produces yet are not ported (ROADMAP queue 1, items 6 and 8). Quick
start::

    from apex_tpu_torch import monitor

    monitor.enable("events.jsonl")          # or APEX_TPU_MONITOR=...
    engine.serve(params, requests)          # auto-attaches ServeTelemetry
    monitor.disable()
"""

from apex_tpu_torch.monitor.registry import (  # noqa: F401
    SCHEMA_VERSION,
    MetricsRegistry,
    check_record_honesty,
    counter,
    disable,
    emit_event,
    emit_meta,
    emit_serve_window,
    enable,
    enable_from_env,
    enabled,
    gauge,
    get_registry,
    observe_seconds,
    timer,
)
from apex_tpu_torch.monitor.histogram import StreamingHistogram  # noqa: F401
from apex_tpu_torch.monitor.spans import span, span_path  # noqa: F401
from apex_tpu_torch.monitor import trace  # noqa: F401
from apex_tpu_torch.monitor.trace import (  # noqa: F401
    chrome_trace,
    current_trace_id,
    enable_flight_recorder,
    disable_flight_recorder,
    flight_dump,
    get_flight_recorder,
    new_trace_id,
    serve_attribution,
    trace_context,
    write_chrome_trace,
)
