"""Step-anatomy span instrumentation: host enter/exit timestamps + the
profiler range that joins a span to the kernels launched inside it.

Port of ``apex_tpu/monitor/spans.py``. The reference's pyprof joined NVTX
ranges to kernels through the nvprof database; the TPU reference uses
``jax.named_scope``. Here a :func:`span` does the same double duty:

* **host side** — when monitoring is enabled, it records a monotonic-ns
  enter/exit pair and emits one ``span`` record (rank-tagged, on the same
  JSONL stream as the serving lifecycle records) with any caller attrs;
* **device side** — it enters ``torch.profiler.record_function(name)``,
  PyTorch's range: a ``torch.profiler`` trace shows it around every kernel
  launched inside, and its events carry those kernels' device time, so a
  profile of a serve splits the card's time by ``serve_prefill`` /
  ``serve_decode`` / ``serve_spec`` / ``serve_spec_tree``.

PyTorch runs eagerly, so a span's host window is execution, never tracing:
its records never carry the reference's ``traced`` flag.

Disabled cost: one registry load + ``is None`` test, then a bare ``yield``
— no ``record_function`` entered, no clock read (the contract of every
monitor hook). A profiler trace therefore shows the ranges only while
monitoring is enabled.
"""

from __future__ import annotations

import contextlib

from apex_tpu_torch.monitor import registry as _reg
# THE unified clock (trace.monotonic_ns == time.perf_counter_ns): span
# t0_ns, registry t_ns and the serve clock share one CLOCK_MONOTONIC base
from apex_tpu_torch.monitor.trace import monotonic_ns

# the active span path, innermost last (one serving or training loop per
# process: a plain list keeps the enabled path at two list ops per span)
_STACK: list = []


def span_path() -> str:
    """The current span path ("" at top level): the ``/``-joined names of
    the spans entered and not yet left."""
    return "/".join(_STACK)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Instrument a region: ``with span("serve_decode"): ...``.

    Emits one ``span`` record on exit — ``name`` is the full ``/``-joined
    path of nested spans, ``t0_ns``/``dur_ns`` the monotonic host window —
    and wraps the body in ``torch.profiler.record_function(name)``.
    ``attrs`` pass through to the record. No-op while monitoring is
    disabled. (The reference's ``collective_span`` comes with the port's
    first collective.)
    """
    r = _reg.get_registry()
    if r is None:
        yield
        return
    from torch.profiler import record_function

    _STACK.append(name)
    path = "/".join(_STACK)
    t0 = monotonic_ns()
    try:
        with record_function(name):
            yield
    finally:
        dur = monotonic_ns() - t0
        _STACK.pop()
        # the registry may have been torn down inside the body
        r = _reg.get_registry()
        if r is not None:
            r.emit("span", name=path, t0_ns=t0, dur_ns=dur, **attrs)
