"""Port parity: apex_tpu_torch.monitor (registry, trace, histogram, spans)
and utils.logging against apex_tpu's, on the same inputs.

Everything here is host Python, so the bar is identity: histogram
quantiles bit for bit, attribution and Chrome-trace documents equal as
dicts, records equal field for field but for the clock stamps (``t_s``,
``t_ns``) and the trace ids (each package counts its own), and the port's
JSONL stream accepted by the reference's validator.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from apex_tpu import monitor as jmon
from apex_tpu.monitor import histogram as jhist
from apex_tpu.monitor import registry as jreg
from apex_tpu.monitor import trace as jtrace
from apex_tpu_torch import monitor as tmon
from apex_tpu_torch.monitor import histogram as thist
from apex_tpu_torch.monitor import registry as treg
from apex_tpu_torch.monitor import spans as tspans
from apex_tpu_torch.monitor import trace as ttrace
from apex_tpu_torch.utils import logging as tlog

CLOCK_FIELDS = ("t_s", "t_ns", "mono_ns", "wall_s", "pid")


@pytest.fixture(autouse=True)
def _both_disabled():
    jmon.disable()
    tmon.disable()
    yield
    jmon.disable()
    tmon.disable()
    jtrace.disable_flight_recorder()
    ttrace.disable_flight_recorder()


def _stream(seed, n=4000):
    """Latencies in ms as a serve produces them, plus the edges: zeros and
    negatives (underflow), values past hi (overflow), exact bucket edges."""
    rng = np.random.default_rng(seed)
    vals = list(rng.lognormal(mean=1.0, sigma=1.5, size=n))
    vals += [0.0, -1.0, 1e-6, 1e-4, 1e8, 3e8, 10.0, 100.0, 1.0]
    rng.shuffle(vals)
    return [float(v) for v in vals]


QS = [0.0, 0.001, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999, 1.0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("geometry", [dict(), dict(lo=1e-3, hi=1e4,
                                                   bins_per_decade=16)])
def test_histogram_quantiles_bit_identical(seed, geometry):
    j = jhist.StreamingHistogram(**geometry)
    t = thist.StreamingHistogram(**geometry)
    for v in _stream(seed):
        j.add(v)
        t.add(v)
    assert t._counts == j._counts
    assert (t.count, t.sum, t.min, t.max) == (j.count, j.sum, j.min, j.max)
    for q in QS:
        assert t.quantile(q) == j.quantile(q), q
    assert t.summary("x_") == j.summary("x_")
    for v in (0.5, 7.3, 1e5, 2e8):
        assert t.bucket_edges(v) == j.bucket_edges(v)
        assert t.bucket_width(v) == j.bucket_width(v)


def test_histogram_merge_reset_and_refusals_match():
    js = [jhist.StreamingHistogram() for _ in range(2)]
    ts = [thist.StreamingHistogram() for _ in range(2)]
    for k in range(2):
        for v in _stream(10 + k, 500):
            js[k].add(v, n=2)
            ts[k].add(v, n=2)
    js[0].merge(js[1])
    ts[0].merge(ts[1])
    assert [ts[0].quantile(q) for q in QS] == [js[0].quantile(q) for q in QS]
    assert ts[0].mean == js[0].mean
    ts[0].reset()
    js[0].reset()
    assert ts[0].quantile(0.5) is None and js[0].quantile(0.5) is None
    assert ts[0].summary() == {} == js[0].summary()
    with pytest.raises(ValueError, match="nan"):
        ts[0].add(float("nan"))
    with pytest.raises(ValueError, match="geometries differ"):
        ts[0].merge(thist.StreamingHistogram(bins_per_decade=8))
    with pytest.raises(ValueError, match="q must be"):
        ts[1].quantile(1.5)


def test_trace_ids_and_context_nesting():
    a = ttrace.new_trace_id("req")
    b = ttrace.new_trace_id("serve")
    j = jtrace.new_trace_id("req")
    # one format: <prefix>-<pid hex>-<seq hex>, monotone within a process
    for tid, want in ((a, "req"), (b, "serve")):
        prefix, pid, seq = tid.split("-")
        assert prefix == want and pid == f"{os.getpid():x}"
        assert len(seq) >= 4 and int(seq, 16) >= 1
    assert j.split("-")[:2] == a.split("-")[:2]
    assert int(b.split("-")[2], 16) == int(a.split("-")[2], 16) + 1
    seen = []
    for mod in (ttrace, jtrace):
        log = []
        log.append(mod.current_trace_id())
        with mod.trace_context("outer") as got:
            log.append((got, mod.current_trace_id()))
            with mod.trace_context("inner"):
                log.append(mod.current_trace_id())
            log.append(mod.current_trace_id())
        log.append(mod.current_trace_id())
        seen.append(log)
    assert seen[0] == seen[1] == [None, ("outer", "outer"), "inner",
                                  "outer", None]


def _lifecycle_stream():
    """A recorded serve stream: two requests (one evicted and resumed, one
    with spec rounds, one all-rejected), a swap mid-decode, a straggler,
    spans, a clock_sync, and an unfinished request."""
    base = 1_000_000_000
    ev = []

    def e(at, **kw):
        r = {"schema": 1, "kind": "serve_event", "at_s": at,
             "t_ns": base + int(at * 1e9) + 123, "process": 0, "rank": ""}
        r.update(kw)
        ev.append(r)

    ev.append({"schema": 1, "kind": "clock_sync", "mono_ns": base,
               "wall_s": 1.7e9, "clock": "perf_counter_ns", "pid": 7})
    e(0.0, rid=0, phase="submit", trace_id="req-a-0001", prompt_len=20,
      max_new_tokens=8)
    e(0.0, rid=1, phase="submit", trace_id="req-a-0002", prompt_len=9,
      max_new_tokens=6)
    e(0.0, rid=2, phase="submit", trace_id="req-a-0003", prompt_len=4,
      max_new_tokens=3)
    e(0.01, rid=0, phase="admit", slot=0, queue_wait_ms=10.0,
      trace_id="req-a-0001")
    e(0.03, rid=0, phase="prefill_chunk", slot=0, chunk=0, dur_ms=20.0,
      blocks_held=2, step=0, trace_id="req-a-0001")
    e(0.04, rid=0, phase="first_token", slot=0, ttft_ms=40.0,
      trace_id="req-a-0001", step=1)
    e(0.04, rid=0, phase="decode", slot=0, step=1, trace_id="req-a-0001")
    e(0.05, rid=1, phase="admit", slot=1, queue_wait_ms=50.0,
      prefix_hit_blocks=1, trace_id="req-a-0002")
    e(0.07, rid=1, phase="first_token", slot=1, trace_id="req-a-0002",
      step=2)
    e(0.07, rid=1, phase="decode", slot=1, step=2, trace_id="req-a-0002")
    e(0.09, rid=1, phase="spec", slot=1, step=3, accepted_len=2, draft_k=4,
      dur_ms=5.0, trace_id="req-a-0002")
    e(0.10, rid=1, phase="spec", slot=1, step=4, accepted_len=0, draft_k=4,
      dur_ms=4.0, trace_id="req-a-0002")
    e(0.11, rid=-1, phase="swap", step=5, swap_source="ckpt", dur_ms=2.5)
    e(0.12, rid=-1, phase="decode", step=6, straggler=True, dur_ms=30.0,
      ratio_to_median=4.2, slots=2)
    e(0.13, rid=0, phase="evict", slot=0, step=7, evict_reason="pool_pressure",
      blocks_released=2, requeue_pos=0, generated=3, trace_id="req-a-0001")
    e(0.15, rid=1, phase="finish", slot=1, tokens=6, trace_id="req-a-0002",
      step=8)
    e(0.16, rid=0, phase="admit", slot=1, resumed=True, queue_wait_ms=30.0,
      trace_id="req-a-0001")
    e(0.19, rid=0, phase="decode", slot=1, step=9, resumed=True,
      trace_id="req-a-0001")
    e(0.25, rid=0, phase="finish", slot=1, tokens=8, trace_id="req-a-0001",
      step=12)
    for k, (name, t0, dur) in enumerate((("serve_prefill", 0.01, 0.02),
                                         ("serve_decode", 0.05, 0.01),
                                         ("serve_decode/spec_draft", 0.08,
                                          0.003))):
        ev.append({"schema": 1, "kind": "span", "name": name,
                   "t0_ns": base + int(t0 * 1e9), "dur_ns": int(dur * 1e9),
                   "process": 0, "rank": "dp0", "trace_id": "serve-a-0009",
                   "step": k})
    # emit order differs from clock order (ties broken by emit order)
    ev.insert(5, ev.pop(3))
    return ev


def test_serve_attribution_equals_the_reference():
    stream = _lifecycle_stream()
    for per_request in (True, False):
        got = ttrace.serve_attribution(stream, per_request=per_request)
        want = jtrace.serve_attribution(stream, per_request=per_request)
        assert got == want
    got = ttrace.serve_attribution(stream)
    assert got["requests"] == 2 and got["unattributed"] == 1
    assert got["components"]["swap_pause_ms"] > 0
    assert got["components"]["spec_rewind_ms"] == 4.0
    assert ttrace.ATTR_COMPONENTS == jtrace.ATTR_COMPONENTS
    # an empty stream: the explicit skip, not nan
    assert (ttrace.serve_attribution([]) == jtrace.serve_attribution([]))


def test_chrome_trace_equals_the_reference(tmp_path):
    stream = _lifecycle_stream()
    got = ttrace.chrome_trace(stream)
    assert got == jtrace.chrome_trace(stream)
    names = {e["name"] for e in got["traceEvents"] if e["ph"] == "X"}
    assert {"queue", "prefill", "decode", "preempt", "recompute", "spec",
            "spec_rewind", "swap", "straggler_step",
            "serve_prefill"} <= names
    for suffix in (".json", ".json.gz"):
        path = str(tmp_path / f"t{suffix}")
        assert ttrace.write_chrome_trace(path, stream) == path
    # the device-trace merge waits for prof/: refused, not ignored
    with pytest.raises(TypeError, match="prof"):
        ttrace.chrome_trace(stream, device_events=[{"name": "k"}])
    with pytest.raises(TypeError, match="prof"):
        ttrace.write_chrome_trace(str(tmp_path / "x.json"), stream,
                                  device_events=[])


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in CLOCK_FIELDS}


def _same_calls(reg, np_or_torch):
    """The same emits on either package's registry; returns the records."""
    out = [reg.emit_meta(device_kind="H100", config={"layers": 2}),
           reg.emit_event("warmup", n=3)]
    reg.counter("c", 2)
    reg.gauge("g", 1.5)
    reg.observe_seconds("t", 0.25)
    anomaly = dict(straggler_steps=0, queue_buildup=False, slo_burn=False,
                   leaked_blocks=0)
    out.append(reg.emit_serve_window(
        "SKIP", reason="cpu run", window_s=0.5, tokens_per_s=("skipped",
                                                              "no window"),
        queue_depth=0, serve_anomaly=anomaly))
    out.append(reg.emit_serve_window(
        "OK", window_s=0.5, tokens_per_s=np_or_torch(100.0),
        latency_p50_ms=("skipped", "none"), serve_anomaly=anomaly))
    out.append(reg.emit("serve_event", rid=3, phase="submit", at_s=0.0,
                        trace_id="req-x", prompt_len=4, max_new_tokens=2))
    return out


def test_records_match_the_reference_field_for_field():
    jsink, tsink = io.StringIO(), io.StringIO()
    jr = jreg.MetricsRegistry(jsink)
    tr = treg.MetricsRegistry(tsink)
    want = _same_calls(jr, np.float32)
    got = _same_calls(tr, torch.tensor)
    assert [_strip(g) for g in got] == [_strip(w) for w in want]
    assert treg.SCHEMA_VERSION == jreg.SCHEMA_VERSION == 1
    # the port's stream passes the reference's own validator
    assert jmon.validate_jsonl(tsink.getvalue().splitlines()) == []


def test_jsonify_turns_torch_scalars_into_numbers():
    j = treg._jsonify
    assert j(torch.tensor(3)) == 3
    assert j(torch.tensor(0.5, dtype=torch.bfloat16)) == 0.5
    assert j(torch.tensor([2.0])) == 2.0            # one element: a number
    assert j(np.float32(1.25)) == 1.25 == jreg._jsonify(np.float32(1.25))
    assert j(torch.tensor(float("nan"))) == "nan"
    assert j(torch.ones(3)) == str(torch.ones(3))   # not a scalar: its str
    assert j({"a": (torch.tensor(1), np.int64(2))}) == {"a": [1, 2]}
    assert json.dumps(j({"x": torch.tensor(float("inf"))}))


@pytest.mark.parametrize("bad", ["nan_float", "inf_nested", "nan_string",
                                 "numpy_nan", "torch_nan"])
def test_honesty_refuses_nonfinite_ok_records_as_the_reference(bad):
    payload = {
        "nan_float": {"tokens_per_s": float("nan")},
        "inf_nested": {"serve_anomaly": {"ratio": [1.0, float("inf")]}},
        "nan_string": {"latency_p50_ms": "NaN"},
        "numpy_nan": {"x": np.float32("nan")},
        "torch_nan": {"x": torch.tensor(float("nan"))},
    }[bad]
    errs = []
    for mod in (treg, jreg):
        reg = mod.MetricsRegistry()
        with pytest.raises(ValueError, match="non-finite") as ei:
            reg.emit_serve_window("OK", **payload)
        errs.append(str(ei.value))
        # a SKIP record may carry it (the reason explains it) ...
        reg.emit_serve_window("SKIP", reason="nan is the finding", **payload)
        # ... and an OK one the explicit skip tuple
        reg.emit_serve_window("OK", tokens_per_s=("skipped", "unmeasured"))
    if bad != "torch_nan":  # the reference has no torch scalars to compare
        assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="reason"):
        treg.MetricsRegistry().emit_serve_window("SKIP")
    with pytest.raises(ValueError, match="OK|SKIP"):
        treg.MetricsRegistry().emit_serve_window("MAYBE")


def test_numpy_float64_nan_is_refused():
    """numpy's float64 subclasses float, and under numpy 2 its repr is
    'np.float64(nan)': the reference's registry writes that string into an
    OK record. The port takes float() first, so the record is refused and
    a SKIP record carries the plain 'nan' (a deliberate divergence)."""
    reg = treg.MetricsRegistry()
    with pytest.raises(ValueError, match="non-finite"):
        reg.emit_serve_window("OK", x=np.float64("nan"))
    rec = reg.emit_serve_window("SKIP", reason="r", x=np.float64("inf"),
                         y=np.float64(2.5))
    assert rec["x"] == "inf" and rec["y"] == 2.5
    assert type(rec["y"]) is float


def test_enable_disable_env_and_module_level_noops(tmp_path, monkeypatch):
    assert not tmon.enabled() and tmon.get_registry() is None
    # every module-level hook is a no-op while disabled
    assert tmon.emit_serve_window("OK", x=1.0) is None
    assert tmon.emit_event("e") is None and tmon.emit_meta() is None
    with tmon.timer("t"):
        pass
    path = tmp_path / "ev.jsonl"
    monkeypatch.setenv("APEX_TPU_MONITOR", str(path))
    reg = tmon.enable_from_env()
    assert reg is tmon.get_registry() and tmon.enabled()
    tmon.emit_event("hello", n=1)
    tmon.disable()
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["clock_sync", "event"]
    assert recs[0]["clock"] == "perf_counter_ns"
    monkeypatch.delenv("APEX_TPU_MONITOR")
    assert tmon.enable_from_env() is None
    with pytest.raises(ValueError, match="either path or stream"):
        tmon.enable(str(path), stream=io.StringIO())


def test_flight_recorder_dumps_the_reference_record(tmp_path):
    for mod, reg_mod, d in ((ttrace, treg, "t"), (jtrace, jreg, "j")):
        fr = mod.enable_flight_recorder(capacity=3,
                                        out_dir=str(tmp_path / d))
        reg_mod.enable()  # no sink: the ring still fills
        for i in range(5):
            reg_mod.get_registry().emit_event("e", i=i)
        assert len(fr) == 3
        p1 = mod.flight_dump("serve_anomaly:leak")
        assert mod.flight_dump("serve_anomaly:leak") is None  # once
        p2 = mod.flight_dump("serve_anomaly:leak", once=False)
        assert p1 and p2 and p1 != p2
        reg_mod.disable()
        mod.disable_flight_recorder()
        assert mod.flight_dump("x") is None
    t = json.loads(open(next((tmp_path / "t").iterdir())).read())
    j = json.loads(open(next((tmp_path / "j").iterdir())).read())
    assert _strip(t).keys() == _strip(j).keys()
    assert [e["i"] for e in t["events"]] == [2, 3, 4]
    assert ([_strip(e) for e in t["events"]]
            == [_strip(e) for e in j["events"]])
    with pytest.raises(ValueError, match="capacity"):
        ttrace.FlightRecorder(capacity=0)


def test_span_records_and_nesting():
    sink = io.StringIO()
    tmon.enable(stream=sink)
    with ttrace.trace_context("serve-1"):
        with tspans.span("serve_decode", step=3):
            assert tspans.span_path() == "serve_decode"
            with tspans.span("spec_draft", stream=2):
                assert tspans.span_path() == "serve_decode/spec_draft"
    assert tspans.span_path() == ""
    tmon.disable()
    recs = [json.loads(ln) for ln in sink.getvalue().splitlines()][1:]
    assert [r["name"] for r in recs] == ["serve_decode/spec_draft",
                                         "serve_decode"]
    assert all(r["kind"] == "span" and r["trace_id"] == "serve-1"
               and r["dur_ns"] >= 0 and "traced" not in r for r in recs)
    assert recs[0]["stream"] == 2 and recs[1]["step"] == 3
    assert recs[1]["t0_ns"] <= recs[0]["t0_ns"]
    assert jmon.validate_jsonl(sink.getvalue().splitlines()) == []


def test_disabled_span_enters_no_record_function(monkeypatch):
    import torch.profiler

    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with tspans.span("serve_decode"):
        pass
    assert entered == []          # disabled: one load and an is-None test
    tmon.enable()
    with tspans.span("serve_decode"):
        with tspans.span("inner"):
            pass
    tmon.disable()
    assert entered == ["serve_decode", "inner"]


def test_record_function_range_shows_in_a_profile():
    tmon.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tspans.span("serve_prefill"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    tmon.disable()
    ev = [e for e in prof.events() if e.name == "serve_prefill"]
    assert len(ev) == 1
    assert "aten::matmul" in [c.name for c in ev[0].cpu_children]


def test_process_index_and_rank_info(monkeypatch):
    import torch.distributed as dist

    assert tlog.process_index() == 0
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert tlog.process_index() == 3
    tlog.set_rank_info("dp3/tp0")
    try:
        rec = treg.MetricsRegistry().emit_event("x")
        assert (rec["process"], rec["rank"]) == (3, "dp3/tp0")
    finally:
        tlog.set_rank_info("")
    assert tlog.get_rank_info() == ""


def test_generate_spans_share_one_trace_id():
    """DecodeEngine's spans (decode_prefill, decode_step, spec_verify and
    the drafters' spec_draft) ride one trace id a generate() call; an
    ambient id is reused; the tokens are those of a run with monitoring
    off."""
    from apex_tpu_torch.inference import DecodeEngine
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.spec import ModelDrafter, NGramDrafter

    model = GPTModel(GPTConfig(vocab_size=64, max_seq_len=128,
                               hidden_size=32, num_layers=1, num_heads=2))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = DecodeEngine(model, device="cpu")
    prompt = torch.tensor([[1, 2, 3, 1, 2, 3, 1, 2]], dtype=torch.int32)
    want = eng.generate(params, prompt, 6)
    drafter = ModelDrafter(model, params, k=2, device="cpu")
    want_spec = eng.generate(params, prompt, 6, draft=drafter)
    sink = io.StringIO()
    tmon.enable(stream=sink)
    try:
        got = eng.generate(params, prompt, 6)
        got_spec = eng.generate(params, prompt, 6, draft=drafter)
        with ttrace.trace_context("outer-1"):
            eng.generate(params, prompt, 3, draft=NGramDrafter(k=2))
    finally:
        tmon.disable()
    assert torch.equal(got, want) and torch.equal(got_spec, want_spec)
    spans = [json.loads(ln) for ln in sink.getvalue().splitlines()
             if '"span"' in ln]
    by_tid = {}
    for r in spans:
        by_tid.setdefault(r["trace_id"], []).append(r["name"])
    assert len(by_tid) == 3
    plain, spec, outer = by_tid.values()
    assert plain == ["decode_prefill"] + ["decode_step"] * 5
    assert {"decode_prefill", "spec_verify", "spec_draft",
            "spec_draft/decode_step"} == set(spec)
    assert "outer-1" in by_tid and "spec_verify" in outer
    assert all(t.startswith("gen-") for t in list(by_tid)[:2])
