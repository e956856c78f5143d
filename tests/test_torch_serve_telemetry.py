"""Port parity: apex_tpu_torch's serving telemetry (ServeTelemetry, the
scheduler's hook seam, SLOPolicy.update, serve(telemetry=)) against
apex_tpu's, on the same inputs.

1. One hook trace — the reference's anomaly-layer inputs
   (``tests/test_serve_telemetry.py:198-300``) and a seeded churn trace —
   replayed into both ``ServeTelemetry`` classes: every record and every
   flag identical, but for the clock stamps, the trace ids' values (each
   package counts its own) and the overhead ledger.
2. A real serve of the reference's ``tiny`` GPT on both packages (the
   weights through the bridge), churning through preemption: the port's
   stream passes the reference's ``validate_jsonl``, its clock-free
   lifecycle fields equal the reference stream's in order, and the tokens
   are the reference's with telemetry attached, absent and ``False``.
3. ``SLOPolicy.update`` over a scripted signal sequence: the reference's
   knobs and ``adjustments``.
4. The reference's ``TestEngineContracts`` and
   ``TestSchedulerTelemetrySeam``, ported; in place of its jit-cache
   witness, the telemetry serve calls the same steps the same number of
   times as the serve without it.

Everything runs the plain versions on the CPU, fp32. A CPU serve's
telemetry is SKIP (its numbers are host-CPU numbers): the port refuses an
OK tracker off the card.
"""

import dataclasses
import io
import json
import time

import jax
import numpy as np
import pytest

from apex_tpu import monitor as jmon
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.serving import BlockAllocator as JBlockAllocator
from apex_tpu.serving import Request as JRequest
from apex_tpu.serving import Scheduler as JScheduler
from apex_tpu.serving import ServeTelemetry as JServeTelemetry
from apex_tpu.serving import ServingEngine as JServingEngine
from apex_tpu.serving.scheduler import SLOPolicy as JSLOPolicy
from apex_tpu_torch import monitor as tmon
from apex_tpu_torch.models.convert import params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.serving import (BlockAllocator, Request, Scheduler,
                                    ServeTelemetry, ServingEngine, SLOPolicy)

# the reference's tiny serving GPT (tests/test_serve_telemetry.py:46-52)
TINY = dict(vocab_size=97, max_seq_len=128, hidden_size=32, num_layers=2,
            num_heads=4, num_kv_heads=2, attention_impl="flash")
# 2 slots of 8-row blocks, 8-token chunks, 6 allocatable blocks: three
# 12-token prompts generating 14 tokens each preempt
ENGINE = dict(num_slots=2, block_size=8, prefill_chunk=8, num_blocks=7)
SKIP = dict(status="SKIP", reason="cpu test run")
# serve_event fields that read a clock or count a package's own ids
CLOCKED = {"at_s", "t_s", "t_ns", "trace_id", "queue_wait_ms", "dur_ms",
           "ttft_ms", "prefill_ms", "decode_ms", "total_ms", "process",
           "rank"}

JAX_PKG = dict(Tel=JServeTelemetry, Req=JRequest, Alloc=JBlockAllocator,
               Sched=JScheduler, mon=jmon)
PORT_PKG = dict(Tel=ServeTelemetry, Req=Request, Alloc=BlockAllocator,
                Sched=Scheduler, mon=tmon)


@pytest.fixture(autouse=True)
def _monitors_off():
    jmon.disable()
    tmon.disable()
    yield
    jmon.disable()
    tmon.disable()


@pytest.fixture(scope="module")
def tiny():
    jm = JGPTModel(JGPTConfig(**TINY, remat=False, dropout=0.0))
    jp = jm.init(jax.random.PRNGKey(23))
    tm = GPTModel(GPTConfig(**TINY, remat=False))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.config,
                         device="cpu")
    return jm, jp, tm, tp


def _churn_requests(Req, seed=0, n=3, plen=12, new=14):
    rng = np.random.default_rng(seed)
    return [Req(rid=i, prompt=np.asarray(rng.integers(0, 97, plen),
                                         np.int32), max_new_tokens=new)
            for i in range(n)]


class _Clock:
    """A scripted serve clock: 1 ms a read, so every duration, window
    edge and straggler verdict is the same in both packages."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


# --- 1. one hook trace, replayed into both trackers -------------------------

class _FakeSched:
    """Just enough Scheduler surface for scripted window/anomaly calls."""

    def __init__(self, waiting=0, active=0, allocator=None):
        self.num_waiting = waiting
        self.num_active = active
        self.allocator = allocator

    def num_queued(self, now):
        return self.num_waiting


FLAGS = ("tokens", "decode_steps", "prefill_chunks", "finished",
         "admission_blocked_slots", "admission_blocked_blocks", "queue_peak",
         "straggler_steps", "straggler_last_ratio", "ttft_over_slo",
         "slo_burn", "slo_burning", "queue_buildup", "leaked_blocks",
         "windows_emitted", "preemptions", "resumes", "prefix_hit_requests",
         "prefix_miss_requests", "swaps", "spec_slot_rounds", "spec_drafted",
         "spec_accepted", "draft_k", "spec_nodes", "spec_tree_rounds")


def _state(tel, alloc=None, sched=None):
    out = {f: getattr(tel, f) for f in FLAGS}
    out["itl"] = [tel.itl_ms.quantile(q) for q in (0, .5, .9, .99, 1)]
    out["ttft"] = [tel.ttft_ms.quantile(q) for q in (0, .5, .99, 1)]
    out["final"] = tel.final_fields(alloc, sched)
    out["anomaly"] = tel.anomaly_section(alloc)
    out["events"] = [_anon(e) for e in tel.events]
    return out


def _anon(rec):
    """A record without clock stamps; a trace id reduced to its prefix (its
    sequence number is the package's own count)."""
    out = {k: v for k, v in rec.items() if k not in ("t_s", "t_ns")}
    if "trace_id" in out:
        out["trace_id"] = out["trace_id"].split("-")[0]
    return out


def _scenarios(P):
    """The reference's TestAnomalyLayer / TestServingTier2Telemetry
    inputs, each on a fresh tracker: (name, tracker, allocator, sched)."""
    Tel, Req, Alloc, Sched = P["Tel"], P["Req"], P["Alloc"], P["Sched"]
    out = []

    tel = Tel(slots=4, window_s=0.0, straggler_ratio=3.0,
              straggler_window=8, collect_events=True)
    for i in range(8):
        tel.on_decode_step(0.001, 4, i, i * 0.001)
    tel.on_decode_step(0.0045, 4, 8, 0.009)
    tel.on_decode_step(0.001, 4, 9, 0.010)
    for i in range(10, 31):
        tel.on_decode_step(0.0045, 4, i, i * 0.001)
    out.append(("straggler", tel, None, None))

    tel = Tel(slots=4, window_s=0.0, slo_ttft_ms=100.0, slo_burn_count=3,
              collect_events=True)
    for rid, s in enumerate((0.25, 0.02, 0.25, 0.25, 0.25, 0.001)):
        r = Req(rid=rid, prompt=np.zeros(4, np.int32), max_new_tokens=2)
        tel.on_submit(r, 0.0)
        tel.on_first_token(r, 0, 1, 0, s)
    out.append(("slo_burn", tel, None, None))

    tel = Tel(slots=2, window_s=1e-9, collect_events=True)
    alloc = Alloc(8)
    for i, depth in enumerate([1, 2, 4, 7, 0]):
        tel.maybe_window(float(i + 1), _FakeSched(depth, 1, alloc))
    out.append(("queue_buildup", tel, alloc, None))

    alloc = Alloc(8)
    alloc.allocate(3)
    tel = Tel(slots=2, window_s=1e-9, collect_events=True)
    for t in (1.0, 2.0):
        tel.maybe_window(t, _FakeSched(0, 0, alloc))
    out.append(("idle_leak", tel, alloc, None))

    s = Sched(num_slots=1, block_size=4, max_blocks_per_slot=8,
              allocator=Alloc(40), prefill_chunk=4)
    for i in range(5):
        s.submit(Req(rid=i, prompt=np.zeros(4, np.int32), max_new_tokens=2,
                     arrival_s=float(i)))
    tel = Tel(slots=1, window_s=0.0, collect_events=True)
    tel.maybe_window(0.0, s)
    tel.maybe_window(2.5, s)
    out.append(("unarrived_tail", tel, s.allocator, s))

    alloc = Alloc(10)
    alloc.allocate(4)
    out.append(("finish_leak", Tel(slots=2, window_s=0.0), alloc, None))

    alloc = Alloc(8)
    ids = alloc.allocate(2)
    alloc._live.discard(ids[0])  # counter drift behind the API's back
    tel = Tel(slots=2, window_s=1e-9, collect_events=True)
    for t in (1.0, 2.0):
        tel.maybe_window(t, _FakeSched(0, 1, alloc))
    out.append(("counter_drift", tel, alloc, None))

    alloc = Alloc(10)
    for bid in alloc.allocate(3):
        alloc.mark_resident(bid)
    alloc.allocate(1)
    tel = Tel(slots=2, window_s=1e-9, collect_events=True)
    for t in (1.0, 2.0):
        tel.maybe_window(t, _FakeSched(0, 0, alloc))
    out.append(("resident_not_leak", tel, alloc, None))

    tel = Tel(slots=2, window_s=0.0, collect_events=True)
    hit = Req(rid=0, prompt=np.zeros(8, np.int32), max_new_tokens=2)
    hit.prefix_hit_blocks = 2
    miss = Req(rid=1, prompt=np.zeros(8, np.int32), max_new_tokens=2)
    tel.on_submit(hit, 0.0)
    tel.on_submit(miss, 0.0)
    tel.on_first_token(hit, 0, 1, 0, 0.010)
    tel.on_first_token(miss, 1, 1, 0, 0.050)
    out.append(("ttft_split", tel, None, None))

    tel = Tel(slots=2, window_s=0.0, collect_events=True)
    req = Req(rid=0, prompt=np.zeros(8, np.int32), max_new_tokens=4)
    tel.on_submit(req, 0.0)
    tel.on_admit(req, 0, 1.0)
    tel.on_evict(req, 0, 3, "pool_pressure", 0, 5, 5.0)
    tel.on_admit(req, 1, 5.25, resumed=True)
    out.append(("readmit_wait", tel, None, None))

    out.append(_churn(P))
    return out


def _churn(P, seed=7, n_req=24):
    """A seeded churn trace through every hook: requests submitted,
    admitted (some with prefix hits), chunked, first tokens, decode steps
    with ITLs (and a few straggler spikes), spec rounds (chain and tree),
    evictions and resumes, swaps, admission pressure and windows."""
    Tel, Req, Alloc = P["Tel"], P["Req"], P["Alloc"]
    rng = np.random.default_rng(seed)
    tel = Tel(slots=4, window_s=0.05, slo_ttft_ms=30.0, slo_burn_count=2,
              straggler_window=8, collect_events=True)
    alloc = Alloc(64)
    reqs = [Req(rid=i, prompt=np.zeros(int(rng.integers(4, 40)), np.int32),
                max_new_tokens=int(rng.integers(2, 12)))
            for i in range(n_req)]
    now, step = 0.0, 0
    state = {}  # rid -> [phase, slot, blocks, generated]
    for r in reqs:
        tel.on_submit(r, now)
        state[r.rid] = ["queued", -1, 0, 0]
    held = []
    while any(s[0] != "done" for s in state.values()):
        now += float(rng.uniform(0.001, 0.01))
        live = [rid for rid, s in state.items()
                if s[0] in ("prefill", "decode")]
        queued = [rid for rid, s in state.items() if s[0] == "queued"]
        if queued and len(live) < 4 and rng.random() < 0.6:
            rid = queued[0]
            r = reqs[rid]
            resumed = state[rid][3] > 0
            hit = int(rng.integers(0, 3)) if not resumed else 0
            r.prefix_hit_blocks = hit
            slot = min(set(range(4)) - {state[x][1] for x in live})
            state[rid][:3] = ["prefill", slot, hit]
            tel.on_admit(r, slot, now, prefix_hit_blocks=hit,
                         resumed=resumed)
            held += alloc.allocate(1)
            continue
        if queued and len(live) == 4:
            tel.on_blocked("slots")
        elif queued and rng.random() < 0.1:
            tel.on_blocked("blocks")
        for rid in live:
            s, r = state[rid], reqs[rid]
            if s[0] == "prefill":
                s[2] += 1
                tel.on_prefill_chunk(rid, s[1], float(rng.uniform(.001,
                                                                  .004)),
                                     s[2], step, now)
                step += 1
                if rng.random() < 0.5:
                    s[0] = "decode"
                    if s[3]:
                        tel.on_resume(r, s[1], s[2], step, now)
                    else:
                        s[3] = 1
                        r.tokens.append(1)
                        tel.on_first_token(r, s[1], s[2], step, now)
        dec = [rid for rid in live if state[rid][0] == "decode"]
        if dec:
            dur = float(rng.uniform(0.002, 0.003))
            if rng.random() < 0.08:
                dur *= 5
            tel.on_decode_step(dur, len(dec), step, now)
            spec = rng.random()
            for rid in dec:
                s, r = state[rid], reqs[rid]
                if spec < 0.3:
                    acc = int(rng.integers(0, 4))
                    tree = spec < 0.15
                    tel.on_spec_round(rid, s[1], acc, 3, step, now,
                                      dur_ms=dur * 1e3,
                                      nodes=6 if tree else None,
                                      branching=2 if tree else None)
                    m = acc + 1
                else:
                    m = 1
                for _ in range(m):
                    tel.observe_itl(dur / m)
                s[3] += m
                r.tokens.extend([1] * m)
            step += 1
            for rid in dec:
                s, r = state[rid], reqs[rid]
                if s[3] >= r.max_new_tokens:
                    tel.on_finish(r, s[1], s[2], step, now)
                    s[0], s[1] = "done", -1
                elif rng.random() < 0.07:
                    tel.on_evict(r, s[1], s[2], "pool_pressure", 0, step,
                                 now)
                    s[:3] = ["queued", -1, 0]
        if rng.random() < 0.03:
            tel.on_swap(step, now, source="ckpt-step",
                        dur_ms=float(rng.uniform(0.1, 1.0)))
        if held and rng.random() < 0.3:
            alloc.free([held.pop()])
        tel.maybe_window(now, _FakeSched(len(queued), len(live), alloc))
    return ("churn", tel, alloc, None)


def _replay(P):
    """Every scenario's records (through an enabled registry) and state."""
    sink = io.StringIO()
    P["mon"].enable(stream=sink)
    try:
        got = {name: _state(tel, alloc, sched)
               for name, tel, alloc, sched in _scenarios(P)}
    finally:
        P["mon"].disable()
    recs = [_anon(json.loads(ln)) for ln in sink.getvalue().splitlines()]
    return got, recs


def test_replayed_hook_trace_gives_the_reference_records_and_flags():
    want, want_recs = _replay(JAX_PKG)
    got, got_recs = _replay(PORT_PKG)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert len(got_recs) == len(want_recs) > 100
    for g, w in zip(got_recs, want_recs):
        if g.get("kind") == "clock_sync":
            continue
        assert g == w
    # the churn reached every phase, and the anomaly layer fired
    phases = {r.get("phase") for r in got_recs}
    assert {"submit", "admit", "prefill_chunk", "first_token", "decode",
            "finish", "evict", "spec", "swap"} <= phases
    churn = got["churn"]
    assert churn["straggler_steps"] > 0 and churn["slo_burn"]
    assert churn["windows_emitted"] > 3 and churn["spec_tree_rounds"] > 0
    assert jmon.validate_jsonl([json.dumps(r) for r in got_recs]) == []


def test_reference_scenario_verdicts():
    """The reference's own assertions, on the port's trackers."""
    s = {name: (tel, alloc)
         for name, tel, alloc, _ in _scenarios(PORT_PKG)}
    tel = ServeTelemetry(slots=4, window_s=0.0, straggler_ratio=3.0,
                         straggler_window=8)
    for i in range(8):
        tel.on_decode_step(0.001, 4, i, i * 0.001)
    tel.on_decode_step(0.0045, 4, 8, 0.009)  # 4.5x the median
    assert tel.straggler_steps == 1
    assert tel.straggler_last_ratio == pytest.approx(4.5, rel=0.01)
    # the rolling median absorbs a level shift
    before = s["straggler"][0].straggler_steps
    s["straggler"][0].on_decode_step(0.0045, 4, 31, 0.032)
    assert s["straggler"][0].straggler_steps == before
    tel = s["slo_burn"][0]
    assert tel.slo_burn and not tel.slo_burning and tel.ttft_over_slo == 4
    tel = s["queue_buildup"][0]
    assert not tel.queue_buildup and tel.queue_peak == 7
    assert s["idle_leak"][0].leaked_blocks == 3
    assert s["unarrived_tail"][0].queue_peak == 3
    tel, alloc = s["finish_leak"]
    assert tel.final_fields(alloc)["serve_anomaly"]["leaked_blocks"] == 4
    assert s["counter_drift"][0].leaked_blocks == 1
    assert s["resident_not_leak"][0].leaked_blocks == 1
    f = s["ttft_split"][0].final_fields()
    assert f["prefix_hit_ttft_p50_ms"] < f["prefix_miss_ttft_p50_ms"]
    ev = [e for e in s["readmit_wait"][0].events if e["phase"] == "admit"]
    assert [e["queue_wait_ms"] for e in ev] == [1000.0, 250.0]
    with pytest.raises(ValueError, match="reason"):
        ServeTelemetry(slots=2, status="SKIP")
    with pytest.raises(ValueError, match="OK|SKIP"):
        ServeTelemetry(slots=2, status="MAYBE")


# --- 2. a real serve on both packages ---------------------------------------

def _ref_serve(tiny, path, tel=True):
    jm, jp, _, _ = tiny
    jmon.enable(str(path))
    try:
        eng = JServingEngine(jm, **ENGINE)
        sched = eng.make_scheduler()
        t = JServeTelemetry(slots=2, window_s=0.002, **SKIP) if tel else None
        done = eng.serve(jp, _churn_requests(JRequest), scheduler=sched,
                         telemetry=t, clock=_Clock())
    finally:
        jmon.disable()
    return done, sched, t


def _port_serve(tiny, path=None, telemetry=None, scheduler=None):
    _, _, tm, tp = tiny
    if path is not None:
        tmon.enable(str(path))
    try:
        eng = ServingEngine(tm, device="cpu", **ENGINE)
        sched = scheduler or eng.make_scheduler()
        done = eng.serve(tp, _churn_requests(Request), scheduler=sched,
                         telemetry=telemetry, clock=_Clock())
    finally:
        tmon.disable()
    return eng, done, sched


def _lifecycle(records):
    return [{k: v for k, v in r.items() if k not in CLOCKED}
            for r in records if r.get("kind") == "serve_event"]


@pytest.fixture(scope="module")
def ref_run(tiny, tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.jsonl"
    done, sched, tel = _ref_serve(tiny, path)
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    return {r.rid: list(r.tokens) for r in done}, recs, sched, tel


def test_serve_stream_matches_the_reference(tiny, ref_run, tmp_path):
    want_tokens, want_recs, jsched, jtel = ref_run
    path = tmp_path / "port.jsonl"
    tel = ServeTelemetry(slots=2, window_s=0.002, **SKIP)
    _, done, sched = _port_serve(tiny, path, telemetry=tel)
    lines = path.read_text().splitlines()
    assert jmon.validate_jsonl(lines) == []
    recs = [json.loads(ln) for ln in lines]
    assert {r.rid: list(r.tokens) for r in done} == want_tokens
    assert sched.preemptions == jsched.preemptions >= 1
    got, want = _lifecycle(recs), _lifecycle(want_recs)
    assert got == want
    assert {"evict", "prefill_chunk", "first_token", "finish"} <= {
        r["phase"] for r in got}
    # one trace id a request, carried across its eviction
    ids = {}
    for r in recs:
        if r.get("kind") == "serve_event" and r["rid"] >= 0:
            ids.setdefault(r["rid"], set()).add(r["trace_id"])
    assert all(len(v) == 1 for v in ids.values()) and len(ids) == 3
    serve_ids = {r["trace_id"] for r in recs
                 if r.get("kind") in ("span", "serve_window")}
    assert len(serve_ids) == 1 and serve_ids.pop().startswith("serve-")
    spans = {r["name"] for r in recs if r.get("kind") == "span"}
    assert spans == {"serve_prefill", "serve_decode"}
    # the trackers' counts agree, and the pool drained clean
    for f in ("preemptions", "resumes", "finished", "prefill_chunks",
              "decode_steps", "tokens", "windows_emitted"):
        assert getattr(tel, f) == getattr(jtel, f), f
    assert tel.final_fields(sched.allocator, sched)["serve_anomaly"][
        "leaked_blocks"] == 0
    sched.allocator.check_accounting()


def test_tokens_identical_with_telemetry_on_off_and_false(tiny, ref_run,
                                                          tmp_path):
    want = ref_run[0]
    _, off, _ = _port_serve(tiny)                          # registry off
    _, false, _ = _port_serve(tiny, tmp_path / "f.jsonl", telemetry=False)
    _, auto, sched = _port_serve(tiny, tmp_path / "a.jsonl")  # auto-attached
    for done in (off, false, auto):
        assert {r.rid: list(r.tokens) for r in done} == want
    assert sched.telemetry.status == "SKIP"
    assert "cpu" in sched.telemetry.reason
    # False drops the tracker; the spans stay (they follow the registry)
    quiet = (tmp_path / "f.jsonl").read_text()
    assert '"serve_event"' not in quiet and '"serve_decode"' in quiet


# --- 3. SLOPolicy.update ----------------------------------------------------

class _Signals:
    def __init__(self, burning, buildup):
        self.slo_burning = burning
        self.queue_buildup = buildup


def test_slo_policy_update_matches_the_reference():
    rng = np.random.default_rng(4)
    seq = [(bool(a), bool(b)) for a, b in rng.integers(0, 2, (40, 2))]
    seq += [(False, True)] * 6 + [(True, False)] * 3 + [(False, False)] * 5
    for kw in (dict(), dict(max_prefill_share=2, prefill_share=2)):
        t, j = SLOPolicy(**kw), JSLOPolicy(**kw)
        trail = []
        for burning, buildup in seq:
            t.update(_Signals(burning, buildup))
            j.update(_Signals(burning, buildup))
            assert (t.prefer_short_prompts, t.prefill_share,
                    t.adjustments) == (j.prefer_short_prompts,
                                       j.prefill_share, j.adjustments)
            trail.append(t.prefill_share)
        assert max(trail) == t.max_prefill_share and min(trail) == 1
    # an object without the signals stands the policy down
    p = SLOPolicy(prefill_share=3, prefer_short_prompts=True)
    p.update(object())
    assert (p.prefill_share, p.prefer_short_prompts, p.adjustments) == (
        2, False, 1)


def test_window_edges_drive_the_policy_in_a_serve(tiny, tmp_path):
    """The engine folds every emitted window into the scheduler's policy:
    a 1-window-a-read clock makes each iteration a window edge."""
    _, _, tm, tp = tiny
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    seen = []

    class Spy(SLOPolicy):
        def update(self, tel):
            seen.append(tel.windows_emitted)
            super().update(tel)

    sched = eng.make_scheduler()
    sched.policy = Spy()
    tel = ServeTelemetry(slots=2, window_s=1e-9, **SKIP)
    eng.serve(tp, _churn_requests(Request), scheduler=sched, telemetry=tel,
              clock=_Clock())
    assert seen == list(range(1, tel.windows_emitted + 1)) and len(seen) > 5


# --- 4. the reference's engine contracts and scheduler seam -----------------

def _count_steps(eng):
    calls = {"prefill_chunk": 0, "decode_step": 0}
    for name in calls:
        real = getattr(eng, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        setattr(eng, name, counted)
    return calls


def test_telemetry_serve_runs_the_same_steps(tiny, tmp_path):
    """In place of the reference's jit-cache witness: with telemetry on
    (events, windows every read, histograms) the serve calls the device
    steps exactly as often as with it off, for the same tokens."""
    _, _, tm, tp = tiny
    runs = []
    for tel in (False, ServeTelemetry(slots=2, window_s=1e-9, **SKIP)):
        tmon.enable(str(tmp_path / "s.jsonl"))
        try:
            eng = ServingEngine(tm, device="cpu", **ENGINE)
            calls = _count_steps(eng)
            done = eng.serve(tp, _churn_requests(Request), telemetry=tel,
                             clock=_Clock())
        finally:
            tmon.disable()
        st = dataclasses.asdict(eng.last_stats)
        runs.append((calls, {r.rid: r.tokens for r in done},
                     {k: v for k, v in st.items() if not k.endswith("_s")}))
    assert runs[0][0] == runs[1][0] and runs[0][0]["decode_step"] > 10
    assert runs[0][1] == runs[1][1]
    assert runs[0][2] == runs[1][2]
    assert runs[1][0]["decode_step"] == runs[1][2]["decode_steps"]


def test_ok_tracker_is_refused_off_the_card(tiny):
    _, _, tm, tp = tiny
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="SKIP"):
        eng.serve(tp, _churn_requests(Request, n=1),
                  telemetry=ServeTelemetry(slots=2))


def test_per_step_overhead_under_one_percent(tiny):
    """The reference's <1%-of-a-serve-step budget, measured the same way:
    min over passes of one on_decode_step + one observe_itl a live slot +
    one maybe_window, against a warm serve step of the tiny model."""
    _, _, tm, tp = tiny
    eng = ServingEngine(tm, device="cpu", num_slots=2, block_size=8,
                        prefill_chunk=16)
    eng.serve(tp, [Request(rid=0, prompt=np.zeros(8, np.int32),
                           max_new_tokens=24)])
    t0 = time.perf_counter()
    eng.serve(tp, [Request(rid=1, prompt=np.zeros(8, np.int32),
                           max_new_tokens=24)])
    step_s = (time.perf_counter() - t0) / 25  # 24 decode + prefill
    tel = ServeTelemetry(slots=2, window_s=0.5, **SKIP)
    sched = _FakeSched(active=2, allocator=BlockAllocator(8))
    n, passes = 1000, 3

    def hook_pass(base):
        t0 = time.perf_counter()
        for i in range(base, base + n):
            tel.observe_itl(0.001)
            tel.observe_itl(0.001)
            tel.on_decode_step(0.001, 2, i, i * 0.001)
            tel.maybe_window(i * 0.001, sched)
        return (time.perf_counter() - t0) / n

    t_all0 = time.perf_counter()
    hook_pass(0)
    per_step = min(hook_pass((p + 1) * n) for p in range(passes))
    assert per_step < 0.01 * step_s, (
        f"per-step telemetry {per_step * 1e6:.1f}us is not <1% of a "
        f"measured {step_s * 1e3:.2f}ms serve step")
    assert tel.overhead_s <= (time.perf_counter() - t_all0) * 1.05


def test_telemetry_false_suppresses_auto_attach(tiny, tmp_path):
    _, _, tm, tp = tiny
    path = tmp_path / "optout.jsonl"
    tmon.enable(str(path))
    try:
        eng = ServingEngine(tm, device="cpu", num_slots=2, block_size=8,
                            prefill_chunk=8)
        eng.serve(tp, [Request(rid=0, prompt=np.zeros(5, np.int32),
                               max_new_tokens=3)], telemetry=False)
        quiet = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert not any(r.get("kind") == "serve_event" for r in quiet)
        eng.serve(tp, [Request(rid=1, prompt=np.zeros(5, np.int32),
                               max_new_tokens=3)])
        traced = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert any(r.get("kind") == "serve_event" and r["rid"] == 1
                   for r in traced)
        # a REUSED scheduler with a stale tracker is detached too
        tel = ServeTelemetry(slots=2, window_s=0.0, **SKIP)
        sched = eng.make_scheduler()
        eng.serve(tp, [Request(rid=2, prompt=np.zeros(5, np.int32),
                               max_new_tokens=3)],
                  scheduler=sched, telemetry=tel)
        tokens_before = tel.tokens
        eng.serve(tp, [Request(rid=3, prompt=np.zeros(5, np.int32),
                               max_new_tokens=3)],
                  scheduler=sched, telemetry=False)
        assert sched.telemetry is None
        assert tel.tokens == tokens_before
    finally:
        tmon.disable()


def test_scheduler_attached_tracker_is_adopted(tiny, tmp_path):
    _, _, tm, tp = tiny
    path = tmp_path / "adopt.jsonl"
    tmon.enable(str(path))
    try:
        eng = ServingEngine(tm, device="cpu", num_slots=2, block_size=8,
                            prefill_chunk=8)
        tel = ServeTelemetry(slots=2, window_s=1e-4, **SKIP)
        sched = Scheduler(
            num_slots=2, block_size=8,
            max_blocks_per_slot=eng.max_blocks_per_slot,
            allocator=BlockAllocator(eng.num_blocks), prefill_chunk=8,
            telemetry=tel)
        eng.serve(tp, [Request(rid=0, prompt=np.zeros(6, np.int32),
                               max_new_tokens=4)], scheduler=sched)
        assert sched.telemetry is tel
        assert tel.decode_steps > 0 and tel.windows_emitted >= 1
        assert tel.ttft_ms.count == 1
        ev = [json.loads(ln) for ln in path.read_text().splitlines()
              if '"serve_event"' in ln]
        assert any(r["phase"] == "submit" for r in ev)
    finally:
        tmon.disable()


def test_monitoring_off_serve_is_unchanged(tiny):
    _, _, tm, tp = tiny
    assert not tmon.enabled()
    eng = ServingEngine(tm, device="cpu", num_slots=2, block_size=8,
                        prefill_chunk=8)
    done = eng.serve(tp, [Request(rid=0, prompt=np.zeros(5, np.int32),
                                  max_new_tokens=3)])
    assert len(done) == 1 and len(done[0].tokens) == 3
    assert done[0].trace_id is None and done[0].submit_s is None


def test_blocked_by_blocks_vs_slots():
    """The admission-pressure split (the reference's scheduler seam test):
    a pool too tight counts 'blocks', a full slot array counts 'slots'."""
    tel = ServeTelemetry(slots=2, window_s=0.0)
    s = Scheduler(num_slots=2, block_size=4, max_blocks_per_slot=16,
                  allocator=BlockAllocator(4), prefill_chunk=8,
                  telemetry=tel)
    s.submit(Request(rid=0, prompt=np.zeros(8, np.int32), max_new_tokens=2))
    assert s.admit(now=0.0) == [0]
    w = s.next_prefill(0.0)
    s.note_prefill(w, sampled_token=1, now=0.0)
    s.submit(Request(rid=1, prompt=np.zeros(8, np.int32), max_new_tokens=2))
    assert s.admit(now=0.0) == []
    assert tel.admission_blocked_blocks == 1
    assert tel.admission_blocked_slots == 0
    tel2 = ServeTelemetry(slots=1, window_s=0.0)
    s2 = Scheduler(num_slots=1, block_size=4, max_blocks_per_slot=16,
                   allocator=BlockAllocator(40), prefill_chunk=8,
                   telemetry=tel2)
    for i in range(2):
        s2.submit(Request(rid=i, prompt=np.zeros(8, np.int32),
                          max_new_tokens=4))
    s2.admit(now=0.0)
    s2.admit(now=0.0)
    assert tel2.admission_blocked_slots >= 1
    assert tel2.admission_blocked_blocks == 0


def test_scheduler_seam_matches_the_reference():
    """The same scripted scheduler drive on both packages (admission
    pressure, chunked prefill, decode, a spec commit, preemption, finish):
    the same lifecycle records in the same order, and note_step stamps."""
    out = []
    for P in (JAX_PKG, PORT_PKG):
        tel = P["Tel"](slots=2, window_s=0.0, collect_events=True)
        s = P["Sched"](num_slots=2, block_size=4, max_blocks_per_slot=8,
                       allocator=P["Alloc"](6), prefill_chunk=4,
                       telemetry=tel)
        reqs = [P["Req"](rid=i, prompt=np.arange(6 + i, dtype=np.int32),
                         max_new_tokens=7) for i in range(3)]
        for r in reqs:
            tel.on_submit(r, 0.0)
            s.submit(r)
        step, now = 0, 0.0
        while not s.idle():
            now += 1.0
            s.admit(now)
            w = s.next_prefill(now)
            if w is not None:
                s.note_step(step)
                step += 1
                s.note_prefill(w, 5, now)
            batch = s.decode_batch(now, lookahead=1 if step % 3 else 0)
            if batch is not None:
                s.note_step(step)
                step += 1
                if step % 3:
                    s.note_decode(np.full(2, 9, np.int32), now)
                else:
                    s.note_spec_tokens({i: [3, 4] for i in
                                        s.decoding_slots()}, now)
        out.append(([_anon(e) for e in tel.events], s.preemptions,
                    tel.itl_ms.count, tel.admission_blocked_blocks,
                    tel.admission_blocked_slots))
    assert out[0] == out[1]
    assert out[1][1] >= 1  # the pool of 5 preempted
