"""The port's copy of the online SLO and incident plane
(``repro_torch.obs``, ``repro_torch.engine.faults``) on the port's
engine: every test of tests/test_slo_incidents.py, pointed at the port
(per-class SLO accounting, every streaming detector on hand-built
streams, flight-recorder bundles replayed by the reference's
``scripts/trace_report.py``, lossy and truncated JSONL replay, fleet
health over the port's ClusterRouter, the clean and the ``stuck_tool``
fault-injected sim runs). Then one event stream of the port's engine,
replayed through both packages' DetectorSuite and SloTracker, gives
equal incidents and goodput.
"""
import importlib
import importlib.util
import json
import os

import pytest

from repro_torch.core import events as ev
from repro_torch.core.events import EventBus
from repro_torch.obs import (DetectorConfig, DetectorSuite, FlightRecorder,
                       HealthReport, MetricsRegistry, SloTracker, Tracer,
                       bind_engine_probes, dump_events_jsonl,
                       events_from_dicts, load_events_jsonl,
                       write_events_jsonl)

REPO = os.path.join(os.path.dirname(__file__), "..")

_spec = importlib.util.spec_from_file_location(
    "trace_report", os.path.join(REPO, "scripts", "trace_report.py"))
trace_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_report)


def _e(k, t, sid=1, **data):
    return {"kind": k, "t": t, "sid": sid, "data": data}


def _tick(t, *, waiting=0, free=900, total=1000, elapsed=1.0,
          swapins=0, backlog=0):
    return _e(ev.TICK, t, -1, elapsed=elapsed, waiting=waiting,
              free_blocks=free, total_blocks=total, n_swapins=swapins,
              n_swapouts=0, cpu_backlog=backlog)


# --- SLO accounting ----------------------------------------------------------

def test_slo_clean_session_is_goodput():
    slo = SloTracker.replay(events_from_dicts([
        _e(ev.SUBMIT, 0.0, slo_class="standard", slo_alpha=3.0, ideal_s=2.0),
        _e(ev.GPU_FIRST_TOKEN, 1.0, ttft=1.0),
        _e(ev.DECODE_STEP, 1.4, start=1.0, tokens=8),
        _e(ev.TOOL_ENQUEUE, 2.0, kind="search"),
        _e(ev.TOOL_END, 4.0, kind="search", duration=1.5),
        _e(ev.FINISH, 5.0, latency=5.0),
    ]))
    c = slo.report()["classes"]["standard"]
    assert c["sessions"] == c["finished"] == c["good"] == 1
    assert c["goodput_frac"] == 1.0 and c["violated_sessions"] == 0
    assert all(n == 0 for n in c["violations"].values())
    # quantile rollup fed from the same stream
    assert c["quantiles"]["ttft_s"]["count"] == 1
    assert c["quantiles"]["tool_overhead_s"]["mean"] == pytest.approx(0.5)


def test_slo_every_metric_can_violate():
    # interactive bounds: ttft 2.0, itl 0.25, tool_overhead 15.0, alpha 2.0
    slo = SloTracker.replay(events_from_dicts([
        _e(ev.SUBMIT, 0.0, slo_class="interactive", slo_alpha=2.0,
           ideal_s=2.0),
        _e(ev.GPU_FIRST_TOKEN, 5.0, ttft=5.0),            # > 2.0
        _e(ev.DECODE_STEP, 9.0, start=5.0, tokens=2),     # itl 2.0 > 0.25
        _e(ev.TOOL_ENQUEUE, 10.0, kind="t"),
        _e(ev.TOOL_END, 40.0, kind="t", duration=1.0),    # overhead 29 > 15
        _e(ev.FINISH, 50.0, latency=50.0),                # > 2 x 2.0
    ]))
    c = slo.report()["classes"]["interactive"]
    assert c["violations"] == {"ttft_s": 1, "itl_s": 1,
                               "tool_overhead_s": 1, "e2e_s": 1}
    assert c["violated_sessions"] == 1
    assert c["goodput_frac"] == 0.0


def test_slo_no_ideal_is_exempt_and_reject_counted():
    slo = SloTracker.replay(events_from_dicts([
        _e(ev.SUBMIT, 0.0, slo_class="standard"),          # no ideal_s
        _e(ev.FINISH, 500.0, latency=500.0),
        _e(ev.REJECT, 1.0, sid=2),
    ]))
    rep = slo.report()
    assert rep["classes"]["standard"]["good"] == 1         # exempt, not bad
    assert rep["rejected"] == 1


def test_slo_unknown_class_registered_and_resubmit_keeps_state():
    slo = SloTracker.replay(events_from_dicts([
        _e(ev.SUBMIT, 0.0, slo_class="premium", ideal_s=1.0),
        # cluster re-placement re-emits SUBMIT; state must survive it
        _e(ev.SUBMIT, 10.0, slo_class="standard", ideal_s=99.0),
        _e(ev.FINISH, 20.0, latency=20.0),
    ]))
    rep = slo.report()
    assert "premium" in rep["classes"] and "standard" not in rep["classes"]
    # judged against the ORIGINAL ideal_s=1.0: 20 > 3 x 1 -> violated
    assert rep["classes"]["premium"]["good"] == 0


# --- detectors: decode_livelock ----------------------------------------------

def test_decode_livelock_fires_once_then_rearms_on_next_step():
    rows = [_e(ev.DECODE_STEP, 0.0, start=0.0, tokens=4, decoded=8)]
    rows += [_tick(float(i)) for i in range(1, 421)]
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("decode_livelock") == 1
    inc = suite.incidents[0]
    assert inc["sid"] == 1 and inc["evidence"]["ticks_stalled"] >= 400
    # silent without a fresh DECODE_STEP (disarmed), refires after one
    rows += [_tick(float(i)) for i in range(421, 440)]
    rows += [_e(ev.DECODE_STEP, 440.0, start=439.0, tokens=4, decoded=12)]
    rows += [_tick(float(i)) for i in range(441, 900)]
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("decode_livelock") == 2


def test_decode_livelock_silent_after_session_leaves_decode():
    for leave in (ev.FINISH, ev.TOOL_ENQUEUE, ev.PREEMPT):
        rows = [_e(ev.DECODE_STEP, 0.0, start=0.0, tokens=4),
                _e(leave, 1.0, kind="t")]
        rows += [_tick(float(i)) for i in range(2, 500)]
        suite = DetectorSuite.replay(events_from_dicts(rows))
        assert suite.count("decode_livelock") == 0, leave


# --- detectors: tool_stall ---------------------------------------------------

def test_tool_stall_uses_promise_from_enqueue():
    # TOOL_START carries no expected_s (the promise rides TOOL_ENQUEUE);
    # bound = max(min_s=60, 4 x 10) = 60s past the start
    rows = [_e(ev.TOOL_ENQUEUE, 0.0, sid=2, kind="test_runner",
               expected_s=10.0),
            _e(ev.TOOL_START, 1.0, sid=2, kind="test_runner",
               queue_wait=1.0)]
    rows += [_tick(float(i)) for i in range(2, 90)]
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("tool_stall") == 1
    evd = suite.incidents[0]["evidence"]
    assert evd["expected_s"] == 10.0 and evd["bound_s"] == 60.0
    assert evd["running_s"] > 60.0


def test_tool_stall_silent_when_tool_finishes_in_time():
    rows = [_e(ev.TOOL_ENQUEUE, 0.0, sid=2, kind="t", expected_s=10.0),
            _e(ev.TOOL_START, 1.0, sid=2, kind="t")]
    rows += [_tick(float(i)) for i in range(2, 40)]
    rows += [_e(ev.TOOL_END, 40.0, sid=2, kind="t", duration=39.0)]
    rows += [_tick(float(i)) for i in range(41, 200)]
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("tool_stall") == 0


def test_tool_stall_ignores_queueing_before_start():
    # 200s stuck in the core-pool queue, then a quick run: clean.
    # The stall clock starts at TOOL_START, so queueing never trips it.
    rows = [_e(ev.TOOL_ENQUEUE, 0.0, sid=2, kind="t", expected_s=10.0)]
    rows += [_tick(float(i)) for i in range(1, 200)]
    rows += [_e(ev.TOOL_START, 200.0, sid=2, kind="t", queue_wait=200.0),
             _e(ev.TOOL_END, 210.0, sid=2, kind="t", duration=10.0)]
    rows += [_tick(float(i)) for i in range(211, 280)]
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("tool_stall") == 0


# --- detectors: admission_stall ----------------------------------------------

def test_admission_stall_requires_free_pool():
    stalled = [_tick(float(i), waiting=3, free=900, total=1000)
               for i in range(1, 350)]
    suite = DetectorSuite.replay(events_from_dicts(stalled))
    assert suite.count("admission_stall") == 1
    evd = suite.incidents[0]["evidence"]
    assert evd["free_frac"] >= 0.5 and evd["waiting_streak"] >= 300
    # same streak under genuine KV backpressure: NOT a control-plane stall
    packed = [_tick(float(i), waiting=3, free=100, total=1000)
              for i in range(1, 350)]
    suite = DetectorSuite.replay(events_from_dicts(packed))
    assert suite.count("admission_stall") == 0


def test_admission_stall_reset_by_round0_submit():
    rows = []
    for i in range(1, 600):
        rows.append(_tick(float(i), waiting=3))
        if i % 200 == 0:                    # admission is making progress
            rows.append(_e(ev.GPU_SUBMIT, float(i), sid=5, round=0))
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("admission_stall") == 0


# --- detectors: swap_storm ---------------------------------------------------

def test_swap_storm_fires_on_io_saturated_window():
    rows = [_tick(float(i), elapsed=0.2, swapins=2) for i in range(1, 70)]
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("swap_storm") == 1
    assert suite.incidents[0]["evidence"]["io_frac"] >= 0.8


def test_swap_storm_silent_below_io_fraction():
    # every other tick swaps: io_frac 0.5 < 0.8
    rows = [_tick(float(i), elapsed=0.2, swapins=i % 2)
            for i in range(1, 200)]
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("swap_storm") == 0


# --- detectors: cpu_queue_collapse -------------------------------------------

def test_cpu_collapse_needs_level_and_growth():
    ramp = [_tick(float(i), backlog=i) for i in range(1, 40)]
    suite = DetectorSuite.replay(events_from_dicts(ramp))
    assert suite.count("cpu_queue_collapse") == 1
    assert suite.incidents[0]["evidence"]["cpu_backlog"] >= 16
    # a steady (non-growing) backlog is load, not collapse
    flat = [_tick(float(i), backlog=20) for i in range(1, 200)]
    suite = DetectorSuite.replay(events_from_dicts(flat))
    assert suite.count("cpu_queue_collapse") == 0


# --- detectors: kv_thrash ----------------------------------------------------

def test_kv_thrash_counts_round_trips_in_window():
    rows = []
    for i in range(6):      # 3 demote<->promote round trips over 50s
        rows.append(_e(ev.DEMOTE if i % 2 == 0 else ev.PROMOTE,
                       10.0 * i, sid=3, blocks=4))
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count("kv_thrash") == 1
    assert suite.incidents[0]["evidence"]["migrations"] == 6
    # same migrations spread over 500s: slow churn, not thrash
    slow = [_e(ev.DEMOTE if i % 2 == 0 else ev.PROMOTE, 100.0 * i, sid=3)
            for i in range(6)]
    suite = DetectorSuite.replay(events_from_dicts(slow))
    assert suite.count("kv_thrash") == 0


# --- detectors: event_loss ---------------------------------------------------

def test_event_loss_live_from_ring_eviction():
    bus = EventBus(max_log=4)
    suite = DetectorSuite(bus)
    for i in range(10):
        bus.emit("filler", float(i), i)
    assert suite.count("event_loss") == 0     # not yet observed
    bus.emit(ev.TICK, 10.0, -1, elapsed=1.0)
    assert suite.count("event_loss") == 1
    assert suite.incidents[0]["evidence"]["source"] == "ring"
    # 6 fillers evicted + the TICK's own eviction; the INCIDENT the suite
    # emits back onto the full ring bumps the live counter past the record
    assert suite.incidents[0]["evidence"]["total_dropped"] == 7
    assert bus.dropped >= 7


def test_event_loss_replay_from_trace_meta(tmp_path):
    p = tmp_path / "lossy.jsonl"
    write_events_jsonl(events_from_dicts([_e(ev.SUBMIT, 0.0)]), str(p),
                       dropped=7)
    suite = DetectorSuite.replay(load_events_jsonl(str(p)))
    assert suite.count("event_loss") == 1
    assert suite.incidents[0]["evidence"]["dropped"] == 7
    # a clean dump replays without the incident
    clean = tmp_path / "clean.jsonl"
    write_events_jsonl(events_from_dicts([_e(ev.SUBMIT, 0.0)]), str(clean))
    assert DetectorSuite.replay(load_events_jsonl(str(clean))).count() == 0


# --- clean stream -> zero incidents ------------------------------------------

def test_clean_lifetime_stream_no_incidents():
    rows = [
        _e(ev.SUBMIT, 0.0, slo_class="standard", ideal_s=5.0),
        _e(ev.GPU_SUBMIT, 1.0, round=0),
        _e(ev.DECODE_STEP, 2.0, start=1.0, tokens=8),
        _e(ev.TOOL_ENQUEUE, 3.0, kind="t", expected_s=2.0),
        _e(ev.TOOL_START, 3.5, kind="t"),
        _e(ev.TOOL_END, 5.5, kind="t", duration=2.0),
        _e(ev.FINISH, 8.0, latency=8.0),
    ]
    rows += [_tick(float(i)) for i in range(9, 120)]
    suite = DetectorSuite.replay(events_from_dicts(rows))
    assert suite.count() == 0 and suite.incidents == []


# --- flight recorder ---------------------------------------------------------

def _thrash(bus, sid=3):
    for i in range(6):
        bus.emit(ev.DEMOTE if i % 2 == 0 else ev.PROMOTE,
                 10.0 * i, sid, blocks=4)


def test_flight_recorder_dumps_replayable_bundle(tmp_path):
    bus = EventBus()
    DetectorSuite(bus)
    rec = FlightRecorder(bus, str(tmp_path / "bundles"))
    bus.emit(ev.SUBMIT, 0.0, 3)
    _thrash(bus)
    assert len(rec.bundles) == 1 and rec.incidents_seen == 1
    bundle = rec.bundles[0]
    assert os.path.basename(bundle).endswith("kv_thrash")
    inc = json.load(open(os.path.join(bundle, "incident.json")))
    assert inc["incident"]["kind"] == "kv_thrash"
    assert inc["incident"]["sid"] == 3
    assert inc["ring"]["dropped"] == 0
    # events.jsonl replays through the standard pipeline
    events = load_events_jsonl(os.path.join(bundle, "events.jsonl"))
    assert any(e.kind == ev.INCIDENT for e in events)
    Tracer.replay(events)                                  # no raise
    assert trace_report.main(
        [os.path.join(bundle, "events.jsonl"), "--strict"]) == 0


def test_flight_recorder_lossy_ring_fails_strict_report(tmp_path, capsys):
    bus = EventBus(max_log=3)                  # evicts: dump will be lossy
    DetectorSuite(bus)
    rec = FlightRecorder(bus, str(tmp_path / "bundles"))
    _thrash(bus)
    path = os.path.join(rec.bundles[0], "events.jsonl")
    assert trace_report.main([path]) == 0      # warns, still reports
    assert "lossy" in capsys.readouterr().err
    assert trace_report.main([path, "--strict"]) == 2


def test_flight_recorder_caps_bundles(tmp_path):
    bus = EventBus()
    DetectorSuite(bus)
    rec = FlightRecorder(bus, str(tmp_path / "b"), max_bundles=1)
    _thrash(bus, sid=3)
    _thrash(bus, sid=4)                        # second incident, no dump
    assert rec.incidents_seen == 2 and len(rec.bundles) == 1


# --- lossy / truncated JSONL replay ------------------------------------------

def _lifetime_bus():
    bus = EventBus()
    for d in [_e(ev.SUBMIT, 0.0, tokens=64, rounds=1),
              _e(ev.GPU_SUBMIT, 1.0, round=0),
              _e(ev.PREFILL_CHUNK, 2.0, start=1.0, tokens=64, round=0),
              _e(ev.DECODE_STEP, 3.0, start=2.0, tokens=8, round=0),
              _e(ev.GPU_END, 3.0, round=0),
              _e(ev.FINISH, 3.0, latency=3.0)]:
        bus.emit(d["kind"], d["t"], d["sid"], **d["data"])
    return bus


def test_tracer_replay_tolerates_truncated_dump(tmp_path):
    p = tmp_path / "events.jsonl"
    n = dump_events_jsonl(_lifetime_bus(), str(p))
    assert n == 6
    lines = p.read_text().splitlines()
    # dump cut off mid-write: final line half-gone, plus line noise
    damaged = lines[:-1] + [lines[-1][: len(lines[-1]) // 2], "{not json"]
    p.write_text("\n".join(damaged) + "\n")
    events = load_events_jsonl(str(p))
    assert len(events) == n                    # header + events - FINISH
    tr = Tracer.replay(events)
    assert tr.finished_count == 0              # FINISH was the cut line
    cp = tr.critical_path(1, allow_unfinished=True)
    assert cp is not None and cp["e2e"] > 0    # partial timeline survives
    rows, dropped = trace_report.rows_from_jsonl(str(p))
    assert dropped == 0 and rows == []


def test_trace_report_rows_surface_header_drop_count(tmp_path):
    p = tmp_path / "events.jsonl"
    write_events_jsonl(list(_lifetime_bus().log), str(p), dropped=11)
    rows, dropped = trace_report.rows_from_jsonl(str(p))
    assert dropped == 11 and len(rows) == 1
    assert trace_report.main([str(p), "--strict"]) == 2


# --- fleet health rollup -----------------------------------------------------

def test_health_report_status_ladder():
    from repro_torch.distributed.router import ClusterRouter, RouterConfig
    router = ClusterRouter(RouterConfig(heartbeat_timeout=5.0))
    for rid in ("r0", "r1"):
        router.register(rid, now=0.0)
        router.heartbeat(rid, kv_utilization=0.4, tool_backlog=0,
                         active_sessions=2, step_latency=0.01, now=1.0)
    assert HealthReport.collect(router).status == "healthy"

    # incidents on a live replica escalate to degraded
    suite = DetectorSuite()
    suite._fire("tool_stall", 10.0, 7, {"running_s": 99.0})
    rep = HealthReport.collect(router, detectors={"r0": suite})
    assert rep.status == "degraded"
    assert rep.incidents == {"tool_stall": 1}
    r0 = next(r for r in rep.replicas if r.rid == "r0")
    assert r0.status == "degraded" and r0.incidents == {"tool_stall": 1}
    assert "tool_stallx1" in rep.render()

    # heartbeat timeout: dead replica wins the ladder
    router.heartbeat("r0", kv_utilization=0.4, tool_backlog=0,
                     active_sessions=2, step_latency=0.01, now=20.0)
    router.check_failures(now=20.0)            # r1 last beat at t=1
    rep = HealthReport.collect(router)
    assert rep.status == "critical"
    assert rep.fleet["alive"] == 1
    assert rep.render().startswith("fleet health: CRITICAL")
    assert rep.to_dict()["replicas"][1]["status"] == "dead"


def test_health_report_includes_slo_rollup():
    from repro_torch.distributed.router import ClusterRouter, RouterConfig
    router = ClusterRouter(RouterConfig())
    router.register("r0", now=0.0)
    router.heartbeat("r0", kv_utilization=0.1, tool_backlog=0,
                     active_sessions=0, step_latency=0.01, now=0.5)
    slo = SloTracker.replay(events_from_dicts([
        _e(ev.SUBMIT, 0.0, slo_class="standard", ideal_s=2.0),
        _e(ev.FINISH, 3.0, latency=3.0),
    ]))
    rep = HealthReport.collect(router, slo=slo)
    assert rep.slo["classes"]["standard"]["good"] == 1
    assert "slo[standard]: goodput 100.00%" in rep.render()


# --- metrics: live gauges ----------------------------------------------------

def test_gauge_set_fn_is_live_until_overwritten():
    reg = MetricsRegistry()
    box = {"v": 1.0}
    g = reg.gauge("x")
    g.set_fn(lambda: box["v"])
    assert reg.snapshot()["gauges"]["x"] == 1.0
    box["v"] = 5.0
    assert reg.snapshot()["gauges"]["x"] == 5.0
    g.set(2.0)                                 # explicit set detaches the fn
    box["v"] = 9.0
    assert reg.snapshot()["gauges"]["x"] == 2.0


# --- sim integration (fault injector -> detector -> recorder) ----------------

@pytest.fixture()
def _sim_parts():
    # sessions are regenerated per test: the sim mutates them in place
    from repro_torch.configs.qwen3_coder_30b import CONFIG
    from repro_torch.engine.backend import SimBackend
    from repro_torch.models.perf_model import H100
    from repro_torch.workloads.generator import WorkloadSpec, generate
    spec = WorkloadSpec(regime="S-ILR1", arrival_rate=0.2, n_sessions=10,
                        seed=7, max_context=40_000, tool_time_scale=0.25,
                        slo_class="standard")
    sessions = generate(spec, CONFIG, H100)
    return CONFIG, H100, SimBackend, sessions


def _engine(CONFIG, H100, SimBackend):
    from repro_torch.engine.engine import Engine, EngineConfig
    return Engine(EngineConfig(total_kv_blocks=16_384, block_size=32,
                               token_budget=8192, cpu_slots=32),
                  "mars", SimBackend(CONFIG, H100), bus=EventBus())


def test_clean_sim_run_produces_zero_incidents(_sim_parts):
    from repro_torch.engine.engine import run_sim
    CONFIG, H100, SimBackend, sessions = _sim_parts
    eng = _engine(CONFIG, H100, SimBackend)
    suite = DetectorSuite.install(eng)
    slo = SloTracker.install(eng)
    finished, _ = run_sim(eng, list(sessions), max_time=5000.0)
    assert len(finished) == 10
    assert suite.count() == 0, suite.incidents
    rep = slo.report()
    assert rep["classes"]["standard"]["sessions"] == 10
    assert rep["classes"]["standard"]["finished"] == 10


def test_stuck_tool_sim_detected_and_recorded(_sim_parts, tmp_path):
    from repro_torch.engine.engine import run_sim
    from repro_torch.engine.faults import Fault, FaultPlan
    CONFIG, H100, SimBackend, sessions = _sim_parts
    eng = _engine(CONFIG, H100, SimBackend)
    # thresholds shrunk so the tiny workload trips them well before it
    # drains; slo_bench proves the production defaults at scale
    suite = DetectorSuite.install(eng, config=DetectorConfig(
        tool_stall_factor=2.0, tool_stall_min_s=5.0))
    rec = FlightRecorder.install(eng, str(tmp_path / "bundles"))
    plan = FaultPlan([Fault(kind="stuck_tool", at_s=30.0,
                            stretch=1e6)]).install(eng)
    run_sim(eng, list(sessions), max_time=3000.0)
    assert plan.faults[0].hits >= 1
    assert suite.count("tool_stall") >= 1
    evd = next(i for i in suite.incidents
               if i["kind"] == "tool_stall")["evidence"]
    assert evd["running_s"] > evd["bound_s"]
    # the recorder froze a bundle the moment the detector fired
    assert rec.bundles, "incident must produce a flight-recorder bundle"
    inc = json.load(open(os.path.join(rec.bundles[0], "incident.json")))
    assert inc["incident"]["kind"] == "tool_stall"
    assert inc["critical_path"] is not None    # stuck session attributed


# --- workload spec: SLO class stamping ---------------------------------------

def test_workload_slo_class_stamp_is_rng_neutral():
    from repro_torch.configs.qwen3_coder_30b import CONFIG
    from repro_torch.models.perf_model import H100
    from repro_torch.workloads.generator import WorkloadSpec, generate
    kw = dict(regime="S-ILR1", arrival_rate=0.2, n_sessions=6, seed=11,
              max_context=40_000)
    tagged = generate(WorkloadSpec(slo_class="interactive", **kw),
                      CONFIG, H100)
    plain = generate(WorkloadSpec(**kw), CONFIG, H100)
    assert all(s.meta["slo_class"] == "interactive" for s in tagged)
    assert all("slo_class" not in s.meta for s in plain)
    # stamping consumes no randomness: identical arrivals either way
    assert [s.arrival_time for s in tagged] == \
        [s.arrival_time for s in plain]
    assert [s.ideal_time for s in tagged] == \
        [s.ideal_time for s in plain]


# --- the port against the reference ------------------------------------------

def test_detectors_and_slo_match_reference_on_one_stream(tmp_path):
    """A small stuck-tool sim on the port's engine (detectors and SLO
    tracker live), dumped as JSONL, read back by each package and
    replayed: both packages' DetectorSuite give the live incidents, both
    SloTrackers the live report."""
    from repro import obs as jobs
    from repro_torch.configs.qwen3_coder_30b import CONFIG
    from repro_torch.engine.backend import SimBackend
    from repro_torch.engine.engine import run_sim
    from repro_torch.engine.faults import Fault, FaultPlan
    from repro_torch.models.perf_model import H100
    from repro_torch.workloads.generator import WorkloadSpec, generate
    spec = WorkloadSpec(regime="S-ILR1", arrival_rate=0.2, n_sessions=4,
                        seed=7, max_context=20_000, tool_time_scale=0.25,
                        slo_class="standard")
    eng = _engine(CONFIG, H100, SimBackend)
    cfg = dict(tool_stall_factor=2.0, tool_stall_min_s=5.0)
    suite = DetectorSuite.install(eng, config=DetectorConfig(**cfg))
    slo = SloTracker.install(eng)
    FaultPlan([Fault(kind="stuck_tool", at_s=10.0, stretch=1e6)]).install(eng)
    run_sim(eng, generate(spec, CONFIG, H100), max_time=1500.0)
    assert suite.count("tool_stall") >= 1
    path = str(tmp_path / "events.jsonl")
    dump_events_jsonl(eng.bus, path)
    def plain(incidents, report):            # as JSON holds them
        return json.loads(json.dumps([incidents, report]))

    live = plain(suite.incidents, slo.report())
    for pkg in (jobs, importlib.import_module("repro_torch.obs")):
        events = pkg.load_events_jsonl(path)
        got = pkg.DetectorSuite.replay(
            events, config=pkg.DetectorConfig(**cfg))
        assert plain(got.incidents,
                     pkg.SloTracker.replay(events).report()) == live, \
            pkg.__name__
