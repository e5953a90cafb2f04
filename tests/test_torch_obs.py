"""The port's copy of the observability plane (``repro_torch.obs``) on
the port's engine: every test of tests/test_obs.py, pointed at the port
(span-tree assembly from synthetic event logs, bucket exclusivity, exact
on synthetic input and within 1% on a sim run of the port's Engine over
``SimBackend``, histogram percentiles, the Perfetto export written by the
port against the reference's ``scripts/trace_report.py`` schema gate, the
EventBus ring, the Telemetry probe/tick split). Then the port's Tracer and
the reference's, each over its own package's Engine in one seeded sim
scenario, give equal aggregates and critical paths.
"""
import importlib.util
import json
import os

import pytest

from repro_torch.core import events as ev
from repro_torch.core.events import EventBus
from repro_torch.core.telemetry import Telemetry, TelemetryConfig
from repro_torch.obs import (MetricsRegistry, PLANES, Histogram, Tracer,
                       bind_engine_probes, breakdown_table,
                       dump_events_jsonl, events_from_dicts,
                       export_perfetto, load_events_jsonl)

REPO = os.path.join(os.path.dirname(__file__), "..")

_spec = importlib.util.spec_from_file_location(
    "trace_report", os.path.join(REPO, "scripts", "trace_report.py"))
trace_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_report)


# --- synthetic span assembly -------------------------------------------------

def _e(k, t, sid=1, **data):
    return {"kind": k, "t": t, "sid": sid, "data": data}


def _basic_lifetime():
    """submit -> admit -> prefill -> decode -> tool (with an overlapping
    swap-out) -> restore-gated resume -> swap-in -> decode -> finish."""
    return events_from_dicts([
        _e(ev.SUBMIT, 0.0, tokens=128, rounds=2),
        _e(ev.GPU_SUBMIT, 1.0, round=0),
        _e(ev.PREFILL_CHUNK, 2.0, start=1.0, tokens=128, round=0),
        _e(ev.DECODE_STEP, 3.0, start=2.0, tokens=8, round=0),
        _e(ev.GPU_FIRST_TOKEN, 3.0, ttft=3.0),
        _e(ev.GPU_END, 3.0, round=0),
        _e(ev.RETENTION, 3.0, action="OFFLOAD", ttl=0.0, blocks=4),
        _e(ev.SWAP_OUT, 3.0, tokens=128),          # overlaps the tool
        _e(ev.TOOL_ENQUEUE, 3.0, kind="search"),
        _e(ev.TOOL_START, 4.0, kind="search"),
        _e(ev.TOOL_END, 6.0, kind="search", duration=2.0),
        _e(ev.GPU_SUBMIT, 6.5, round=1),           # restore still pending
        _e(ev.SWAP_IN, 7.0, start=6.5, tokens=128),
        _e(ev.DECODE_STEP, 8.0, start=7.0, tokens=8, round=1),
        _e(ev.GPU_END, 8.0, round=1),
        _e(ev.FINISH, 8.0),
    ])


def test_synthetic_exclusive_timeline_partitions_e2e_exactly():
    tr = Tracer.replay(_basic_lifetime())
    cp = tr.critical_path(1)
    assert cp is not None and cp["e2e"] == 8.0
    # exact partition: no float tolerance needed on hand-built input
    assert sum(cp["buckets"].values()) == pytest.approx(8.0, abs=1e-12)
    assert cp["by_kind"] == pytest.approx({
        "admit_wait": 1.0, "prefill": 1.0, "decode": 2.0,
        "tool_queue": 1.0, "tool_exec": 2.0,
        "restore_wait": 0.5, "swap_in": 0.5})
    assert cp["buckets"] == pytest.approx(
        {"gpu": 3.0, "cpu": 3.0, "io": 1.0, "control": 1.0})
    assert cp["dominant_bucket"] in ("gpu", "cpu")
    # segments are contiguous: each starts where the previous ended
    segs = tr.trace(1).segments
    for a, b in zip(segs, segs[1:]):
        assert b.start == pytest.approx(a.end)


def test_span_tree_keeps_overlapping_overlays():
    tr = Tracer.replay(_basic_lifetime())
    tree = tr.span_tree(1)
    assert tree["submitted"] == 0.0 and tree["finished"] == 8.0
    kinds = {sp.kind for r in tree["rounds"] for sp in r["spans"]}
    # the swap-out overlay survives alongside the tool spans it overlaps
    assert {"swap_out", "tool_exec", "retention", "first_token"} <= kinds
    r0 = next(r for r in tree["rounds"] if r["round"] == 0)
    tool = next(sp for sp in r0["spans"] if sp.kind == "tool_exec")
    queue = next(sp for sp in r0["spans"] if sp.kind == "tool_queue")
    swap = next(sp for sp in r0["spans"] if sp.kind == "swap_out")
    # the swap-out overlay lands inside the tool-yield window it overlaps
    assert queue.start <= swap.start <= tool.end


def test_abandoned_swap_recompute_fallback():
    """A swap-out whose restore is abandoned (pool pressure) charges the
    wait so far to the io plane, then falls back to recompute (prefill)
    under sched_wait — and the timeline still partitions e2e."""
    tr = Tracer.replay(events_from_dicts([
        _e(ev.SUBMIT, 0.0),
        _e(ev.GPU_SUBMIT, 0.5, round=0),
        _e(ev.PREFILL_CHUNK, 1.0, start=0.5, tokens=64, round=0),
        _e(ev.GPU_END, 1.0, round=0),
        _e(ev.SWAP_OUT, 1.0, tokens=64),
        _e(ev.TOOL_ENQUEUE, 1.0, kind="t"),
        _e(ev.TOOL_START, 1.0, kind="t"),
        _e(ev.TOOL_END, 2.0, kind="t", duration=1.0),
        _e(ev.SWAP_ABANDON, 3.0, tokens=64),       # restore given up
        _e(ev.GPU_SUBMIT, 3.5, round=1),
        _e(ev.PREFILL_CHUNK, 4.5, start=3.5, tokens=64, round=1),  # recompute
        _e(ev.DECODE_STEP, 5.0, start=4.5, tokens=4, round=1),
        _e(ev.GPU_END, 5.0, round=1),
        _e(ev.FINISH, 5.0),
    ]))
    cp = tr.critical_path(1)
    assert sum(cp["buckets"].values()) == pytest.approx(cp["e2e"], abs=1e-12)
    # 1s of post-tool wait was restore-gated (io), 0.5s ordinary sched wait
    assert cp["by_kind"]["restore_wait"] == pytest.approx(1.0)
    assert cp["by_kind"]["sched_wait"] == pytest.approx(0.5)
    assert "swap_in" not in cp["by_kind"]          # never restored
    assert any(sp.kind == "swap_abandon" for sp in tr.trace(1).spans)


def test_jsonl_round_trip(tmp_path):
    bus = EventBus()
    for e in _basic_lifetime():
        bus.emit(e.kind, e.t, e.sid, **e.data)
    p = tmp_path / "events.jsonl"
    n = dump_events_jsonl(bus, str(p))
    assert n == len(bus.log)
    tr = Tracer.replay(load_events_jsonl(str(p)))
    assert tr.finished_count == 1
    assert sum(tr.critical_path(1)["buckets"].values()) == \
        pytest.approx(8.0, abs=1e-12)


# --- real sim run ------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_tracer():
    from repro_torch.configs.qwen3_coder_30b import CONFIG, CONTEXT_LIMIT
    from repro_torch.engine.backend import SimBackend
    from repro_torch.engine.engine import Engine, EngineConfig, run_sim
    from repro_torch.models.perf_model import H100
    from repro_torch.workloads.generator import WorkloadSpec, generate
    spec = WorkloadSpec(regime="ILR-2", arrival_rate=0.25, n_sessions=10,
                        seed=4, max_context=CONTEXT_LIMIT)
    sessions = generate(spec, CONFIG, H100)
    eng = Engine(EngineConfig(total_kv_blocks=9500, cpu_slots=16),
                 "mars", SimBackend(CONFIG, H100))
    reg = MetricsRegistry()
    tr = Tracer.install(eng, metrics=reg)
    bind_engine_probes(reg, eng)
    finished, _ = run_sim(eng, sessions, max_time=1e5)
    return tr, eng, finished


def test_sim_buckets_partition_e2e_within_tolerance(sim_tracer):
    tr, eng, finished = sim_tracer
    assert tr.finished_count == len(finished) > 0
    for sid in tr.finished_sids():
        cp = tr.critical_path(sid)
        assert sum(cp["buckets"].values()) == \
            pytest.approx(cp["e2e"], rel=0.01)     # acceptance bar: 1%
        assert all(v >= 0 for v in cp["buckets"].values())
    agg = tr.aggregate()
    assert sum(agg["bucket_frac"].values()) == pytest.approx(1.0, rel=1e-6)


def test_sim_e2e_matches_engine_accounting(sim_tracer):
    """The tracer's e2e (finish - submit) agrees with the session's own
    latency accounting for every finished session."""
    tr, _, finished = sim_tracer
    for s in finished:
        cp = tr.critical_path(s.sid)
        assert cp["e2e"] == pytest.approx(s.e2e_latency, rel=1e-9)


def test_sim_tick_events_and_retention_audits(sim_tracer):
    tr, eng, _ = sim_tracer
    assert len(tr.ticks) > 0
    te = tr.ticks[-1].data
    assert set(te["phases"]) == {"tools_control", "upkeep", "form_batch",
                                 "run_batch", "bookkeep"}
    assert te["wall_s"] >= 0
    audits = eng.bus.of_kind(ev.RETENTION)
    assert audits, "trace_ticks must emit retention audit records"
    a = audits[0].data
    assert {"action", "ttl", "blocks", "recompute_s"} <= set(a)
    assert a["action"] in ("FREE", "PIN", "SWAP", "OFFLOAD", "OFFLOAD_DISK")


def test_sim_metrics_histograms_fed(sim_tracer):
    tr, eng, _ = sim_tracer
    snap = tr.metrics.snapshot()
    assert snap["histograms"]["trace.e2e_s"]["count"] == tr.finished_count
    assert snap["histograms"]["trace.tool_s"]["count"] > 0
    assert snap["telemetry"]["active_sessions"] == 0    # drained
    assert snap["events"]["counts"][ev.FINISH] == tr.finished_count
    assert snap["events"]["dropped"] == 0


def test_perfetto_export_schema(sim_tracer, tmp_path):
    tr, _, _ = sim_tracer
    p = tmp_path / "trace.json"
    doc = export_perfetto(tr, str(p))
    assert trace_report.validate_perfetto(doc) == []
    on_disk = json.loads(p.read_text())
    assert trace_report.validate_perfetto(on_disk) == []
    # the report recomputes the same totals from the exported slices
    rows = trace_report.rows_from_perfetto(on_disk)
    assert len(rows) == tr.finished_count
    for r in rows:
        cp = tr.critical_path(r["sid"])
        for plane in PLANES:
            assert r["buckets"][plane] == \
                pytest.approx(cp["buckets"][plane], abs=1e-5)
    assert breakdown_table(rows)                        # renders


def test_trace_report_main_gates_schema(sim_tracer, tmp_path, capsys):
    tr, _, _ = sim_tracer
    good = tmp_path / "good.json"
    export_perfetto(tr, str(good))
    assert trace_report.main([str(good), "--max-rows", "3"]) == 0
    out = capsys.readouterr().out
    assert "finished sessions" in out and "TOTAL" in out
    # a malformed export (session slice without plane) must fail
    doc = json.loads(good.read_text())
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and "sid" in e.get("args", {}):
            del e["args"]["plane"]
            break
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert trace_report.main([str(bad)]) == 1


def test_multi_replica_export_has_one_process_per_tracer():
    trs = {}
    for rid in ("replica-a", "replica-b"):
        trs[rid] = Tracer.replay(_basic_lifetime())
    doc = export_perfetto(trs)
    assert trace_report.validate_perfetto(doc) == []
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert procs == {"replica-a", "replica-b"}


# --- histogram ---------------------------------------------------------------

def test_histogram_percentiles_interpolate():
    h = Histogram(bounds=[10.0, 20.0, 30.0])
    for v in (5.0, 12.0, 14.0, 25.0):
        h.observe(v)
    s = h.snapshot()
    assert s["count"] == 4 and s["min"] == 5.0 and s["max"] == 25.0
    assert s["mean"] == pytest.approx(14.0)
    # p50 lands in the (10, 20] bucket, interpolated inside it
    assert 10.0 <= s["p50"] <= 20.0
    # percentiles clamp to observed extremes, never bucket infinities
    assert s["p99"] <= 25.0
    assert Histogram().snapshot()["count"] == 0       # empty is well-formed


def test_histogram_percentiles_against_exact_quantiles():
    h = Histogram()                                    # default log bounds
    vals = [0.001 * (i + 1) for i in range(1000)]      # 1ms .. 1s uniform
    for v in vals:
        h.observe(v)
    # fixed-bucket interpolation should land within a bucket's width of
    # the exact empirical quantile (log buckets: ~77% relative spacing)
    for q in (0.5, 0.95, 0.99):
        exact = vals[int(q * len(vals)) - 1]
        assert h.percentile(q) == pytest.approx(exact, rel=0.5)
    assert h.percentile(1.0) <= h.max


# --- event bus ring + index --------------------------------------------------

def test_eventbus_ring_caps_log_and_counts_drops():
    bus = EventBus(max_log=10)
    for i in range(25):
        bus.emit("k", float(i), i)
    assert len(bus.log) == 10
    assert bus.dropped == 15
    assert [e.t for e in bus.log] == [float(i) for i in range(15, 25)]
    # per-kind index is bounded the same way and stays consistent
    assert [e.t for e in bus.of_kind("k")] == [e.t for e in bus.log]
    # counts keep the true total (monotone, unaffected by the ring)
    assert bus.counts["k"] == 25


def test_eventbus_of_kind_index_matches_log_scan():
    bus = EventBus()
    for i in range(30):
        bus.emit("a" if i % 3 else "b", float(i), i)
    for kind in ("a", "b"):
        assert [e.t for e in bus.of_kind(kind)] == \
            [e.t for e in bus.log if e.kind == kind]
    assert bus.of_kind("missing") == []


def test_eventbus_unbounded_by_default():
    bus = EventBus()
    for i in range(5000):
        bus.emit("k", float(i), i)
    assert len(bus.log) == 5000 and bus.dropped == 0


# --- telemetry probe/tick split ---------------------------------------------

def test_probe_gpu_does_not_advance_hysteresis():
    bus = EventBus()
    t = Telemetry(TelemetryConfig(cpu_slots=2, hysteresis_checks=2), bus)
    bus.emit(ev.TOOL_START, 0.0, 1, kind="x")
    bus.emit(ev.TOOL_START, 0.0, 2, kind="x")          # CPU plane saturated
    for _ in range(5):                                 # probes alone: no flip
        t.probe_gpu(100, 50, 0, 2, 1, 0)
    assert not t.cpu_overloaded
    t.tick()
    assert not t.cpu_overloaded                        # 1 of 2 checks
    t.tick()
    assert t.cpu_overloaded                            # hysteresis met


# --- the port against the reference ------------------------------------------

def _traced(pkg):
    """``pkg``'s Tracer (with a metrics registry) over ``pkg``'s Engine in
    the seeded scenario of tests/test_torch_control_plane.py."""
    import importlib
    from test_torch_control_plane import _sim_engine
    obs = importlib.import_module(f"{pkg}.obs")
    eng, sessions, run_sim = _sim_engine(pkg)
    tr = obs.Tracer.install(eng, metrics=obs.MetricsRegistry())
    run_sim(eng, sessions, max_time=2e5)
    return tr


def test_tracer_matches_reference_on_sim():
    ref, mine = _traced("repro"), _traced("repro_torch")
    assert mine.finished_count == ref.finished_count >= 8
    assert mine.finished_sids() == ref.finished_sids()
    assert mine.aggregate() == ref.aggregate()
    for sid in ref.finished_sids():
        assert mine.critical_path(sid) == ref.critical_path(sid)
    # every histogram but the tick's host wall time, which is measured
    hist = [t.metrics.snapshot()["histograms"] for t in (mine, ref)]
    for h in hist:
        assert h.pop("trace.tick_wall_s")["count"] > 0
    assert hist[0] == hist[1]
