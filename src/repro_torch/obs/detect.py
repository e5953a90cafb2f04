"""Streaming anomaly detectors over the unified event stream.

Each detector is a small state machine fed by :class:`DetectorSuite`'s
single dispatch pump; when one trips it appends a structured incident
record *and* (live) emits an ``INCIDENT`` event back onto the bus — so
downstream consumers (the flight recorder, the fleet health rollup, the
cluster router in later PRs) see anomalies in the same stream as
everything else. Evidence rides in the record: the raw measurements that
crossed the threshold, not just a name.

Detector catalogue (kind -> signature):

    decode_livelock     a DECODING session stopped producing DECODE_STEPs
                        for ``livelock_ticks`` engine iterations while the
                        engine kept ticking (scheduler bug / starved lane)
    tool_stall          a started tool ran ``tool_stall_factor`` x its
                        promised ``expected_s`` (hung subprocess); measured
                        from TOOL_START so core-pool *queueing* — however
                        bad — never false-fires this one
    admission_stall     sessions kept waiting for ``admission_stall_ticks``
                        iterations with no round-0 GPU_SUBMIT even though
                        >= ``admission_free_frac`` of the KV pool is free
                        (a frozen control plane, not backpressure)
    swap_storm          the io bucket ate >= ``swap_io_frac`` of modeled
                        time over the last ``swap_window_ticks`` swap-
                        carrying iterations (degraded PCIe / thrash spiral)
    cpu_queue_collapse  shared-core backlog at/above ``cpu_min_backlog``
                        after growing >= ``cpu_min_growth`` within the
                        window (co-tenant flood; the coupled-pressure
                        failure mode MARS admission exists to avoid)
    kv_thrash           one session's KV ping-ponged demote<->promote
                        >= ``thrash_cycles`` round trips inside
                        ``thrash_window_s`` (retention mis-pricing)
    event_loss          the bus ring dropped events (live: ``bus.dropped``
                        advanced; replay: the dump's TRACE_META header says
                        so) — every downstream invariant is now suspect

Thresholds live in :class:`DetectorConfig`; the defaults are tuned so the
deterministic benchmark workloads (``benchmarks/slo_bench.py``) produce
zero incidents on clean runs and catch every injected fault —
``benchmarks/baselines.json`` gates exactly that.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core import events as ev
from repro_torch.core.events import Event, EventBus

INCIDENT_KINDS = ("decode_livelock", "tool_stall", "admission_stall",
                  "swap_storm", "cpu_queue_collapse", "kv_thrash",
                  "event_loss")


@dataclass
class DetectorConfig:
    # decode_livelock
    livelock_ticks: int = 400         # iterations with no DECODE_STEP
    # tool_stall (judged from TOOL_START; sim stretch is <= 1.25x, so 4x
    # the promise is unambiguous)
    tool_stall_factor: float = 4.0
    tool_stall_min_s: float = 60.0    # floor: never flag a quick tool
    tool_stall_max_s: float = 1800.0  # cap / fallback when expected_s unknown
    # admission_stall
    admission_stall_ticks: int = 300
    admission_free_frac: float = 0.5  # stall only counts with this much free
    # swap_storm
    swap_window_ticks: int = 64
    swap_io_frac: float = 0.8
    swap_min_busy_s: float = 5.0      # window io-seconds floor
    # cpu_queue_collapse
    cpu_window_ticks: int = 64
    cpu_min_backlog: int = 16
    cpu_min_growth: int = 8
    # kv_thrash
    thrash_cycles: int = 3            # demote<->promote round trips
    thrash_window_s: float = 120.0
    # re-fire suppression per (kind, sid)
    cooldown_s: float = 300.0


class DetectorSuite:
    """All detectors behind one bus subscription (or one replay pump)."""

    def __init__(self, bus: Optional[EventBus] = None, *,
                 config: Optional[DetectorConfig] = None, metrics=None):
        self.cfg = config or DetectorConfig()
        self.bus = bus
        self.metrics = metrics
        self.incidents: List[dict] = []
        self.tick_count = 0
        self._last_fired: Dict[Tuple[str, int], float] = {}
        # decode_livelock
        self._decoding: Dict[int, Tuple[int, float, int]] = {}
        #   sid -> (last decode tick index, last decode t, decoded tokens)
        self._livelock_armed: Dict[int, bool] = {}
        # tool_stall
        self._tools: Dict[int, Tuple[float, float, str]] = {}
        #   sid -> (start t, expected_s, kind)
        self._tool_fired: Dict[int, bool] = {}
        self._tool_expected: Dict[int, float] = {}
        #   sid -> promised duration (TOOL_ENQUEUE carries it; TOOL_START
        #   does not — the promise predates any queueing or fault stretch)
        # admission_stall
        self._last_admit_tick = 0
        self._waiting_streak = 0
        self._admission_armed = True
        # swap_storm: (elapsed, io_busy) per tick, with running sums so the
        # per-tick cost stays O(1) instead of O(window)
        self._swap_win: Deque[Tuple[float, float]] = deque(
            maxlen=self.cfg.swap_window_ticks)
        self._swap_tot = 0.0
        self._swap_busy = 0.0
        self._swap_armed = True
        # cpu_queue_collapse: backlog per tick
        self._cpu_win: Deque[int] = deque(maxlen=self.cfg.cpu_window_ticks)
        self._cpu_armed = True
        # kv_thrash: sid -> migration timestamps
        self._migrations: Dict[int, Deque[float]] = {}
        # event_loss
        self._dropped_seen = 0
        self._dispatch = {
            ev.TICK: self._on_tick,
            ev.DECODE_STEP: self._on_decode_step,
            ev.GPU_END: self._on_not_decoding,
            ev.TOOL_ENQUEUE: self._on_tool_enqueue,
            ev.FINISH: self._on_not_decoding,
            ev.PREEMPT: self._on_not_decoding,
            ev.EVICT: self._on_not_decoding,
            ev.SWAP_OUT: self._on_not_decoding,
            ev.GPU_SUBMIT: self._on_gpu_submit,
            ev.TOOL_START: self._on_tool_start,
            ev.TOOL_END: self._on_tool_end,
            ev.DEMOTE: self._on_migrate,
            ev.PROMOTE: self._on_migrate,
            ev.TRACE_META: self._on_trace_meta,
        }
        if bus is not None:
            bus.subscribe(None, self.on_event)

    # -- attachment --------------------------------------------------------
    @classmethod
    def install(cls, engine, **kw) -> "DetectorSuite":
        """Attach to an engine's bus; flips ``trace_ticks`` (the TICK-driven
        detectors need the per-iteration telemetry)."""
        suite = cls(engine.bus, **kw)
        engine.trace_ticks = True
        return suite

    @classmethod
    def replay(cls, events, **kw) -> "DetectorSuite":
        suite = cls(None, **kw)
        for e in events:
            suite.on_event(e)
        return suite

    # -- pump --------------------------------------------------------------
    def on_event(self, e: Event) -> None:
        fn = self._dispatch.get(e.kind)   # INCIDENT has no entry: no loops
        if fn is not None:
            fn(e)

    def count(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return len(self.incidents)
        return sum(1 for i in self.incidents if i["kind"] == kind)

    def _fire(self, kind: str, t: float, sid: int, evidence: dict) -> None:
        last = self._last_fired.get((kind, sid))
        if last is not None and t - last < self.cfg.cooldown_s:
            return
        self._last_fired[(kind, sid)] = t
        rec = {"kind": kind, "t": t, "sid": sid, "evidence": evidence}
        self.incidents.append(rec)
        if self.metrics is not None:
            self.metrics.counter(f"incidents.{kind}").inc()
        if self.bus is not None:
            self.bus.emit(ev.INCIDENT, t, sid, kind=kind, evidence=evidence)

    # -- decode_livelock ---------------------------------------------------
    def _on_decode_step(self, e: Event) -> None:
        self._decoding[e.sid] = (self.tick_count, e.t,
                                 int(e.data.get("decoded", 0)))
        self._livelock_armed[e.sid] = True

    def _on_not_decoding(self, e: Event) -> None:
        self._decoding.pop(e.sid, None)
        self._livelock_armed.pop(e.sid, None)

    # -- admission_stall ---------------------------------------------------
    def _on_gpu_submit(self, e: Event) -> None:
        if e.data.get("round", 0) == 0:
            self._last_admit_tick = self.tick_count
            self._admission_armed = True

    # -- tool_stall --------------------------------------------------------
    def _on_tool_enqueue(self, e: Event) -> None:
        self._tool_expected[e.sid] = float(e.data.get("expected_s") or 0.0)
        self._on_not_decoding(e)

    def _on_tool_start(self, e: Event) -> None:
        expected = self._tool_expected.pop(
            e.sid, float(e.data.get("expected_s") or 0.0))
        self._tools[e.sid] = (e.t, expected, e.data.get("kind", "?"))
        self._tool_fired[e.sid] = False

    def _on_tool_end(self, e: Event) -> None:
        self._tools.pop(e.sid, None)
        self._tool_fired.pop(e.sid, None)
        self._on_not_decoding(e)

    def _tool_bound(self, expected: float) -> float:
        c = self.cfg
        if expected <= 0.0:
            return c.tool_stall_max_s
        return min(c.tool_stall_max_s,
                   max(c.tool_stall_min_s, c.tool_stall_factor * expected))

    # -- kv_thrash ---------------------------------------------------------
    def _on_migrate(self, e: Event) -> None:
        c = self.cfg
        win = self._migrations.get(e.sid)
        if win is None:
            win = self._migrations[e.sid] = deque(maxlen=2 * c.thrash_cycles)
        win.append(e.t)
        if (len(win) == 2 * c.thrash_cycles
                and e.t - win[0] <= c.thrash_window_s):
            self._fire("kv_thrash", e.t, e.sid, {
                "migrations": len(win), "window_s": e.t - win[0],
                "first_t": win[0]})

    # -- TRACE_META (replayed dumps) ---------------------------------------
    def _on_trace_meta(self, e: Event) -> None:
        dropped = int(e.data.get("dropped", 0))
        if dropped > 0:
            self._fire("event_loss", e.t, -1, {
                "dropped": dropped, "source": "trace_meta",
                "events": e.data.get("events")})

    # -- per-tick scans ----------------------------------------------------
    # per-session scans run every _SCAN_STRIDE ticks: detection resolution
    # drops by at most the stride (negligible next to the 300-400 tick
    # thresholds) and the per-tick hot path stays O(1) — the obs plane's
    # <=3% CPU budget (obs_overhead_bench) is gated with these installed
    _SCAN_STRIDE = 8

    def _on_tick(self, e: Event) -> None:
        self.tick_count += 1
        c = self.cfg
        d = e.data
        t = e.t
        if self.tick_count % self._SCAN_STRIDE == 0:
            # decode_livelock: armed decoding sessions that stopped stepping
            for sid, (last_tick, last_t, decoded) in \
                    list(self._decoding.items()):
                stalled = self.tick_count - last_tick
                if stalled >= c.livelock_ticks \
                        and self._livelock_armed.get(sid):
                    self._livelock_armed[sid] = False  # re-arm on next step
                    self._fire("decode_livelock", t, sid, {
                        "ticks_stalled": stalled, "last_decode_t": last_t,
                        "decoded": decoded})
            # tool_stall: started tools exceeding their promise
            for sid, (start, expected, kind) in list(self._tools.items()):
                if self._tool_fired.get(sid):
                    continue
                bound = self._tool_bound(expected)
                if t - start > bound:
                    self._tool_fired[sid] = True
                    self._fire("tool_stall", t, sid, {
                        "kind": kind, "running_s": t - start,
                        "expected_s": expected, "bound_s": bound})
        # admission_stall: waiting streak, idle admission, free pool
        waiting = int(d.get("waiting", 0))
        self._waiting_streak = self._waiting_streak + 1 if waiting > 0 else 0
        if waiting == 0:
            self._admission_armed = True
        total = int(d.get("total_blocks", 0))
        free_frac = (d.get("free_blocks", 0) / total) if total else 0.0
        since_admit = self.tick_count - self._last_admit_tick
        if (self._admission_armed
                and self._waiting_streak >= c.admission_stall_ticks
                and since_admit >= c.admission_stall_ticks
                and free_frac >= c.admission_free_frac):
            self._admission_armed = False
            self._fire("admission_stall", t, -1, {
                "waiting": waiting, "ticks_since_admit": since_admit,
                "waiting_streak": self._waiting_streak,
                "free_frac": round(free_frac, 4)})
        # swap_storm: io share of modeled time across the window
        elapsed = float(d.get("elapsed", 0.0))
        io_busy = elapsed if (d.get("n_swapins", 0)
                              or d.get("n_swapouts", 0)) else 0.0
        if len(self._swap_win) == self._swap_win.maxlen:
            old_el, old_io = self._swap_win[0]
            self._swap_tot -= old_el
            self._swap_busy -= old_io
        self._swap_win.append((elapsed, io_busy))
        self._swap_tot += elapsed
        self._swap_busy += io_busy
        if len(self._swap_win) == self._swap_win.maxlen:
            tot = max(0.0, self._swap_tot)
            busy = max(0.0, self._swap_busy)
            frac = busy / tot if tot > 0 else 0.0
            if (self._swap_armed and frac >= c.swap_io_frac
                    and busy >= c.swap_min_busy_s):
                self._swap_armed = False
                self._fire("swap_storm", t, -1, {
                    "io_frac": round(frac, 4), "io_busy_s": round(busy, 3),
                    "window_ticks": len(self._swap_win)})
            elif frac < c.swap_io_frac / 2:
                self._swap_armed = True
        # cpu_queue_collapse: backlog level + growth inside the window
        backlog = int(d.get("cpu_backlog", 0))
        self._cpu_win.append(backlog)
        growth = backlog - self._cpu_win[0]
        if (self._cpu_armed and backlog >= c.cpu_min_backlog
                and growth >= c.cpu_min_growth):
            self._cpu_armed = False
            self._fire("cpu_queue_collapse", t, -1, {
                "cpu_backlog": backlog, "growth": growth,
                "window_ticks": len(self._cpu_win)})
        elif backlog < c.cpu_min_backlog / 2:
            self._cpu_armed = True
        # event_loss (live): the ring advanced its eviction counter
        if self.bus is not None and self.bus.dropped > self._dropped_seen:
            n = self.bus.dropped
            self._fire("event_loss", t, -1, {
                "dropped": n - self._dropped_seen, "total_dropped": n,
                "source": "ring"})
            self._dropped_seen = n
