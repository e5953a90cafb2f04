"""Streaming per-session SLO tracking over the unified event stream.

PR 6's tracer answers *where the time went* after the fact; this module
answers *is the fleet meeting its contract* while the run is still going.
An :class:`SLOClass` declares per-metric bounds — TTFT, decode inter-token
latency, tool turnaround overhead, and an end-to-end slowdown factor —
and the workload spec stamps a class name onto each session
(``WorkloadSpec.slo_class`` -> ``session.meta["slo_class"]`` -> the
``SUBMIT`` event). :class:`SloTracker` subscribes to the bus, folds every
latency sample into the fixed-bucket histograms from :mod:`repro.obs.
metrics` (rolling quantiles, no sample retention) and keeps per-class
violation and goodput accounting.

All state is driven purely by event *data* (``SUBMIT`` carries
``slo_class`` / ``slo_alpha`` / ``ideal_s``), so the same tracker runs
live on an engine bus or reconstructs from a JSONL dump via
:meth:`SloTracker.replay` — identical numbers either way.

Metric definitions (modeled clock):

    ttft_s          GPU_FIRST_TOKEN.ttft — per round, submit-to-first-token
    itl_s           DECODE_STEP (t - start) / tokens — per dispatched quantum
    tool_overhead_s TOOL_END.t - TOOL_ENQUEUE.t - TOOL_END.duration — the
                    *queueing + stretch* overhead beyond the tool's own
                    runtime (the part scheduling is accountable for)
    e2e_s           FINISH.latency, judged against alpha x ideal_s where
                    alpha is the session's slo_alpha (fallback: the class's
                    e2e_alpha) — sessions without an ideal_s are exempt

``goodput`` follows the paper's definition: finished sessions that met
their end-to-end bound, as a fraction and as req/s over the horizon.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core import events as ev
from repro_torch.core.events import Event, EventBus
from repro_torch.obs.metrics import MetricsRegistry

SLO_METRICS = ("ttft_s", "itl_s", "tool_overhead_s", "e2e_s")


@dataclass(frozen=True)
class SLOClass:
    """Per-metric bounds one workload class is served under."""
    name: str
    ttft_s: float = 10.0            # submit/resume -> first decode token
    itl_s: float = 0.5              # per-token decode latency
    tool_overhead_s: float = 60.0   # turnaround beyond the tool's runtime
    e2e_alpha: float = 3.0          # e2e bound = alpha x isolated ideal

    def bound(self, metric: str) -> float:
        return getattr(self, metric if metric != "e2e_s" else "e2e_alpha")


DEFAULT_SLO_CLASSES: Dict[str, SLOClass] = {
    c.name: c for c in (
        SLOClass("interactive", ttft_s=2.0, itl_s=0.25,
                 tool_overhead_s=15.0, e2e_alpha=2.0),
        SLOClass("standard", ttft_s=10.0, itl_s=0.5,
                 tool_overhead_s=60.0, e2e_alpha=3.0),
        SLOClass("batch", ttft_s=60.0, itl_s=2.0,
                 tool_overhead_s=600.0, e2e_alpha=10.0),
    )
}


class _SessionSLO:
    __slots__ = ("cls", "alpha", "ideal_s", "enqueued_at", "violations",
                 "finished", "e2e_ok")

    def __init__(self, cls: SLOClass, alpha: float, ideal_s: float):
        self.cls = cls
        self.alpha = alpha
        self.ideal_s = ideal_s
        self.enqueued_at: Optional[float] = None   # open tool turnaround
        self.violations: Dict[str, int] = {}
        self.finished = False
        self.e2e_ok: Optional[bool] = None

    def violate(self, metric: str) -> None:
        self.violations[metric] = self.violations.get(metric, 0) + 1


class SloTracker:
    """EventBus subscriber scoring sessions against their SLO class."""

    def __init__(self, bus: Optional[EventBus] = None, *,
                 classes: Optional[Dict[str, SLOClass]] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 default_class: str = "standard"):
        self.classes = dict(classes) if classes is not None \
            else dict(DEFAULT_SLO_CLASSES)
        if default_class not in self.classes:
            self.classes[default_class] = SLOClass(default_class)
        self.default_class = default_class
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.sessions: Dict[int, _SessionSLO] = {}
        self.rejected = 0
        self.horizon = 0.0
        self._dispatch = {
            ev.SUBMIT: self._on_submit,
            ev.REJECT: self._on_reject,
            ev.GPU_FIRST_TOKEN: self._on_first_token,
            ev.DECODE_STEP: self._on_decode_step,
            ev.TOOL_ENQUEUE: self._on_tool_enqueue,
            ev.TOOL_END: self._on_tool_end,
            ev.FINISH: self._on_finish,
        }
        if bus is not None:
            bus.subscribe(None, self.on_event)

    # -- attachment --------------------------------------------------------
    @classmethod
    def install(cls, engine, **kw) -> "SloTracker":
        return cls(engine.bus, **kw)

    @classmethod
    def replay(cls, events, **kw) -> "SloTracker":
        tr = cls(None, **kw)
        for e in events:
            tr.on_event(e)
        return tr

    # -- event pump --------------------------------------------------------
    def on_event(self, e: Event) -> None:
        if e.t > self.horizon:
            self.horizon = e.t
        fn = self._dispatch.get(e.kind)
        if fn is not None:
            fn(e)

    def _observe(self, st: _SessionSLO, metric: str, value: float,
                 bound: float) -> None:
        self.metrics.histogram(f"slo.{st.cls.name}.{metric}").observe(value)
        if value > bound:
            st.violate(metric)
            self.metrics.counter(
                f"slo.{st.cls.name}.{metric}.violations").inc()

    # -- handlers ----------------------------------------------------------
    def _on_submit(self, e: Event) -> None:
        if e.sid in self.sessions:       # cluster re-placement: keep state
            return
        name = e.data.get("slo_class") or self.default_class
        cls = self.classes.get(name)
        if cls is None:
            cls = self.classes[name] = SLOClass(name)
        alpha = float(e.data.get("slo_alpha") or cls.e2e_alpha)
        self.sessions[e.sid] = _SessionSLO(
            cls, alpha, float(e.data.get("ideal_s") or 0.0))

    def _on_reject(self, e: Event) -> None:
        self.rejected += 1

    def _st(self, e: Event) -> Optional[_SessionSLO]:
        return self.sessions.get(e.sid)

    def _on_first_token(self, e: Event) -> None:
        st = self._st(e)
        if st is not None:
            self._observe(st, "ttft_s", float(e.data.get("ttft", 0.0)),
                          st.cls.ttft_s)

    def _on_decode_step(self, e: Event) -> None:
        st = self._st(e)
        if st is None:
            return
        toks = max(1, int(e.data.get("tokens", 1)))
        itl = (e.t - float(e.data.get("start", e.t))) / toks
        self._observe(st, "itl_s", itl, st.cls.itl_s)

    def _on_tool_enqueue(self, e: Event) -> None:
        st = self._st(e)
        if st is not None:
            st.enqueued_at = e.t

    def _on_tool_end(self, e: Event) -> None:
        st = self._st(e)
        if st is None or st.enqueued_at is None:
            return
        turnaround = e.t - st.enqueued_at
        overhead = turnaround - float(e.data.get("duration", 0.0))
        st.enqueued_at = None
        self._observe(st, "tool_overhead_s", max(0.0, overhead),
                      st.cls.tool_overhead_s)

    def _on_finish(self, e: Event) -> None:
        st = self._st(e)
        if st is None or st.finished:
            return
        st.finished = True
        e2e = float(e.data.get("latency", 0.0))
        self.metrics.histogram(f"slo.{st.cls.name}.e2e_s").observe(e2e)
        if st.ideal_s > 0.0:
            st.e2e_ok = e2e <= st.alpha * st.ideal_s
            if not st.e2e_ok:
                st.violate("e2e_s")
                self.metrics.counter(
                    f"slo.{st.cls.name}.e2e_s.violations").inc()
        else:
            st.e2e_ok = True             # no declared ideal: exempt

    # -- rollup ------------------------------------------------------------
    def report(self) -> dict:
        """Per-class goodput/violation rollup + rolling quantiles."""
        by_cls: Dict[str, dict] = {}
        for st in self.sessions.values():
            c = by_cls.setdefault(st.cls.name, {
                "sessions": 0, "finished": 0, "good": 0,
                "violations": dict.fromkeys(SLO_METRICS, 0),
                "violated_sessions": 0})
            c["sessions"] += 1
            if st.finished:
                c["finished"] += 1
                if st.e2e_ok:            # paper goodput: e2e bound met
                    c["good"] += 1
            if st.violations:
                c["violated_sessions"] += 1
                for m, n in st.violations.items():
                    c["violations"][m] += n
        horizon = max(self.horizon, 1e-9)
        for name, c in by_cls.items():
            fin = c["finished"]
            c["goodput_frac"] = c["good"] / fin if fin else 0.0
            c["goodput_rps"] = c["good"] / horizon
            c["quantiles"] = {
                m: h.snapshot() for m in SLO_METRICS
                if (h := self.metrics.histograms.get(
                    f"slo.{name}.{m}")) is not None}
        return {"classes": by_cls, "rejected": self.rejected,
                "horizon_s": self.horizon,
                "sessions": len(self.sessions)}
