"""Observability plane over the unified event stream (paper §4.1).

Postmortem half: ``Tracer`` assembles per-session span trees and
exclusive critical-path segments from the :class:`repro.core.events.
EventBus`; ``MetricsRegistry`` unifies the repo's ad-hoc counters behind
one snapshot API; and ``export_perfetto`` writes a Chrome-trace JSON that
opens in ``ui.perfetto.dev``.

Online half: ``SloTracker`` scores sessions against their declared
:class:`SLOClass` as events arrive; ``DetectorSuite`` turns anomaly
signatures (livelock, stalls, storms, thrash, event loss) into structured
``INCIDENT`` events; ``FlightRecorder`` freezes a replayable JSONL bundle
the moment one fires; and ``HealthReport`` rolls replica vitals and
incident counts up to one fleet status. See ROADMAP.md "Observability"
and docs/OBSERVABILITY.md for formats and naming conventions.
"""
from repro_torch.obs.detect import INCIDENT_KINDS, DetectorConfig, DetectorSuite
from repro_torch.obs.health import HealthReport, ReplicaHealth
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               bind_engine_probes, bind_router_probe,
                               log_bounds)
from repro_torch.obs.perfetto import export_perfetto
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.slo import DEFAULT_SLO_CLASSES, SLOClass, SloTracker
from repro_torch.obs.trace import (PLANES, SessionTrace, Span, Tracer,
                             breakdown_table, dump_events_jsonl,
                             events_from_dicts, load_events_jsonl,
                             write_events_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "bind_engine_probes", "bind_router_probe", "log_bounds",
    "export_perfetto",
    "PLANES", "SessionTrace", "Span", "Tracer", "breakdown_table",
    "dump_events_jsonl", "events_from_dicts", "load_events_jsonl",
    "write_events_jsonl",
    "INCIDENT_KINDS", "DetectorConfig", "DetectorSuite",
    "SLOClass", "DEFAULT_SLO_CLASSES", "SloTracker",
    "FlightRecorder", "HealthReport", "ReplicaHealth",
]
