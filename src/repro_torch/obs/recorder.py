"""Bounded flight recorder: replayable post-incident trace bundles.

A crash dump for the scheduler: the recorder rides the bus with a bounded
event ring (cheap append, no I/O on the hot path) and, the moment a
detector emits an ``INCIDENT``, freezes the ring into a *bundle*
directory:

    <out_dir>/incident-000-<kind>/
        events.jsonl    the ring contents in the standard JSONL dump
                        format — ``Tracer.replay`` and
                        ``scripts/trace_report.py`` consume it directly;
                        its TRACE_META header carries the total dropped
                        count (bus ring + recorder ring), so lossy bundles
                        announce themselves
        incident.json   the incident record (kind, t, sid, evidence) plus
                        critical-path attribution: the implicated
                        session's partial per-plane breakdown (it usually
                        has not finished — that is why there is an
                        incident) and the fleet aggregate at dump time

``max_bundles`` caps disk usage for incident storms: later incidents are
counted but not dumped (the detector records still hold them).
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Deque, List, Optional

from repro_torch.core import events as ev
from repro_torch.core.events import Event, EventBus
from repro_torch.obs.trace import Tracer, write_events_jsonl


class FlightRecorder:
    def __init__(self, bus: EventBus, out_dir: str, *,
                 max_events: int = 200_000, max_bundles: int = 8):
        self.bus = bus
        self.out_dir = out_dir
        self.max_bundles = max_bundles
        self.ring: Deque[Event] = deque(maxlen=max_events)
        self.ring_dropped = 0
        self.bundles: List[str] = []
        self.incidents_seen = 0
        bus.subscribe(None, self.on_event)

    @classmethod
    def install(cls, engine, out_dir: str, **kw) -> "FlightRecorder":
        return cls(engine.bus, out_dir, **kw)

    def on_event(self, e: Event) -> None:
        ring = self.ring
        if ring.maxlen is not None and len(ring) == ring.maxlen:
            self.ring_dropped += 1
        ring.append(e)
        if e.kind == ev.INCIDENT:
            self.incidents_seen += 1
            if len(self.bundles) < self.max_bundles:
                self._dump(e)

    # -- bundle assembly ---------------------------------------------------
    def _dump(self, incident: Event) -> None:
        kind = incident.data.get("kind", "unknown")
        name = f"incident-{len(self.bundles):03d}-{kind}"
        path = os.path.join(self.out_dir, name)
        os.makedirs(path, exist_ok=True)
        events = list(self.ring)
        dropped = self.bus.dropped + self.ring_dropped
        write_events_jsonl(events, os.path.join(path, "events.jsonl"),
                           dropped=dropped)
        with open(os.path.join(path, "incident.json"), "w") as f:
            json.dump(self._attribution(incident, events, dropped), f,
                      indent=1, default=str)
        self.bundles.append(path)

    def _attribution(self, incident: Event, events: List[Event],
                     dropped: int) -> dict:
        """Critical-path context for the implicated session: replay the
        ring through a fresh tracer (partial timelines allowed — the
        session is usually still stuck at dump time)."""
        tr = Tracer.replay(events)
        sid = incident.sid
        cp: Optional[dict] = None
        if sid >= 0:
            cp = tr.critical_path(sid, allow_unfinished=True)
        return {
            "incident": {"kind": incident.data.get("kind"), "t": incident.t,
                         "sid": sid,
                         "evidence": incident.data.get("evidence", {})},
            "critical_path": cp,
            "aggregate": tr.aggregate(),
            "ring": {"events": len(events), "dropped": dropped},
        }
