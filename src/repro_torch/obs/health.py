"""Fleet health rollup over :class:`repro.distributed.router.ClusterRouter`.

One structured answer to "how is the fleet doing right now": per-replica
vitals from the router's heartbeat state, fleet counters from
``router.stats()``, and — when the per-replica observability stack is
wired in — incident counts from each replica's :class:`~repro.obs.detect.
DetectorSuite` and goodput from a fleet :class:`~repro.obs.slo.SloTracker`.

Status ladder (worst replica wins, incidents escalate):

    healthy     every replica alive, nothing draining, no incidents
    degraded    a replica is draining/straggling, or incidents fired but
                every replica is still alive
    critical    a replica is dead, or the requeue backlog is non-empty
                (sessions displaced with nowhere to go)

``examples/cluster_serving.py`` prints ``HealthReport.render()`` at exit;
later PRs feed the same rollup to the fleet router's placement scoring.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ReplicaHealth:
    rid: str
    alive: bool
    draining: bool
    kv_utilization: float
    tool_backlog: int
    active_sessions: int
    step_latency_ema: float
    last_heartbeat: float
    incidents: Dict[str, int] = field(default_factory=dict)

    @property
    def status(self) -> str:
        if not self.alive:
            return "dead"
        if self.draining or self.incidents:
            return "degraded"
        return "ok"


@dataclass
class HealthReport:
    status: str
    fleet: dict
    replicas: List[ReplicaHealth]
    incidents: Dict[str, int]
    slo: Optional[dict] = None

    @classmethod
    def collect(cls, router, *, detectors: Optional[dict] = None,
                slo=None) -> "HealthReport":
        """``detectors`` maps rid -> DetectorSuite (or anything exposing
        ``incidents``); ``slo`` is a fleet-level SloTracker."""
        detectors = detectors or {}
        fleet = router.stats()
        replicas: List[ReplicaHealth] = []
        incident_totals: Dict[str, int] = {}
        for rid, r in sorted(router.replicas.items()):
            counts: Dict[str, int] = {}
            suite = detectors.get(rid)
            if suite is not None:
                for rec in suite.incidents:
                    counts[rec["kind"]] = counts.get(rec["kind"], 0) + 1
                    incident_totals[rec["kind"]] = \
                        incident_totals.get(rec["kind"], 0) + 1
            replicas.append(ReplicaHealth(
                rid=rid, alive=r.alive, draining=r.draining,
                kv_utilization=r.kv_utilization,
                tool_backlog=r.tool_backlog,
                active_sessions=r.active_sessions,
                step_latency_ema=r.step_latency_ema,
                last_heartbeat=r.last_heartbeat, incidents=counts))
        dead = sum(1 for r in replicas if not r.alive)
        if dead or fleet.get("requeue_depth", 0):
            status = "critical"
        elif any(r.status == "degraded" for r in replicas) or incident_totals:
            status = "degraded"
        else:
            status = "healthy"
        return cls(status=status, fleet=fleet, replicas=replicas,
                   incidents=incident_totals,
                   slo=slo.report() if slo is not None else None)

    def to_dict(self) -> dict:
        return {
            "status": self.status,
            "fleet": self.fleet,
            "incidents": self.incidents,
            "replicas": [{
                "rid": r.rid, "status": r.status, "alive": r.alive,
                "draining": r.draining,
                "kv_utilization": round(r.kv_utilization, 4),
                "tool_backlog": r.tool_backlog,
                "active_sessions": r.active_sessions,
                "step_latency_ema": round(r.step_latency_ema, 6),
                "incidents": r.incidents,
            } for r in self.replicas],
            "slo": self.slo,
        }

    def render(self) -> str:
        out = [f"fleet health: {self.status.upper()}  "
               f"(replicas={self.fleet.get('replicas', 0)} "
               f"alive={self.fleet.get('alive', 0)} "
               f"draining={self.fleet.get('draining', 0)} "
               f"requeue={self.fleet.get('requeue_depth', 0)})"]
        out.append(f"{'rid':>10} {'status':>9} {'kv_util':>8} "
                   f"{'tools':>6} {'sess':>5} {'step_ema':>9}  incidents")
        for r in self.replicas:
            inc = ",".join(f"{k}x{n}" for k, n in sorted(r.incidents.items())) \
                or "-"
            out.append(f"{r.rid:>10} {r.status:>9} "
                       f"{r.kv_utilization:>8.3f} {r.tool_backlog:>6} "
                       f"{r.active_sessions:>5} {r.step_latency_ema:>9.4f}  "
                       f"{inc}")
        if self.incidents:
            tot = ", ".join(f"{k}: {n}"
                            for k, n in sorted(self.incidents.items()))
            out.append(f"incidents: {tot}")
        if self.slo:
            for name, c in sorted(self.slo.get("classes", {}).items()):
                out.append(
                    f"slo[{name}]: goodput {c['goodput_frac']:.2%} "
                    f"({c['good']}/{c['finished']} finished), "
                    f"violated sessions {c['violated_sessions']}")
        return "\n".join(out)
