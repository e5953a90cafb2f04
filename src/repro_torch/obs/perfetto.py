"""Chrome-trace / Perfetto JSON export of assembled traces.

Emits the legacy Chrome trace-event JSON (``{"traceEvents": [...]}``) that
``ui.perfetto.dev`` (and ``chrome://tracing``) open directly:

* one **process track per replica** (pid = replica index, named after the
  replica id; a single-engine run exports one process),
* **per-plane threads** in each process — ``gpu`` carries the engine tick
  slices (non-overlapping: the tick loop is serial) and ``io`` /
  ``control`` carry instant markers — plus per-process **counter tracks**
  (free KV blocks, active tools, waiting queue, host/disk tier occupancy)
  sampled from the engine's ``tick`` events,
* one **thread per traced session** whose slices are the session's
  *exclusive* critical-path segments (contiguous by construction, so they
  nest trivially); each slice carries ``args: {sid, plane, kind}`` — this
  is the schema ``scripts/trace_report.py`` recomputes the latency
  breakdown from, which is what makes the exporter CI-checkable,
* overlay spans that genuinely overlap the timeline (pinned windows,
  demote/promote staged I/O, async swap-out drains) as async ``b``/``e``
  pairs keyed by sid.

Timestamps are event-stream seconds scaled to microseconds (sim runs use
the modeled clock; live runs the engine's wall clock).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

from repro_torch.obs.trace import Tracer

_US = 1e6
# fixed per-plane thread ids inside each replica process; session detail
# threads start above _SESSION_TID_BASE
_PLANE_TIDS = {"gpu": 1, "cpu": 2, "io": 3, "control": 4}
_PLANE_THREAD_NAMES = {"gpu": "gpu (engine ticks)", "cpu": "cpu-tools",
                       "io": "io (swap/tier)", "control": "control-plane"}
_SESSION_TID_BASE = 100

_COUNTER_FIELDS = (("free_blocks", "kv free blocks"),
                   ("active_tools", "active tools"),
                   ("waiting", "admission queue"),
                   # shared host-core pool pressure (tools + swap + spool)
                   ("cpu_busy", "cpu pool busy cores"),
                   ("cpu_backlog", "cpu pool backlog"),
                   ("host_used", "host tier blocks"),
                   ("disk_used", "disk tier blocks"),
                   # live-backend prefill HBM traffic (cumulative): what
                   # the legacy gather path would have touched vs what the
                   # gather-free (block-table steered) path touches
                   ("prefill_gather_bytes", "prefill gather bytes"),
                   ("prefill_inplace_bytes", "prefill in-place bytes"))


def _segment_counts(tr) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for sid in tr.finished_sids():
        st = tr.sessions.get(sid)
        if st is not None:
            out[str(sid)] = len(st.segments)
    return out


def export_perfetto(tracers: Union[Tracer, Dict[str, Tracer]],
                    path: Optional[str] = None, *,
                    max_session_tracks: int = 1000) -> dict:
    """Build (and optionally write) the trace JSON.

    ``tracers`` is one tracer, or ``{replica_id: tracer}`` for a cluster
    run. Returns the trace dict; writes it to ``path`` when given.
    """
    if isinstance(tracers, Tracer):
        tracers = {"engine": tracers}
    events: List[dict] = []
    dropped_sessions = 0
    for pid, (rid, tr) in enumerate(sorted(tracers.items())):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": rid}})
        for plane, tid in _PLANE_TIDS.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": _PLANE_THREAD_NAMES[plane]}})
        # engine tick slices + counter tracks (present when the source
        # engine ran with trace_ticks on; replayed JSONL keeps them too)
        for te in tr.ticks:
            d = te.data
            ts = te.t * _US
            dur = max(0.0, d.get("elapsed", 0.0)) * _US
            if dur > 0:
                events.append({
                    "ph": "X", "pid": pid, "tid": _PLANE_TIDS["gpu"],
                    "name": "tick", "ts": ts, "dur": dur,
                    "args": {"wall_s": d.get("wall_s", 0.0),
                             "phases": d.get("phases", {}),
                             "decodes": d.get("n_decodes", 0),
                             "prefills": d.get("n_prefills", 0),
                             "swapins": d.get("n_swapins", 0),
                             # iteration composition (mixed scheduler):
                             # token split of this dispatch
                             "mixed": d.get("mixed", False),
                             "decode_tokens": d.get("decode_tokens", 0),
                             "prefill_tokens": d.get("prefill_tokens", 0)}})
            for field, label in _COUNTER_FIELDS:
                if field in d:
                    events.append({"ph": "C", "pid": pid, "name": label,
                                   "ts": ts,
                                   "args": {"value": d.get(field, 0)}})
        # per-session detail threads: exclusive segments as complete slices
        sids = tr.finished_sids()
        if len(sids) > max_session_tracks:
            dropped_sessions += len(sids) - max_session_tracks
            sids = sids[:max_session_tracks]
        for k, sid in enumerate(sids):
            st = tr.sessions.get(sid)
            if st is None:
                continue
            tid = _SESSION_TID_BASE + k
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": f"sid {sid}"}})
            for seg in st.segments:
                events.append({
                    "ph": "X", "pid": pid, "tid": tid, "name": seg.kind,
                    "ts": seg.start * _US,
                    "dur": max(0.0, seg.dur) * _US,
                    "args": {"sid": sid, "plane": seg.plane,
                             "kind": seg.kind, "round": seg.round}})
            seg_ids = {id(seg) for seg in st.segments}
            for sp in st.spans:
                if id(sp) in seg_ids:
                    continue
                if sp.dur > 0:        # overlapping overlay: async pair
                    base = {"cat": sp.plane, "id": sid, "pid": pid,
                            "tid": _PLANE_TIDS[sp.plane],
                            "name": f"{sp.kind} sid={sid}"}
                    events.append({**base, "ph": "b", "ts": sp.start * _US,
                                   "args": {"sid": sid, "kind": sp.kind}})
                    events.append({**base, "ph": "e", "ts": sp.end * _US})
                else:                 # instant marker on the plane thread
                    events.append({
                        "ph": "i", "pid": pid,
                        "tid": _PLANE_TIDS[sp.plane], "name": sp.kind,
                        "ts": sp.start * _US, "s": "t",
                        "args": {"sid": sid, **{k2: v for k2, v in
                                                sp.data.items()
                                                if isinstance(v, (int, float,
                                                                  str, bool))
                                                }}})
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro.obs.perfetto",
            "replicas": sorted(tracers),
            "sessions": {rid: t.finished_count
                         for rid, t in tracers.items()},
            "dropped_session_tracks": dropped_sessions,
            # upstream event loss: nonzero means the source rings evicted
            # events before assembly and every timeline here is suspect
            # (trace_report --strict fails on it)
            "dropped_events": sum(
                t.bus.dropped for t in tracers.values()
                if getattr(t, "bus", None) is not None),
        },
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
