"""Critical-path tracer over the unified event stream.

Subscribes to every :mod:`repro.core.events` kind and assembles, per
session, two views of the same lifetime:

* a **span tree** — possibly-overlapping intervals grouped by round:
  admission wait, scheduler-queue wait, prefill chunks, decode rounds, tool
  enqueue/exec, swap-out/in, pinned windows, tiered demote/promote staged
  restores. Overlap is real (a pin revoked to NVMe *during* a tool yields a
  demote span under the tool-exec span) and preserved.

* an **exclusive segment timeline** — a single cursor walks each session
  from ``submit`` to ``finish``; every event closes the open wait interval
  and/or appends an execution interval, so segments partition the session's
  end-to-end latency exactly. ``critical_path(sid)`` folds the timeline
  into per-plane buckets and names the dominant segment.

Span kinds map onto the paper's §4.1 event taxonomy (Table 1):

    GPU plane      prefill / decode        <- gpu_submit..gpu_end envelope,
                                              prefill_chunk / decode_step
    CPU plane      tool_queue / tool_exec  <- tool_enqueue / tool_start /
                                              tool_end
    I/O plane      swap_in / restore_wait  <- swap_out / swap_in / demote /
                   (+ demote/promote spans)   promote / swap_abandon
    control plane  admit_wait / sched_wait <- submit / admit / gpu_submit /
                                              preempt / evict / finish

The tracer is an ordinary subscriber: attach it before submitting sessions
(``Tracer.install(engine)`` also flips ``engine.trace_ticks`` so the engine
emits per-tick phase timings and retention audit records). Each ``TICK``
event additionally carries the iteration's batch composition — ``mixed``
(scheduler mode), ``decode_tokens``, ``prefill_tokens`` — which the
Perfetto exporter surfaces as tick-slice args; under the default mixed
scheduler one tick is one model iteration (every decode lane exactly one
token), so tick density is much higher than under ``scheduler="round"``.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional

from repro_torch.core import events as ev
from repro_torch.core.events import Event, EventBus

# segment/span kind -> latency plane
PLANE_OF = {
    "prefill": "gpu",
    "decode": "gpu",
    "tool_queue": "cpu",
    "tool_exec": "cpu",
    "cpu_queue_wait": "cpu",
    "swap_in": "io",
    "restore_wait": "io",
    "demote": "io",
    "promote": "io",
    "swap_out": "io",
    "admit_wait": "control",
    "sched_wait": "control",
    "pinned": "control",
}
PLANES = ("gpu", "cpu", "io", "control")


class Span:
    """One interval (or instant, start == end) in a session's lifetime."""

    __slots__ = ("kind", "plane", "start", "end", "sid", "round", "data")

    def __init__(self, kind: str, start: float, end: float, sid: int,
                 round_: int = 0, data: Optional[dict] = None):
        self.kind = kind
        self.plane = PLANE_OF.get(kind, "control")
        self.start = start
        self.end = end
        self.sid = sid
        self.round = round_
        self.data = data or {}

    @property
    def dur(self) -> float:
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.kind} sid={self.sid} r{self.round} "
                f"[{self.start:.3f},{self.end:.3f}])")


class SessionTrace:
    """Per-session assembly state + finished artifacts."""

    __slots__ = ("sid", "submitted", "admitted", "finished", "rejected",
                 "spans", "segments", "cursor", "wait", "round",
                 "swapped", "pin_start", "tool_start")

    def __init__(self, sid: int, submitted: float):
        self.sid = sid
        self.submitted = submitted
        self.admitted: Optional[float] = None
        self.finished: Optional[float] = None
        self.rejected = False
        self.spans: List[Span] = []
        self.segments: List[Span] = []   # exclusive, contiguous
        self.cursor = submitted          # time attributed so far
        self.wait = "admit_wait"         # open wait interval's kind
        self.round = 0
        self.swapped = False             # KV parked off-device right now
        self.pin_start: Optional[float] = None
        self.tool_start: Optional[float] = None

    # -- exclusive timeline ------------------------------------------------
    def close_wait(self, t: float, kind: Optional[str] = None) -> None:
        """Close the open wait interval [cursor, t] as ``kind`` (default:
        the current wait label) and advance the cursor."""
        t = max(t, self.cursor)
        k = kind or self.wait
        if t > self.cursor:
            seg = Span(k, self.cursor, t, self.sid, self.round)
            self.segments.append(seg)
            self.spans.append(seg)
        self.cursor = t

    def exec_segment(self, kind: str, start: float, end: float,
                     data: Optional[dict] = None) -> None:
        """Close the wait up to ``start``, then append an execution
        segment [start, end]."""
        self.close_wait(start)
        start = max(start, self.cursor)
        end = max(end, start)
        seg = Span(kind, start, end, self.sid, self.round, data)
        self.segments.append(seg)
        self.spans.append(seg)
        self.cursor = end

    def marker(self, kind: str, t: float, dur: float = 0.0,
               data: Optional[dict] = None) -> Span:
        """Overlay span (not part of the exclusive timeline)."""
        sp = Span(kind, t, t + dur, self.sid, self.round, data)
        self.spans.append(sp)
        return sp


class Tracer:
    """Event-stream subscriber assembling span trees + critical paths.

    ``metrics`` (a :class:`repro.obs.metrics.MetricsRegistry`) is optional:
    when given, the tracer feeds latency histograms (``trace.e2e_s``,
    ``trace.ttft_s``, ``trace.tool_s``, ``trace.tick_wall_s``) as events
    arrive. ``max_sessions`` bounds retained finished traces (ring; the
    aggregate bucket totals keep counting dropped ones).
    """

    def __init__(self, bus: Optional[EventBus] = None, *, metrics=None,
                 max_sessions: int = 100_000, max_ticks: int = 200_000):
        self.metrics = metrics
        self.sessions: Dict[int, SessionTrace] = {}
        self.finished_order: Deque[int] = deque()
        self.max_sessions = max_sessions
        self.ticks: Deque[Event] = deque(maxlen=max_ticks)
        self.events_seen = 0
        # aggregate per-plane bucket totals over *all* finished sessions
        # (survives the per-session ring)
        self.bucket_totals = dict.fromkeys(PLANES, 0.0)
        self.e2e_total = 0.0
        self.finished_count = 0
        self._dispatch = {
            ev.SUBMIT: self._on_submit,
            ev.REJECT: self._on_reject,
            ev.GPU_SUBMIT: self._on_gpu_submit,
            ev.PREFILL_CHUNK: self._on_prefill_chunk,
            ev.DECODE_STEP: self._on_decode_step,
            ev.GPU_FIRST_TOKEN: self._on_first_token,
            ev.GPU_END: self._on_gpu_end,
            ev.TOOL_ENQUEUE: self._on_tool_enqueue,
            ev.TOOL_START: self._on_tool_start,
            ev.TOOL_END: self._on_tool_end,
            ev.SWAP_OUT: self._on_swap_out,
            ev.SWAP_IN: self._on_swap_in,
            ev.SWAP_ABANDON: self._on_swap_abandon,
            ev.PIN: self._on_pin,
            ev.UNPIN: self._on_unpin,
            ev.PREEMPT: self._on_marker,
            ev.EVICT: self._on_evict,
            ev.DEMOTE: self._on_demote,
            ev.PROMOTE: self._on_promote,
            ev.PREFIX_HIT: self._on_marker,
            ev.RETENTION: self._on_marker,
            ev.INCIDENT: self._on_marker,
            ev.FINISH: self._on_finish,
            ev.TICK: self._on_tick,
        }
        self.bus = bus
        if bus is not None:
            bus.subscribe(None, self.on_event)

    # -- attachment --------------------------------------------------------
    @classmethod
    def install(cls, engine, *, metrics=None, **kw) -> "Tracer":
        """Attach to an engine's bus and enable its tick/audit emission."""
        tr = cls(engine.bus, metrics=metrics, **kw)
        engine.trace_ticks = True
        return tr

    @classmethod
    def replay(cls, events, **kw) -> "Tracer":
        """Rebuild a tracer from a recorded event sequence (e.g. the JSONL
        dump ``scripts/trace_report.py`` consumes)."""
        tr = cls(None, **kw)
        for e in events:
            tr.on_event(e)
        return tr

    # -- event pump --------------------------------------------------------
    def on_event(self, e: Event) -> None:
        self.events_seen += 1
        fn = self._dispatch.get(e.kind)
        if fn is not None:
            fn(e)

    def _trace(self, e: Event) -> Optional[SessionTrace]:
        return self.sessions.get(e.sid)

    # -- handlers ----------------------------------------------------------
    def _on_submit(self, e: Event) -> None:
        # a re-placed session (cluster failover) re-submits: keep the
        # original trace — its clock started at first arrival
        if e.sid not in self.sessions:
            self.sessions[e.sid] = SessionTrace(e.sid, e.t)

    def _on_reject(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is not None:
            tr.rejected = True

    def _on_gpu_submit(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        tr.close_wait(e.t)
        tr.round = e.data.get("round", tr.round)
        if tr.admitted is None:
            tr.admitted = e.t
        # admitted / resumed: from here the open wait is scheduler-queue
        # time — unless an off-device restore gates it (I/O plane)
        tr.wait = "restore_wait" if tr.swapped else "sched_wait"

    def _on_prefill_chunk(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        tr.exec_segment("prefill", e.data.get("start", e.t), e.t,
                        {"tokens": e.data.get("tokens", 0)})
        tr.wait = "sched_wait"

    def _on_decode_step(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        tr.exec_segment("decode", e.data.get("start", e.t), e.t,
                        {"tokens": e.data.get("tokens", 0)})
        tr.wait = "sched_wait"

    def _on_first_token(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is not None:
            tr.marker("first_token", e.t, data=dict(e.data))
        if self.metrics is not None:
            self.metrics.histogram("trace.ttft_s").observe(
                e.data.get("ttft", 0.0))

    def _on_gpu_end(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is not None:
            tr.close_wait(e.t)

    def _on_tool_enqueue(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        tr.close_wait(e.t)
        tr.wait = "tool_queue"

    def _on_tool_start(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        # split the pre-start wait: everything before the core-pool wait
        # is ordinary tool-queue time (executor backlog), the trailing
        # ``queue_wait`` seconds are CPU-pool core contention
        qw = e.data.get("queue_wait", 0.0)
        if qw > 0.0:
            tr.close_wait(max(tr.cursor, e.t - qw), "tool_queue")
            tr.close_wait(e.t, "cpu_queue_wait")
        else:
            tr.close_wait(e.t, "tool_queue")
        tr.tool_start = e.t
        tr.wait = "tool_exec"

    def _on_tool_end(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is not None:
            tr.close_wait(e.t, "tool_exec")
            tr.tool_start = None
            # post-tool limbo: gated on the off-device restore when the KV
            # was parked, plain scheduler wait otherwise
            tr.wait = "restore_wait" if tr.swapped else "sched_wait"
        if self.metrics is not None:
            self.metrics.histogram("trace.tool_s").observe(
                e.data.get("duration", 0.0))

    def _on_swap_out(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        tr.swapped = True
        tr.marker("swap_out", e.t, data=dict(e.data))

    def _on_swap_in(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        start = e.data.get("start", e.t)
        # ``cpu_wait_s``: core-pool queueing charged into the restore cost
        # (the H2D staging pump waited for a core before the DMA could
        # run) — carve it out of the swap window as its own CPU segment
        cw = min(e.data.get("cpu_wait_s", 0.0), max(0.0, e.t - start))
        if cw > 0.0:
            tr.close_wait(start)
            tr.close_wait(start + cw, "cpu_queue_wait")
            start = start + cw
        tr.exec_segment("swap_in", start, e.t,
                        {"tokens": e.data.get("tokens", 0),
                         "tier": e.data.get("tier", "host")})
        tr.swapped = False
        tr.wait = "sched_wait"

    def _on_swap_abandon(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        # the wait so far was restore gating; from here the session is an
        # ordinary (recompute) scheduler client again
        tr.close_wait(e.t)
        tr.swapped = False
        tr.wait = "sched_wait"
        tr.marker("swap_abandon", e.t, data=dict(e.data))

    def _on_pin(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        tr.pin_start = e.t
        tr.marker("pin", e.t, data=dict(e.data))

    def _on_unpin(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        if tr.pin_start is not None:
            tr.marker("pinned", tr.pin_start, e.t - tr.pin_start,
                      dict(e.data))
            tr.pin_start = None

    def _on_evict(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        if tr.pin_start is not None:          # reclaim path drops the pin
            tr.marker("pinned", tr.pin_start, e.t - tr.pin_start)
            tr.pin_start = None
        tr.marker("evict", e.t, data=dict(e.data))

    def _on_demote(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is not None:
            tr.marker("demote", e.t, e.data.get("write_s", 0.0),
                      dict(e.data))

    def _on_promote(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is not None:
            tr.marker("promote", e.t, e.data.get("read_s", 0.0),
                      dict(e.data))

    def _on_marker(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is not None:
            tr.marker(e.kind, e.t, data=dict(e.data))

    def _on_finish(self, e: Event) -> None:
        tr = self._trace(e)
        if tr is None:
            return
        tr.close_wait(e.t)
        tr.finished = e.t
        self.finished_count += 1
        e2e = tr.finished - tr.submitted
        self.e2e_total += e2e
        for seg in tr.segments:
            self.bucket_totals[seg.plane] += seg.dur
        if self.metrics is not None:
            self.metrics.histogram("trace.e2e_s").observe(e2e)
        self.finished_order.append(e.sid)
        while len(self.finished_order) > self.max_sessions:
            self.sessions.pop(self.finished_order.popleft(), None)

    def _on_tick(self, e: Event) -> None:
        self.ticks.append(e)
        if self.metrics is not None:
            self.metrics.histogram(
                "trace.tick_wall_s").observe(e.data.get("wall_s", 0.0))

    # -- queries -----------------------------------------------------------
    def trace(self, sid: int) -> Optional[SessionTrace]:
        return self.sessions.get(sid)

    def span_tree(self, sid: int) -> Optional[dict]:
        """Session -> rounds -> spans. Round r covers its GPU phase *and*
        the tool yielded at its end; overlay spans (demote/promote/
        swap_out) stay under the round they occurred in."""
        tr = self.sessions.get(sid)
        if tr is None:
            return None
        rounds: Dict[int, List[Span]] = {}
        for sp in tr.spans:
            rounds.setdefault(sp.round, []).append(sp)
        return {
            "sid": sid, "submitted": tr.submitted, "admitted": tr.admitted,
            "finished": tr.finished,
            "rounds": [
                {"round": r,
                 "start": min(sp.start for sp in sps),
                 "end": max(sp.end for sp in sps),
                 "spans": sorted(sps, key=lambda sp: (sp.start, sp.end))}
                for r, sps in sorted(rounds.items())],
        }

    def critical_path(self, sid: int, top: int = 5, *,
                      allow_unfinished: bool = False) -> Optional[dict]:
        """Exclusive per-plane latency decomposition of a finished session.

        Buckets partition ``finished - submitted`` exactly (segments are
        contiguous by construction); ``dominant`` is the single longest
        segment, ``dominant_bucket`` the largest plane total.

        ``allow_unfinished`` decomposes an in-flight session up to its
        cursor instead of returning None — the flight recorder attributes
        *stuck* sessions, which by definition have not finished. Such rows
        carry ``"partial": True`` and ``"finished": None``; the open tail
        wait past the cursor is not attributed (it has no closing event).
        """
        tr = self.sessions.get(sid)
        if tr is None or (tr.finished is None and not allow_unfinished):
            return None
        partial = tr.finished is None
        horizon = tr.cursor if partial else tr.finished
        buckets = dict.fromkeys(PLANES, 0.0)
        by_kind: Dict[str, float] = {}
        for seg in tr.segments:
            buckets[seg.plane] += seg.dur
            by_kind[seg.kind] = by_kind.get(seg.kind, 0.0) + seg.dur
        e2e = horizon - tr.submitted
        segs = sorted(tr.segments, key=lambda sp: -sp.dur)
        dom = segs[0] if segs else None
        return {
            "sid": sid, "e2e": e2e, "partial": partial,
            "submitted": tr.submitted, "finished": tr.finished,
            "buckets": buckets,
            "bucket_frac": {k: (v / e2e if e2e > 0 else 0.0)
                            for k, v in buckets.items()},
            "by_kind": by_kind,
            "dominant_bucket": max(buckets, key=buckets.get),
            "dominant": (None if dom is None else
                         {"kind": dom.kind, "plane": dom.plane,
                          "start": dom.start, "end": dom.end,
                          "dur": dom.dur, "round": dom.round}),
            "top_segments": [
                {"kind": sp.kind, "plane": sp.plane, "dur": sp.dur,
                 "start": sp.start, "round": sp.round}
                for sp in segs[:top]],
        }

    def finished_sids(self) -> List[int]:
        return list(self.finished_order)

    def aggregate(self) -> dict:
        """Fleet view over every finished session (including ones the ring
        dropped): per-plane bucket totals and fractions of total e2e."""
        total = self.e2e_total
        return {
            "sessions": self.finished_count,
            "e2e_total": total,
            "buckets": dict(self.bucket_totals),
            "bucket_frac": {k: (v / total if total > 0 else 0.0)
                            for k, v in self.bucket_totals.items()},
        }


# -- raw event (JSONL) round trip -------------------------------------------

def write_events_jsonl(events: Iterable[Event], path: str, *,
                       dropped: int = 0) -> int:
    """Write an event sequence as line-delimited JSON (one object per
    line: kind/t/sid/data) — the raw-trace format ``scripts/
    trace_report.py`` replays. The first line is a ``trace_meta`` header
    carrying the upstream ``dropped`` count, so a dump built from a lossy
    ring announces the loss to every consumer (``trace_report.py
    --strict`` fails on it). Returns the number of *event* lines written
    (the header is excluded)."""
    events = list(events)
    with open(path, "w") as f:
        header = {"kind": ev.TRACE_META, "t": 0.0, "sid": -1,
                  "data": {"dropped": dropped, "events": len(events)}}
        f.write(json.dumps(header) + "\n")
        for e in events:
            f.write(json.dumps({"kind": e.kind, "t": e.t, "sid": e.sid,
                                "data": e.data}, default=str) + "\n")
    return len(events)


def dump_events_jsonl(bus: EventBus, path: str) -> int:
    """Dump a bus's retained log (see :func:`write_events_jsonl`); the
    header's ``dropped`` is the bus ring's eviction count."""
    return write_events_jsonl(bus.log, path, dropped=bus.dropped)


def load_events_jsonl(path: str) -> List[Event]:
    """Parse a JSONL dump back to events. Tolerant of damage: malformed
    or truncated lines (a dump cut off mid-write, a corrupted ring
    bundle) are skipped rather than raised on — ``Tracer.replay`` then
    degrades to partial timelines, which is exactly what a postmortem
    wants from a lossy trace."""
    out: List[Event] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                out.append(Event(d["kind"], float(d["t"]),
                                 int(d.get("sid", -1)), d.get("data") or {}))
            except (ValueError, KeyError, TypeError):
                continue
    return out


def events_from_dicts(rows: Iterable[dict]) -> List[Event]:
    """Adapt already-parsed event dicts (tests, notebooks) to Events."""
    return [Event(d["kind"], float(d["t"]), int(d.get("sid", -1)),
                  d.get("data") or {}) for d in rows]


# -- reporting helpers -------------------------------------------------------

def breakdown_table(rows: List[dict], *, max_rows: int = 20) -> str:
    """Render critical-path rows (``Tracer.critical_path`` results) as the
    per-session latency-breakdown table the examples print at exit."""
    out = [f"{'sid':>6} {'e2e_s':>9} {'gpu_s':>9} {'cpu_s':>9} "
           f"{'io_s':>9} {'ctrl_s':>9}  dominant"]
    shown = rows[:max_rows]
    for r in shown:
        b = r["buckets"]
        dom = r["dominant"]
        dom_s = (f"{dom['kind']} ({dom['dur']:.3f}s r{dom['round']})"
                 if dom else "-")
        out.append(f"{r['sid']:>6} {r['e2e']:>9.3f} {b['gpu']:>9.3f} "
                   f"{b['cpu']:>9.3f} {b['io']:>9.3f} "
                   f"{b['control']:>9.3f}  {dom_s}")
    if len(rows) > len(shown):
        out.append(f"  ... {len(rows) - len(shown)} more sessions")
    if rows:
        tot = {p: sum(r["buckets"][p] for r in rows) for p in PLANES}
        e2e = sum(r["e2e"] for r in rows)
        out.append(f"{'TOTAL':>6} {e2e:>9.3f} {tot['gpu']:>9.3f} "
                   f"{tot['cpu']:>9.3f} {tot['io']:>9.3f} "
                   f"{tot['control']:>9.3f}")
        if e2e > 0:
            out.append(f"{'%':>6} {'':>9} "
                       + " ".join(f"{100 * tot[p] / e2e:>9.1f}"
                                  for p in PLANES))
    return "\n".join(out)
