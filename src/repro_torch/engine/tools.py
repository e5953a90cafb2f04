"""Host-side tool execution (the CPU plane).

Both executors implement the ``ToolExecutor`` protocol the engine types
against, and both draw their capacity from a shared ``CpuPool`` (the same
pool the swap/spool staging paths lease from) instead of a private slot
count — tool bursts and KV transfers now contend for the same cores.

``SimToolExecutor`` models co-located tool execution under the virtual
clock: invocations become pool leases, so queueing beyond capacity and
interference-stretched service times come from the pool's documented
model (this backlog is exactly the coupled-pressure signal MARS
consumes). ``RealToolExecutor`` runs actual callables on a thread pool
sized from the pool's cores for the live engine/examples, using the
pool's wall-clock accounting API. Both emit the same unified-info-stream
events; ``TOOL_START`` carries ``queue_wait`` (seconds the invocation
waited for a core) for the tracer's ``cpu_queue_wait`` attribution.

Constructors accept either a core count (builds a private pool —
back-compat) or a ``CpuPool`` to share.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, List, Optional, Protocol, Union,
                    runtime_checkable)

from repro_torch.core import events as ev
from repro_torch.core.cpu_pool import CpuLease, CpuPool, CpuPoolConfig
from repro_torch.core.events import EventBus
from repro_torch.core.session import Session


def _resolve_pool(cpu_slots: Union[int, CpuPool]) -> CpuPool:
    if isinstance(cpu_slots, CpuPool):
        return cpu_slots
    return CpuPool(CpuPoolConfig(cores=int(cpu_slots)))


@runtime_checkable
class ToolExecutor(Protocol):
    """What the engine needs from a tool executor. ``pool`` is the shared
    CPU pool its invocations lease from; ``poll`` returns sessions whose
    tools completed by ``now``; ``cancel`` forgets a session's queued or
    running tool (releasing its pool lease); ``next_event_time`` is the
    earliest completion under the current schedule, queueing delay
    included (None on the wall-clock path)."""

    pool: CpuPool

    def start(self, s: Session, kind: str, duration: float,
              now: float) -> None: ...
    def poll(self, now: float) -> List[Session]: ...
    def cancel(self, sid: int, now: float) -> None: ...
    def next_event_time(self) -> Optional[float]: ...
    @property
    def active(self) -> int: ...
    @property
    def backlog(self) -> int: ...
    def shutdown(self) -> None: ...


class SimToolExecutor:
    def __init__(self, cpu_slots: Union[int, CpuPool], bus: EventBus):
        self.pool = _resolve_pool(cpu_slots)
        self.bus = bus
        self._leases: Dict[int, CpuLease] = {}    # sid -> in-flight lease
        self._sessions: Dict[int, Session] = {}
        self.faults = None     # engine.faults.FaultPlan.install wires this

    @property
    def cpu_slots(self) -> int:
        return self.pool.cores

    def start(self, s: Session, kind: str, duration: float, now: float) -> None:
        # expected_s is the *nominal* duration, stamped before any fault
        # stretch: the obs detectors judge the measured runtime against the
        # promise the engine was given
        self.bus.emit(ev.TOOL_ENQUEUE, now, s.sid, kind=kind,
                      expected_s=duration)
        if self.faults is not None:
            duration = self.faults.tool_duration(s.sid, kind, duration, now)
        lease = self.pool.submit(now, duration, sid=s.sid, kind="tool",
                                 tag=kind, priority=1)
        self._leases[s.sid] = lease
        self._sessions[s.sid] = s

    def poll(self, now: float) -> List[Session]:
        """Tools completed by ``now``. Advancing the shared pool reports
        lease starts (queued tools begin as cores free up — possibly
        between polls, at their exact scheduled times) and completions;
        transfer leases riding the same pool are advanced too, but only
        tool leases this executor issued produce events here."""
        started, completed = self.pool.advance(now)
        for lease in started:
            s = self._sessions.get(lease.sid)
            if lease.kind != "tool" or s is None \
                    or self._leases.get(lease.sid) is not lease:
                continue
            s.tool_started = lease.start
            s.meta["tool_kind_running"] = lease.tag
            s.meta["tool_duration"] = lease.end - lease.start
            self.bus.emit(ev.TOOL_START, lease.start, s.sid, kind=lease.tag,
                          queue_wait=lease.queue_wait)
        done: List[Session] = []
        for lease in completed:
            s = self._sessions.get(lease.sid)
            if lease.kind != "tool" or s is None \
                    or self._leases.get(lease.sid) is not lease:
                continue
            del self._leases[lease.sid]
            del self._sessions[lease.sid]
            self.bus.emit(ev.TOOL_END, lease.end, s.sid, kind=lease.tag,
                          duration=lease.end - lease.start)
            done.append(s)
        return done

    def cancel(self, sid: int, now: float) -> None:
        """Forget a session's queued/running tool (router detach): its
        completion must not resume a session another replica now owns.
        The pool lease is released — a queued lease gives back its slot
        (later waiting work backfills earlier), a running one frees its
        core at ``now``."""
        lease = self._leases.pop(sid, None)
        self._sessions.pop(sid, None)
        if lease is not None:
            self.pool.cancel(lease, now)

    def next_event_time(self) -> Optional[float]:
        """Earliest tool completion under the current pool schedule —
        queued invocations are eagerly placed, so this accounts for
        queueing delay behind both tools and transfer staging."""
        ends = [l.end for l in self._leases.values() if not l.reported_end]
        return min(ends) if ends else None

    @property
    def active(self) -> int:
        return sum(1 for l in self._leases.values() if l.reported_start)

    @property
    def backlog(self) -> int:
        return len(self._leases) - self.active

    def shutdown(self) -> None:
        pass


class RealToolExecutor:
    """Thread-pool executor for live tool callables (wall clock).

    ``Round.tool_seconds`` is honoured via sleep when no callable is given
    in ``session.meta['tool_fns'][round]`` — used by the live-engine
    examples. Worker capacity comes from the shared pool's core count;
    occupancy and queue waits feed the pool's wall-clock accounting."""

    def __init__(self, cpu_slots: Union[int, CpuPool], bus: EventBus):
        self.pool = _resolve_pool(cpu_slots)
        self.bus = bus
        self._exec = ThreadPoolExecutor(max_workers=self.pool.cores)
        self._done: "queue.Queue[Session]" = queue.Queue()
        self._active = 0
        self._cancelled: Dict[int, int] = {}   # sid -> completions to drop
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    @property
    def cpu_slots(self) -> int:
        return self.pool.cores

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def start(self, s: Session, kind: str, duration: float, now: float) -> None:
        self.bus.emit(ev.TOOL_ENQUEUE, now, s.sid, kind=kind,
                      expected_s=duration)
        self.pool.pending_inc()
        t_enq = self._now()
        fn: Optional[Callable] = None
        fns = s.meta.get("tool_fns")
        if fns:
            fn = fns.get(s.cur_round)

        def _run():
            t_start = self._now()
            with self._lock:
                self._active += 1
                self.pool.pending_dec()
                tok = self.pool.acquire(t_start, "tool")
                self.pool.note_wait("tool", t_start - t_enq)
            s.tool_started = t_start
            self.bus.emit(ev.TOOL_START, t_start, s.sid, kind=kind,
                          queue_wait=t_start - t_enq)
            try:
                if fn is not None:
                    fn()
                else:
                    time.sleep(duration)
            finally:
                t_end = self._now()
                with self._lock:
                    self._active -= 1
                    self.pool.release(t_end, tok)
                self.bus.emit(ev.TOOL_END, t_end, s.sid, kind=kind,
                              duration=t_end - t_start)
                self._done.put(s)

        self._exec.submit(_run)

    def cancel(self, sid: int, now: float) -> None:
        """Suppress the session's pending tool completion (router detach).
        The worker thread itself cannot be interrupted, so the next result
        for this sid is dropped instead of resuming the session."""
        with self._lock:
            self._cancelled[sid] = self._cancelled.get(sid, 0) + 1

    def poll(self, now: float) -> List[Session]:
        out = []
        while True:
            try:
                s = self._done.get_nowait()
            except queue.Empty:
                return out
            with self._lock:
                pending = self._cancelled.get(s.sid, 0)
                if pending:
                    if pending == 1:
                        del self._cancelled[s.sid]
                    else:
                        self._cancelled[s.sid] = pending - 1
                    continue
            out.append(s)

    def next_event_time(self) -> Optional[float]:
        return None

    @property
    def active(self) -> int:
        return self._active

    @property
    def backlog(self) -> int:
        return self.pool.backlog(self._now())

    def shutdown(self) -> None:
        self._exec.shutdown(wait=False)
