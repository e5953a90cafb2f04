"""Shared host-CPU core pool: the contended resource under tools, swap
staging, and NVMe spool I/O.

MARS's thesis is *coupled* GPU-CPU pressure, but a per-item latency model
(every tool completes after its nominal duration, transfers consume zero
CPU) cannot express the coupling: a tool burst must visibly delay swap
drains and staged NVMe restores, and vice versa. ``CpuPool`` is the single
bounded pool every CPU consumer leases from:

* ``SimToolExecutor`` / ``RealToolExecutor`` tool invocations,
* the swap path's D2H/H2D staging copies (``TieredStore`` / ``SwapStream``),
* ``DiskTier`` spool writes and fill reads.

Queueing model (modeled / sim path)
-----------------------------------
``cores`` identical, non-preemptive cores. Work beyond capacity queues
FIFO **per priority class**: class 0 (transfer staging — small, latency-
critical, on the KV restore path) is placed before any waiting class-1
work (tools), but never preempts a running lease. Placement is *eager*:
``submit`` assigns each lease a deterministic ``(start, end)`` against the
earliest-free core immediately, so tier code can compute delayed ready
times synchronously (the same pattern as ``DiskTier``'s queue slots) and
the sim driver can jump the clock to the exact next completion. A later
priority-0 submit or a ``cancel`` re-places only not-yet-started leases
(LIFO-undo of their placements, then FIFO re-placement per class), so
announced starts never move.

Interference model
------------------
Co-running work contends for shared caches/memory bandwidth: a lease that
starts while ``b`` of the *other* ``cores`` are busy runs stretched by

    stretch = 1 + interference * b / cores        (fixed at start)

i.e. up to ``1 + interference`` when every other core is occupied. The
factor is fixed at lease start (not re-evaluated as neighbours come and
go) — a documented first-order approximation that keeps the sim schedule
deterministic and eager.

Memory is tracked, not enforced: leases may declare ``mem_gb`` and the
pool reports peak usage, but cores are the binding resource of the model
(matching the CPU-centric agentic-execution study this reproduces, where
core oversubscription — not RSS — drives the collapse).

Live (wall-clock) path
----------------------
Real executors size their thread pools from ``cores`` and use the
accounting API (``acquire``/``release``/``note_wait``) so occupancy and
queue-wait gauges stay live without a modeled schedule.

``queue_wait_estimate`` is the admission/retention pressure signal: the
projected delay before ``cost_s`` of new work could start, optionally
with ``extra_backlog_s`` of work hypothetically admitted ahead of it
(spread across cores — an M/G/c-style backlog/c approximation).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class CpuPoolConfig:
    cores: int = 16
    # service-time stretch slope under full co-occupancy (see module doc)
    interference: float = 0.25
    # CPU seconds consumed per second of transfer for staging copies
    # (D2H/H2D bounce buffers, spool write/read pumps)
    transfer_cpu_frac: float = 0.15
    mem_gb: float = 0.0                # 0 => untracked


@dataclass
class CpuLease:
    """One unit of placed CPU work. ``start``/``end`` are modeled seconds;
    ``queue_wait = start - requested_at`` is the time spent waiting for a
    core. Immutable once its start has been reported by ``advance``."""
    seq: int
    sid: int
    kind: str                           # "tool" | "swap" | "spool"
    tag: str                            # consumer detail (e.g. tool kind)
    priority: int                       # 0 = transfers, 1 = tools
    cost_s: float                       # nominal (unstretched) service time
    requested_at: float
    mem_gb: float = 0.0
    start: float = 0.0
    end: float = 0.0
    stretch: float = 1.0
    popped_slot: float = 0.0            # free-time value this lease consumed
    reported_start: bool = False
    reported_end: bool = False
    cancelled: bool = False

    @property
    def queue_wait(self) -> float:
        return max(0.0, self.start - self.requested_at)


class CpuPool:
    def __init__(self, cfg: Optional[CpuPoolConfig] = None):
        self.cfg = cfg or CpuPoolConfig()
        self.cores = max(1, int(self.cfg.cores))
        # sorted multiset of per-core free times under the current schedule
        self._slots: List[float] = [0.0] * self.cores
        self._active: List[CpuLease] = []
        self._seq = 0
        self._t = 0.0                   # high-water advance() time
        # live accounting (wall-clock executors)
        self._live_busy = 0
        self._live_pending = 0
        self._live_mem_gb = 0.0
        # stats
        self.n_leases: Dict[str, int] = {}
        self.busy_s: Dict[str, float] = {}
        self.queue_wait_s: Dict[str, float] = {}
        self.max_backlog = 0
        self.max_stretch = 1.0
        self.peak_mem_gb = 0.0
        self._live_tokens: Dict[int, Tuple[float, str, float]] = {}
        self._live_tok_seq = 0

    # --- modeled scheduling (sim path) ---------------------------------
    def submit(self, now: float, cost_s: float, *, sid: int = -1,
               kind: str = "tool", tag: str = "", priority: int = 1,
               mem_gb: float = 0.0) -> CpuLease:
        """Place ``cost_s`` of CPU work; returns the lease with its
        deterministic (start, end) already assigned. Priority 0 is placed
        ahead of any not-yet-started priority-1 work (FIFO within class)."""
        self._seq += 1
        lease = CpuLease(seq=self._seq, sid=sid, kind=kind, tag=tag,
                         priority=int(priority), cost_s=max(0.0, cost_s),
                         requested_at=now, mem_gb=mem_gb)
        waiting = self._unstarted(now)
        self._active.append(lease)
        if lease.priority == 0 and any(w.priority > 0 for w in waiting):
            # class-0 work goes ahead of every waiting class-1 lease:
            # undo the waiting placements and re-place with the new lease
            # slotted into its class position
            self._undo(waiting)
            for l in sorted(waiting + [lease],
                            key=lambda l: (l.priority, l.seq)):
                self._place(l, now)
        else:
            self._place(lease, now)
        self.n_leases[kind] = self.n_leases.get(kind, 0) + 1
        backlog = sum(1 for l in self._active if l.start > now)
        self.max_backlog = max(self.max_backlog, backlog)
        if self.cfg.mem_gb:
            in_use = sum(l.mem_gb for l in self._active
                         if l.start <= now < l.end) + self._live_mem_gb
            self.peak_mem_gb = max(self.peak_mem_gb, in_use)
        return lease

    def _place(self, lease: CpuLease, not_before: float) -> None:
        v = self._slots.pop(0)
        lease.popped_slot = v
        lease.start = max(not_before, lease.requested_at, v)
        busy_others = sum(1 for t in self._slots if t > lease.start)
        lease.stretch = 1.0 + self.cfg.interference * busy_others / self.cores
        lease.end = lease.start + lease.cost_s * lease.stretch
        bisect.insort(self._slots, lease.end)
        self.max_stretch = max(self.max_stretch, lease.stretch)

    def _unstarted(self, now: float) -> List[CpuLease]:
        """Leases whose placement may still move: scheduled start in the
        future and start not yet announced via ``advance``."""
        return [l for l in self._active
                if not l.reported_start and l.start > max(now, self._t)]

    def _undo(self, leases: List[CpuLease]) -> None:
        """Withdraw placements, LIFO — exact, because a later placement can
        only have consumed an earlier one's end slot, so undoing newest-
        first always finds each lease's end still in the multiset."""
        for l in sorted(leases, key=lambda l: -l.seq):
            i = bisect.bisect_left(self._slots, l.end)
            if i < len(self._slots) and self._slots[i] == l.end:
                self._slots.pop(i)
                bisect.insort(self._slots, l.popped_slot)

    def advance(self, now: float) -> Tuple[List[CpuLease], List[CpuLease]]:
        """Report (started, completed) leases with start/end <= ``now``,
        each exactly once, in time order. Completed leases leave the active
        set; their core free times persist in the schedule."""
        started = [l for l in self._active
                   if not l.reported_start and l.start <= now]
        started.sort(key=lambda l: (l.start, l.seq))
        for l in started:
            l.reported_start = True
            self.queue_wait_s[l.kind] = (self.queue_wait_s.get(l.kind, 0.0)
                                         + l.queue_wait)
        completed = [l for l in self._active
                     if not l.reported_end and l.end <= now]
        completed.sort(key=lambda l: (l.end, l.seq))
        for l in completed:
            l.reported_end = True
            self.busy_s[l.kind] = (self.busy_s.get(l.kind, 0.0)
                                   + (l.end - l.start))
        self._active = [l for l in self._active if not l.reported_end]
        self._t = max(self._t, now)
        return started, completed

    def cancel(self, lease: CpuLease, now: float) -> None:
        """Withdraw a lease: a queued one releases its (future) core slot
        and later waiting work backfills earlier; a running one frees its
        core at ``now``. Reported-complete leases are left alone."""
        if lease.cancelled or lease.reported_end:
            return
        lease.cancelled = True
        if lease not in self._active:
            return
        self._active.remove(lease)
        waiting = self._unstarted(now)
        self._undo(waiting)
        i = bisect.bisect_left(self._slots, lease.end)
        if i < len(self._slots) and self._slots[i] == lease.end:
            self._slots.pop(i)
            # a queued lease gives back the slot it consumed; a running
            # one frees its core the moment it is cancelled
            freed = lease.popped_slot if lease.start > now else now
            bisect.insort(self._slots, freed)
        for l in sorted(waiting, key=lambda l: (l.priority, l.seq)):
            self._place(l, now)

    def next_event_time(self, kind: Optional[str] = None) -> Optional[float]:
        """Earliest unreported lease completion (optionally of one kind) —
        queued work is already eagerly scheduled, so this accounts for
        queueing delay, not just running leases."""
        ends = [l.end for l in self._active
                if not l.reported_end and (kind is None or l.kind == kind)]
        return min(ends) if ends else None

    def queue_wait_estimate(self, now: float, cost_s: float = 0.0,
                            extra_backlog_s: float = 0.0) -> float:
        """Projected seconds *one* new lease would wait for a core: the
        earliest core-free time under the current schedule, pushed out by
        ``extra_backlog_s`` of hypothetical work spread across cores. This
        is the per-transfer pricing signal (retention decisions)."""
        if not self._slots:
            return 0.0
        v = self._slots[0] + extra_backlog_s / self.cores
        return max(0.0, v - now)

    def horizon_wait(self, now: float, extra_backlog_s: float = 0.0) -> float:
        """Sustained-oversubscription signal: scheduled work-in-system
        (plus ``extra_backlog_s`` hypothetical seconds) divided by cores —
        the expected core-queueing delay a *steady* new CPU consumer
        experiences, not the one-lease best case above. Near zero on a
        quiet pool; grows with every long tool parked on a core. This is
        what the control plane's ``cpu_queue_bound_s`` admission term
        compares against."""
        work = sum(max(0.0, t - now) for t in self._slots)
        return (work + max(0.0, extra_backlog_s)) / self.cores

    # --- live accounting (wall-clock path) ------------------------------
    def acquire(self, now: float, kind: str = "tool",
                mem_gb: float = 0.0) -> int:
        self._live_tok_seq += 1
        tok = self._live_tok_seq
        self._live_tokens[tok] = (now, kind, mem_gb)
        self._live_busy += 1
        self._live_mem_gb += mem_gb
        self.n_leases[kind] = self.n_leases.get(kind, 0) + 1
        self.peak_mem_gb = max(self.peak_mem_gb, self._live_mem_gb)
        return tok

    def release(self, now: float, tok: int) -> None:
        t0, kind, mem = self._live_tokens.pop(tok, (now, "tool", 0.0))
        self._live_busy = max(0, self._live_busy - 1)
        self._live_mem_gb = max(0.0, self._live_mem_gb - mem)
        self.busy_s[kind] = self.busy_s.get(kind, 0.0) + max(0.0, now - t0)

    def note_wait(self, kind: str, wait_s: float) -> None:
        self.queue_wait_s[kind] = (self.queue_wait_s.get(kind, 0.0)
                                   + max(0.0, wait_s))

    def pending_inc(self) -> None:
        self._live_pending += 1
        self.max_backlog = max(self.max_backlog, self._live_pending)

    def pending_dec(self) -> None:
        self._live_pending = max(0, self._live_pending - 1)

    # --- gauges ----------------------------------------------------------
    def busy_cores(self, now: float) -> int:
        modeled = sum(1 for l in self._active if l.start <= now < l.end)
        return modeled + self._live_busy

    def backlog(self, now: float) -> int:
        modeled = sum(1 for l in self._active if l.start > now)
        return modeled + self._live_pending

    def stats(self) -> dict:
        return {
            "cores": self.cores,
            "interference": self.cfg.interference,
            "n_leases": dict(self.n_leases),
            "busy_s": {k: round(v, 6) for k, v in self.busy_s.items()},
            "queue_wait_s": {k: round(v, 6)
                             for k, v in self.queue_wait_s.items()},
            "queue_wait_total_s": round(sum(self.queue_wait_s.values()), 6),
            "max_backlog": self.max_backlog,
            "max_stretch": round(self.max_stretch, 6),
            "peak_mem_gb": round(self.peak_mem_gb, 6),
        }
