"""Unified Information Stream (paper §4.1, Table 1).

Structured boundary events with stable session identifiers, emitted whenever
a session changes execution state on either plane:

    GPU plane:     gpu_submit / gpu_first_token / gpu_end
                   (+ per-tick attribution records: prefill_chunk /
                   decode_step, carrying the executed interval)
    CPU plane:     tool_enqueue / tool_start / tool_end
    Control plane: submit / reject / window_update / admit / evict / pin /
                   unpin / preempt / retention / tick / incident
    I/O plane:     swap_out / swap_in / demote / promote / swap_abandon

Both the external control plane and the internal scheduler consume the same
stream; consumers subscribe with callbacks and the log is retained for
benchmarks (eviction-dynamics figures read it directly) and for the
observability layer (``repro.obs``), which assembles the stream into
per-session span trees and exclusive critical-path segments.

Long soaks bound memory with ``max_log``: the log becomes a ring buffer and
``dropped`` counts evictions. ``of_kind`` answers from a per-kind index —
O(matches), not a full-log scan — capped at the same depth when a ring is
configured.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

GPU_SUBMIT = "gpu_submit"
GPU_FIRST_TOKEN = "gpu_first_token"
GPU_END = "gpu_end"
PREFILL_CHUNK = "prefill_chunk"  # one executed prefill chunk: data carries
DECODE_STEP = "decode_step"      # (start, end); one decode quantum likewise
TOOL_ENQUEUE = "tool_enqueue"
TOOL_START = "tool_start"
TOOL_END = "tool_end"
SUBMIT = "submit"              # session entered the external queue
REJECT = "reject"              # admission-rejected (can never fit the pool)
WINDOW_UPDATE = "window_update"
ADMIT = "admit"
EVICT = "evict"
PIN = "pin"
UNPIN = "unpin"
PREEMPT = "preempt"
RETENTION = "retention"        # audit: chosen action + priced alternatives
TICK = "tick"                  # one engine iteration (phase wall timings)
SWAP_OUT = "swap_out"
SWAP_IN = "swap_in"
SWAP_ABANDON = "swap_abandon"  # host copy given up: rebuild by recompute
DEMOTE = "demote"              # tiered store: host DRAM -> NVMe migration
PROMOTE = "promote"            # tiered store: NVMe -> host DRAM (staged restore)
PREFIX_HIT = "prefix_hit"      # cold prefill attached to shared radix blocks
FINISH = "finish"
INCIDENT = "incident"          # obs.detect: structured anomaly w/ evidence
TRACE_META = "trace_meta"      # JSONL dump header (dropped-event count)


@dataclass(frozen=True)
class Event:
    kind: str
    t: float
    sid: int = -1
    data: Dict[str, Any] = field(default_factory=dict)


class EventBus:
    """Low-overhead pub/sub + append log (optionally ring-buffered)."""

    def __init__(self, keep_log: bool = True, max_log: Optional[int] = None):
        self._subs: Dict[str, List[Callable[[Event], None]]] = {}
        self._all: List[Callable[[Event], None]] = []
        self.keep_log = keep_log
        self.max_log = max_log
        self.log: Deque[Event] = deque(maxlen=max_log)
        self._by_kind: Dict[str, Deque[Event]] = {}
        self.counts: Dict[str, int] = {}
        self.dropped = 0               # ring evictions (max_log exceeded)

    def subscribe(self, kind: Optional[str], fn: Callable[[Event], None]) -> None:
        if kind is None:
            self._all.append(fn)
        else:
            self._subs.setdefault(kind, []).append(fn)

    def emit(self, kind: str, t: float, sid: int = -1, /, **data) -> Event:
        ev = Event(kind, t, sid, data)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if self.keep_log:
            log = self.log
            if log.maxlen is not None and len(log) == log.maxlen:
                self.dropped += 1
            log.append(ev)
            idx = self._by_kind.get(kind)
            if idx is None:
                # per-kind ring at the same depth as the log: of_kind stays
                # O(matches) and total retention is bounded by kinds x cap
                idx = self._by_kind[kind] = deque(maxlen=self.max_log)
            idx.append(ev)
        for fn in self._subs.get(kind, ()):
            fn(ev)
        for fn in self._all:
            fn(ev)
        return ev

    def of_kind(self, kind: str) -> List[Event]:
        return list(self._by_kind.get(kind, ()))
