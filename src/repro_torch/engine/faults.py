"""Deterministic fault injection for the sim engine and tool executors.

The online incident plane (``repro.obs.detect``) is only credible if its
detectors are proven against *known* faults: ``benchmarks/slo_bench.py``
injects each fault class at a scripted sim time and measures detection
latency and precision/recall. Everything here runs on the modeled clock,
so a seeded workload plus a ``FaultPlan`` reproduces the same incident
stream bit-for-bit.

Fault kinds and where they bite:

``stuck_tool``
    The next tool invocation at/after ``at_s`` (or every invocation of a
    targeted ``sid``) runs ``stretch``x its nominal duration — a hung
    build / wedged subprocess. Injected in ``SimToolExecutor.start``
    *after* the honest ``expected_s`` is stamped on ``TOOL_ENQUEUE``, so
    the detector sees the promised duration, not the fault.
``frozen_admission``
    Admission simply stops running between ``at_s`` and ``until_s`` — a
    wedged control plane. Waiting sessions queue; KV frees up; nothing is
    admitted.
``slowed_swap``
    Host-tier PCIe bandwidth divided by ``factor`` inside the window — a
    saturated/degraded link. Swap-ins/-outs serialize for seconds instead
    of milliseconds (the io-plane storm signature).
``freeze_decode``
    A targeted (or the first currently-decoding) session is silently
    excluded from batch formation from ``at_s`` on — the scheduler-bug
    livelock: DECODING phase, never another DECODE_STEP.
``cpu_flood``
    ``n_leases`` foreign leases of ``cpu_work_s`` seconds each land on the
    shared core pool at ``at_s`` — a co-tenant burst. Tool and transfer
    staging work queues behind them (``cpu_backlog`` climbs).

``FaultPlan.install(engine)`` wires the plan into the engine and its sim
tool executor; engines without a plan pay one ``is None`` check per tick.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

FAULT_KINDS = ("stuck_tool", "frozen_admission", "slowed_swap",
               "freeze_decode", "cpu_flood")


@dataclass
class Fault:
    kind: str
    at_s: float                     # activation (modeled seconds)
    until_s: float = math.inf       # deactivation (windowed kinds)
    sid: int = -1                   # target session; -1 = first applicable
    factor: float = 100.0           # slowed_swap bw divisor
    stretch: float = 1e6            # stuck_tool duration multiplier
    cpu_work_s: float = 900.0       # cpu_flood per-lease seconds
    n_leases: int = 64              # cpu_flood lease count
    # bookkeeping
    applied: bool = field(default=False, repr=False)
    hits: int = field(default=0, repr=False)
    _saved: Optional[float] = field(default=None, repr=False)

    def window(self, now: float) -> bool:
        return self.at_s <= now < self.until_s

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


class FaultPlan:
    """A scripted set of faults consulted by the engine's hooks."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        # freeze_decode late binding: sid -1 resolves to the first session
        # observed decoding at/after at_s (stamped by the engine hook)
        self._frozen_sids: Dict[int, int] = {}

    # -- wiring ----------------------------------------------------------
    def install(self, engine) -> "FaultPlan":
        engine.faults = self
        tools = getattr(engine, "tools", None)
        if tools is not None and hasattr(tools, "faults"):
            tools.faults = self
        return self

    # -- queries the engine hooks make -----------------------------------
    def active(self, kind: str, now: float) -> bool:
        return any(f.kind == kind and f.window(now) for f in self.faults)

    def freezes(self, sid: int, now: float) -> bool:
        """Is ``sid`` freeze_decode-targeted right now? A -1 target latches
        onto the first sid asked about while the fault is active (the
        caller iterates the decode order, so that is the top decoding
        session at activation) and stays latched."""
        for i, f in enumerate(self.faults):
            if f.kind != "freeze_decode" or not f.window(now):
                continue
            tgt = f.sid if f.sid >= 0 else self._frozen_sids.get(i, -1)
            if tgt < 0:
                self._frozen_sids[i] = tgt = sid
            if tgt == sid:
                f.hits += 1
                return True
        return False

    def tool_duration(self, sid: int, kind: str, duration: float,
                      now: float) -> float:
        """Actual (possibly stretched) service time for a tool invocation.
        A -1 target sticks to the first invocation inside the window."""
        for f in self.faults:
            if f.kind != "stuck_tool" or not f.window(now):
                continue
            if f.sid >= 0 and f.sid != sid:
                continue
            if f.sid < 0 and f.hits > 0:
                continue               # -1 target: first invocation only
            f.hits += 1
            return duration * f.stretch
        return duration

    # -- state transitions the engine applies every tick ------------------
    def apply(self, engine, now: float) -> None:
        for f in self.faults:
            if f.kind == "slowed_swap" and engine.host is not None:
                if f.window(now) and not f.applied:
                    f.applied = True
                    f._saved = engine.host.cfg.pcie_bw
                    engine.host.cfg.pcie_bw = f._saved / max(1.0, f.factor)
                elif not f.window(now) and f.applied and f._saved is not None:
                    f.applied = False
                    engine.host.cfg.pcie_bw = f._saved
                    f._saved = None
            elif f.kind == "cpu_flood":
                if now >= f.at_s and not f.applied:
                    f.applied = True
                    for _ in range(f.n_leases):
                        engine.cpu_pool.submit(now, f.cpu_work_s, sid=-9,
                                               kind="tool", tag="fault_flood",
                                               priority=1)

    def summary(self) -> List[dict]:
        return [{"kind": f.kind, "at_s": f.at_s, "until_s": f.until_s,
                 "sid": f.sid, "hits": f.hits} for f in self.faults]
