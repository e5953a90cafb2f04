"""What one run recorded, and the window arithmetic over it.

Every time here is in seconds on the run's clock: 0 is the first arrival
of the lead-in, the window is ``[w0, w1)`` with ``w0 = lead_in_s`` and
``w1 = w0 + seconds``. Events are the engine's bus events, stamped with
the host clock when they were emitted; a session's round 0 falls due at
its arrival, a later round when the tool before it ends (``TOOL_END``).

Censoring: a round due in the window whose first token has not come by
the close enters a TTFT with the wait it has had (``w1 - due``); a round
with tokens and no end by the close contributes an open gap, from its
last token to the close, to the inter-token gaps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SUBMIT, REJECT = "submit", "reject"
GPU_SUBMIT, GPU_END = "gpu_submit", "gpu_end"
DECODE_STEP, TOOL_END = "decode_step", "tool_end"
PREFIX_HIT = "prefix_hit"


@dataclass(frozen=True)
class Ev:
    kind: str
    t: float
    sid: int
    data: Dict


@dataclass
class Iter:
    """One call of the mixed iteration (the benchmark's span around it):
    host start and end; each pack ``(sid, start, n, C)``; each decode lane
    ``(sid, pos)`` (it feeds position ``pos``, attending ``pos + 1`` keys);
    whether the profiler was recording; the KV pool's pages held by
    sessions once the call returned."""
    t0: float
    t1: float
    packs: List[Tuple[int, int, int, int]]
    lanes: List[Tuple[int, int]]
    profiled: bool = False
    pages: int = 0


@dataclass
class Kernel:
    """One device record of the profiled stretch (seconds, its clock)."""
    name: str
    t0: float
    dur: float


@dataclass
class Profile:
    """The traced run's device records over the profiled stretch
    ``[t0, t1)`` (the profiler's clock), and the host spans named by the
    benchmark's annotations (name, start, end) on the same clock."""
    t0: float
    t1: float
    kernels: List[Kernel]
    spans: List[Tuple[str, float, float]] = field(default_factory=list)


@dataclass
class Run:
    """What a reader sees. ``rounds[sid]`` holds each round's (prompt
    tokens, decode tokens); ``arrival[sid]`` the session's due time."""
    seconds: float
    w0: float
    w1: float
    setup_s: float
    events: List[Ev]
    arrival: Dict[int, float]
    rounds: Dict[int, List[Tuple[int, int]]]
    iters: List[Iter]
    cfg: Dict
    traffic: Dict
    profile: Optional[Profile] = None

    def of(self, kind: str) -> List[Ev]:
        return [e for e in self.events if e.kind == kind]

    def inside(self, t: float) -> bool:
        return self.w0 <= t < self.w1


# ---------------------------------------------------------------------------
# rounds, tokens and their times
# ---------------------------------------------------------------------------

def token_times(run: Run) -> Dict[Tuple[int, int], List[float]]:
    """(sid, round) -> the times of its output tokens, in order."""
    out: Dict[Tuple[int, int], List[float]] = {}
    for e in run.of(DECODE_STEP):
        out.setdefault((e.sid, e.data["round"]), []).extend(
            [e.t] * int(e.data.get("tokens", 1)))
    return out


def round_ends(run: Run) -> Dict[Tuple[int, int], float]:
    return {(e.sid, e.data["round"]): e.t for e in run.of(GPU_END)}


def rounds_due(run: Run) -> List[Tuple[int, int, float]]:
    """(sid, round, due) of every round that falls due in the window:
    round 0 at its session's arrival, round r >= 1 at the r-th tool end."""
    due = [(sid, 0, t) for sid, t in run.arrival.items() if run.inside(t)]
    seen: Dict[int, int] = {}
    for e in sorted(run.of(TOOL_END), key=lambda e: e.t):
        r = seen[e.sid] = seen.get(e.sid, 0) + 1
        if run.inside(e.t):
            due.append((e.sid, r, e.t))
    return sorted(due, key=lambda x: x[2])


def ttfts(run: Run, resumed: bool) -> List[float]:
    """Waits from due to first token of the rounds due in the window
    (round 0 alone, or the resumed rounds), censored at the close."""
    first = {k: v[0] for k, v in token_times(run).items()}
    out = []
    for sid, r, due in rounds_due(run):
        if (r > 0) != resumed:
            continue
        t = first.get((sid, r))
        out.append((t if t is not None and t < run.w1 else run.w1) - due)
    return out


def itl_gaps(run: Run) -> List[float]:
    """Gaps between consecutive output tokens of a round that end in the
    window, with the gap still open at the close counted up to it."""
    ends = round_ends(run)
    gaps = []
    for key, ts in token_times(run).items():
        ts = sorted(ts)
        gaps += [b - a for a, b in zip(ts, ts[1:]) if run.inside(b)]
        before = [t for t in ts if t < run.w1]
        end = ends.get(key)
        if before and (end is None or end >= run.w1):
            gaps.append(run.w1 - before[-1])
    return gaps


def output_tokens(run: Run) -> int:
    return sum(int(e.data.get("tokens", 1)) for e in run.of(DECODE_STEP)
               if run.inside(e.t))


def attempted_failed(run: Run) -> Tuple[int, int]:
    """Rounds due in the window, and those of them refused or decoded to
    another count than their own (a round still running is not failed)."""
    due = rounds_due(run)
    rejected = {e.sid for e in run.of(REJECT)}
    counts = {k: len(v) for k, v in token_times(run).items()}
    ends = round_ends(run)
    failed = 0
    for sid, r, _t in due:
        if sid in rejected:
            failed += 1
        elif (sid, r) in ends and counts.get((sid, r), 0) != \
                run.rounds[sid][r][1]:
            failed += 1
    return len(due), failed


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def median(xs: Sequence[float]) -> Optional[float]:
    return percentile(xs, 50.0)


def percentile(xs: Sequence[float], p: float) -> Optional[float]:
    """Linear interpolation between closest ranks (numpy's default)."""
    a = sorted(xs)
    if not a:
        return None
    k = (len(a) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return a[lo] + (a[hi] - a[lo]) * (k - lo)


def iters_in_window(run: Run) -> List[Iter]:
    return [it for it in run.iters if run.inside(it.t1)]


def union_s(intervals: Sequence[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi)``."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi)`` that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]
