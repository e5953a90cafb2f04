"""The program's own host spans and counters (``repro_torch.obs.spans``),
for the metrics that read them.

The program records them while ``torch.profiler`` records, so the traced
run carries them over its profiled stretch: the window's last
``profile_s`` seconds, in whole ticks, whose iterations the profiler
lengthens: the metrics that read them describe profiled iterations. They
are stamped on ``time.time_ns()``'s clock, that of the profiler's
records; here they are in seconds on that clock, as ``Profile``'s records
are. A program without the recorder (an older checkout) gives no spans,
and every metric that reads them reads nothing.

The spans are drained from the program once, by the first reader, and
kept on the ``Run`` as ``program_spans``, with the count the program's
full buffer dropped as ``program_spans_dropped``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from mars_bench.trace import ITER
from mars_bench.window import median

RUN_MIXED = "run_mixed"
PHASES = ("run_mixed.inputs", "run_mixed.forward", "run_mixed.readback",
          "run_mixed.commit")


class PSpan(NamedTuple):
    name: str
    parent: int                  # index in the same list, -1: none
    t0: float                    # s, the profiler's clock
    t1: float
    counts: Dict[str, int]

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def _drain() -> Tuple[List[PSpan], int]:
    try:
        from repro_torch.obs import spans
    except ImportError:
        return [], 0
    got, dropped = spans.drain()
    return [PSpan(s.name, s.parent, s.t0 * 1e-9, s.t1 * 1e-9, s.counts)
            for s in got if s.t1], dropped


def spans_of(run) -> List[PSpan]:
    if getattr(run, "program_spans", None) is None:
        run.program_spans, run.program_spans_dropped = _drain()
    return run.program_spans


def dropped(run) -> int:
    """Spans the program dropped for want of room (0 before a drain)."""
    return getattr(run, "program_spans_dropped", 0)


def children(sp: Sequence[PSpan]) -> Dict[int, List[int]]:
    kids: Dict[int, List[int]] = {}
    for i, s in enumerate(sp):
        kids.setdefault(s.parent, []).append(i)
    return kids


def child(sp, kids, i: int, name: str) -> Optional[int]:
    return next((j for j in kids.get(i, ()) if sp[j].name == name), None)


def run_clock_offset(run) -> Optional[float]:
    """Profiler clock minus run clock, from the benchmark's own span
    around each profiled ``run_mixed`` call and that call's start."""
    p = run.profile
    if p is None:
        return None
    marks = sorted(s[1] for s in p.spans if s[0] == ITER)
    its = [it.t0 for it in run.iters if it.profiled]
    if not marks or len(marks) != len(its):
        return None
    return median([a - b for a, b in zip(marks, its)])


def window_iters(run) -> List[int]:
    """Indices of the program's ``run_mixed`` spans that end in the
    window (all of them when the run's clock cannot be matched)."""
    sp = spans_of(run)
    off = run_clock_offset(run)
    return [i for i, s in enumerate(sp) if s.name == RUN_MIXED
            and (off is None or run.inside(s.t1 - off))]


def phase_ms(run, name: str):
    """Mean wall in ms of the phase ``name`` of the window's mixed
    iterations, their count, and the phases' spans."""
    sp = spans_of(run)
    kids = children(sp)
    got = [j for j in (child(sp, kids, i, name) for i in window_iters(run))
           if j is not None]
    if not got:
        return None, 0, []
    return 1e3 * sum(sp[j].dur for j in got) / len(got), len(got), got


def self_s(sp, kids, root: int) -> Dict[str, float]:
    """Self time (duration less its children's) by span name over the
    subtree under ``root``, in seconds."""
    out: Dict[str, float] = {}
    todo = list(kids.get(root, ()))
    while todo:
        j = todo.pop()
        cs = kids.get(j, ())
        out[sp[j].name] = out.get(sp[j].name, 0.0) + sp[j].dur - sum(
            sp[c].dur for c in cs)
        todo.extend(cs)
    return out


# ---------------------------------------------------------------------------
# interval arithmetic over sorted, disjoint intervals
# ---------------------------------------------------------------------------

def overlap_s(a: Sequence[Tuple[float, float]],
              b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def minus(a: Sequence[Tuple[float, float]],
          b: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """``a`` less ``b`` (both sorted and disjoint)."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append((lo, b[k][0]))
            lo = max(lo, b[k][1])
            k += 1
        if hi > lo:
            out.append((lo, hi))
    return out


def intervals(sp: Sequence[PSpan], *names: str) -> List[Tuple[float, float]]:
    return sorted((s.t0, s.t1) for s in sp if s.name in names)


def path(sp: Sequence[PSpan], i: int) -> str:
    names = []
    while i >= 0:
        names.append(sp[i].name)
        i = sp[i].parent
    return "/".join(reversed(names))


def innermost(sp: Sequence[PSpan], t: float) -> str:
    """The path of the deepest span open at ``t`` ('' for none)."""
    best, depth = -1, -1
    for i, s in enumerate(sp):
        if s.t0 <= t < s.t1:
            d = path(sp, i).count("/")
            if d > depth:
                best, depth = i, d
    return path(sp, best) if best >= 0 else ""
