"""The traced run's device records: ``torch.profiler`` over the last
``profile_s`` seconds of the window, read after the window has closed.

The profiler starts at an engine tick's boundary once the window's close
is ``profile_s`` away, and stops after the close, so the stall of
stopping it never lands inside the window. The benchmark names its host
spans with ``record_function`` (``mars_bench.tick`` around each engine
tick, ``mars_bench.run_mixed`` around each mixed iteration), so they sit
on the device records' clock. The records are read straight from the
profiler's raw events; no per-operator tree is built.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

from mars_bench.window import Kernel, Profile, idle_gaps, union_s

TICK, ITER = "mars_bench.tick", "mars_bench.run_mixed"


def read_profile(prof) -> Profile:
    """The device records and the benchmark's spans of a stopped
    profiler, on one clock in seconds; the stretch runs from the first
    tick's start to the last tick's end."""
    kernels: List[Kernel] = []
    spans: List[Tuple[str, float, float]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        on_device = "CUDA" in str(e.device_type())
        if name.startswith("mars_bench."):
            if not on_device:
                spans.append((name, t0, t0 + dur))
        elif on_device and dur > 0:
            kernels.append(Kernel(name, t0, dur))
    ticks = [s for s in spans if s[0] == TICK]
    if not ticks:
        return Profile(0.0, 0.0, [], spans)
    lo, hi = min(s[1] for s in ticks), max(s[2] for s in ticks)
    kernels = [k for k in kernels if k.t0 < hi and k.t0 + k.dur > lo]
    return Profile(lo, hi, kernels, spans)


def busy_s(p: Profile) -> float:
    return union_s([(k.t0, k.t0 + k.dur) for k in p.kernels], p.t0, p.t1)


def kernel_seconds(p: Profile, names: Sequence[str]) -> float:
    """Device seconds of the records whose name holds one of ``names``."""
    return sum(k.dur for k in p.kernels if any(n in k.name for n in names))


def short(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0] or name


def breakdown(p: Profile) -> Dict[str, list]:
    """The ten device operations that took most time, and the ten
    longest idle gaps named by the host span they fall in."""
    by: Dict[str, float] = {}
    for k in p.kernels:
        by[short(k.name)] = by.get(short(k.name), 0.0) + k.dur
    ops = sorted(by.items(), key=lambda x: -x[1])[:10]
    gaps = idle_gaps([(k.t0, k.t0 + k.dur) for k in p.kernels], p.t0, p.t1)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        where = "between ticks (run_live loop)"
        for name, s0, s1 in p.spans:
            if s0 <= mid < s1:
                if name == ITER:
                    where = "run_mixed"
                    break
                where = "engine tick outside run_mixed"
        named.append([where, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
