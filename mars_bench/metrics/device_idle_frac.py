"""Share of the profiled stretch (the last ``profile_s`` seconds of the
window, whole engine ticks) in which no device record runs: how far the
host holds the card back."""
from mars_bench.trace import busy_s


def read(run):
    p = run.profile
    if p is None or p.t1 <= p.t0:
        return None
    return (1.0 - busy_s(p) / (p.t1 - p.t0), len(p.kernels))
