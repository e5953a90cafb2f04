"""Share of the profiled stretch in which no device record runs while the
host is inside the program's ``run_mixed.forward`` span: the card idle
because the host is still enqueuing the iteration's launches. Beside it,
the idle share under each other part of the host's time (the other
phases of ``run_mixed``, ``run_mixed`` between its phases, ``run_batch``
outside ``run_mixed``, outside ``run_batch``; together they sum to
``device_idle_frac``), and the innermost program span under each of the
ten longest idle gaps."""
from mars_bench import program_spans as P
from mars_bench.window import idle_gaps

OUTSIDE = "outside run_batch"


def read(run):
    p = run.profile
    sp = P.spans_of(run)
    if p is None or p.t1 <= p.t0 or not sp:
        return None
    gaps = idle_gaps([(k.t0, k.t0 + k.dur) for k in p.kernels], p.t0, p.t1)
    mixed = P.intervals(sp, P.RUN_MIXED)
    parts = {name: P.intervals(sp, name) for name in P.PHASES}
    parts["run_mixed between its phases"] = P.minus(
        mixed, P.intervals(sp, *P.PHASES))
    parts["run_batch outside run_mixed"] = P.minus(
        P.intervals(sp, "run_batch"), mixed)
    span = p.t1 - p.t0
    idle = {k: P.overlap_s(gaps, v) / span for k, v in parts.items()}
    idle[OUTSIDE] = sum(b - a for a, b in gaps) / span - sum(idle.values())
    n = sum(1 for a, b in parts["run_mixed.forward"] if b > p.t0 and a < p.t1)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return (idle["run_mixed.forward"], n, {
        "idle_by_span": idle,
        "longest_gaps": [[P.innermost(sp, (a + b) / 2) or OUTSIDE, b - a]
                         for a, b in longest]})
