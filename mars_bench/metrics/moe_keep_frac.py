"""Share of the routed MoE entries that the capacity dispatch keeps, in
the window's mixed iterations (those the profiler covered): the
program's counters on ``run_mixed``, ``moe_entries_kept`` over
``moe_entries_routed``, each summed on the device over every MoE layer
of every stage, real tokens only (padded pack rows and idle lanes
excluded). Beside it, the two sums. A program without the counters (or a
dense model) reads nothing."""
from mars_bench import program_spans as P

KINDS = ("moe_entries_routed", "moe_entries_kept")


def read(run):
    sp = P.spans_of(run)
    got = dict.fromkeys(KINDS, 0)
    n = 0
    for i in P.window_iters(run):
        c = sp[i].counts
        if c.get("moe_entries_routed"):
            n += 1
            for k in KINDS:
                got[k] += c.get(k, 0)
    if not got["moe_entries_routed"]:
        return None
    return got["moe_entries_kept"] / got["moe_entries_routed"], n, got
