"""Share of the model step's stages replayed from CUDA graphs in the
window's mixed iterations (those the profiler covered): each pack and
each iteration's decode lanes is one stage, counted on ``run_mixed`` as
``stages_replayed``, ``stages_captured`` or ``stages_eager``; the share
is the replayed over all three. Beside it, the three counts. A program
that counts no stages (one without the graphs) reads nothing."""
from mars_bench import program_spans as P

KINDS = ("stages_replayed", "stages_captured", "stages_eager")


def read(run):
    sp = P.spans_of(run)
    got = dict.fromkeys(KINDS, 0)
    n = 0
    for i in P.window_iters(run):
        c = sp[i].counts
        if any(c.get(k) for k in KINDS):
            n += 1
            for k in KINDS:
                got[k] += c.get(k, 0)
    total = sum(got.values())
    if not total:
        return None
    return got["stages_replayed"] / total, n, got
