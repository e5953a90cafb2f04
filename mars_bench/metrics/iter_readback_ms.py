"""Mean wall, in ms, of the program's ``run_mixed.readback`` span in the
window's mixed iterations (those the profiler covered): the host blocked
in the tokens' ``.cpu()`` reads until the card has run the iteration;
beside it the reads an iteration makes."""
from mars_bench import program_spans as P


def read(run):
    ms, n, got = P.phase_ms(run, "run_mixed.readback")
    if not n:
        return None
    sp = P.spans_of(run)
    return (ms, n, {"readbacks_per_iter": sum(
        sp[j].counts.get("readbacks", 0) for j in got) / n})
