"""Share of the prefill rows computed for padding in the window's mixed
iterations (those the profiler covered): 1 - the packs' real tokens over
P x C (packs padded to one bucketed width C, P bucketed to a power of
two, slack packs computing a full C), from the program's counters on
``run_mixed``; beside it the decode lanes, real and computed (B, a power
of two)."""
from mars_bench import program_spans as P


def read(run):
    sp = P.spans_of(run)
    real = computed = n = 0
    lanes = {"lanes_real": 0, "lanes_computed": 0}
    for i in P.window_iters(run):
        c = sp[i].counts
        for k in lanes:
            lanes[k] += c.get(k, 0)
        if c.get("pack_tokens_computed"):
            real += c.get("pack_tokens_real", 0)
            computed += c["pack_tokens_computed"]
            n += 1
    if not computed:
        return None
    return (1.0 - real / computed, n, {"pack_tokens_real": real,
                                       "pack_tokens_computed": computed,
                                       **lanes})
