"""Mean wall, in ms, of the mixed iteration (the benchmark's span around
each ``_PagedLayout.run_mixed`` call that ends in the window): its host
work and the device work it waits for when it reads the tokens back."""
from mars_bench.window import iters_in_window


def read(run):
    its = iters_in_window(run)
    if not its:
        return None
    return (1e3 * sum(it.t1 - it.t0 for it in its) / len(its), len(its))
