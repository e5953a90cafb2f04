"""Median, over the sessions arriving in the window, of the wait from
the arrival (the due time) to round 0's first token, censored at the
close: admission plus cold prefill. A per-layer metric: a window holds
only 3-5 arrivals at the cells' rates, and its median spread 10-55 %
over six seeds on one H100 80GB, more than any bound may allow."""
from mars_bench.window import median, percentile, ttfts


def read(run):
    w = ttfts(run, resumed=False)
    if not w:
        return None
    return (median(w), len(w), {"mean": sum(w) / len(w),
                                "p90": percentile(w, 90.0)})
