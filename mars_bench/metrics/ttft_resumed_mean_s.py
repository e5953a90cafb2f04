"""Mean, over the resumed rounds (round >= 1) due in the window, of the
wait from the tool's end to the round's first token, censored at the
close: the wait MARS's retention and continuation priority cut. The
mean, not the median: the waits fall in two modes (a resumed prompt of
one pack or of two), and the median jumped between them from run to run
(spread 17-31 % over six seeds against 7.5 % for the mean, on one
H100 80GB). A per-layer reading and not an end-to-end one: a window
holds only 16-18 resumed rounds, and their mean spread 10-18 % between
runs of one cell, more than half of any bound may allow."""
from mars_bench.window import median, percentile, ttfts


def read(run):
    w = ttfts(run, resumed=True)
    if not w:
        return None
    return (sum(w) / len(w), len(w), {"median": median(w),
                                      "p90": percentile(w, 90.0)})
