"""95th percentile of every gap between consecutive output tokens of a
round that ends in the window, the gap still open at the close counted
up to the close: the streaming tail an agent framework sees."""
from mars_bench.window import itl_gaps, percentile


def read(run):
    gaps = itl_gaps(run)
    return (percentile(gaps, 95.0), len(gaps)) if gaps else None
