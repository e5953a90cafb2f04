"""Output tokens delivered in the window (every DECODE_STEP inside it),
over the window's length: what one card carries."""
from mars_bench.window import output_tokens


def read(run):
    n = output_tokens(run)
    return (n / run.seconds, n) if n else None
