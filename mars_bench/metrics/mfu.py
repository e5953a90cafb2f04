"""The window's model FLOPs over the card's bf16 peak, in %: the FLOPs
the schedule needs for the tokens computed in the iterations that end in
the window (each pack's real tokens, each decode lane), over ``seconds``
x 989 TFLOP/s. Counted from the shapes (``roofline.token_flops``), so it
reads the same whatever implements the step."""
from mars_bench import roofline
from mars_bench.window import iters_in_window


def read(run):
    flops, tokens = 0.0, 0
    for it in iters_in_window(run):
        for _sid, start, n, _C in it.packs:
            flops += roofline.pack_flops(run.cfg, start, n)
            tokens += n
        for _sid, pos in it.lanes:
            flops += roofline.token_flops(run.cfg, pos + 1, logits=True)
            tokens += 1
    if not tokens:
        return None
    return (100.0 * flops / (run.seconds * roofline.PEAK_FLOPS), tokens)
