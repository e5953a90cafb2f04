"""Median wait of the window's arriving sessions in the external queue:
from the arrival (SUBMIT, stamped with the due time) to admission (the
engine's GPU_SUBMIT of round 0), censored at the close."""
from mars_bench.window import GPU_SUBMIT, median


def read(run):
    admit = {}
    for e in run.of(GPU_SUBMIT):
        if e.data.get("round") == 0:
            admit.setdefault(e.sid, e.t)
    w = [min(admit.get(sid, run.w1), run.w1) - t
         for sid, t in run.arrival.items() if run.inside(t)]
    return (median(w), len(w)) if w else None
