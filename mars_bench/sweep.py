"""The rate sweep that fixes a cell's arrival rate: the cell's traffic at
each given rate, one process, one card, the reference check skipped.

    python3 mars_bench/sweep.py --workload <cell> --rates 0.1,0.2,0.3 \\
        --seed <n> --seconds 45

A rate is sustained when no round due in the window failed, the backlog
does not grow (the later half of the window's arrivals waits for round
0's first token no longer than twice the earlier half's wait plus 1 s,
medians, an arrival still waiting at the close left out since its
censored wait shrinks towards the close whatever the backlog), and the
output keeps up with the load: the window's output tokens per second per
unit of rate stays within 15 % of the previous (lower) swept rate's. The
wait rule alone called every rate sustained, up to rates at which the
output stalled and round-0 waits grew to 15-40 s on one H100 80GB:
a window of 51 s after a 20 s lead-in sees the queue build, not its
growth rate. A cell runs at 0.7 x the highest rate sustained. Each
rate's line also lists every arrival's round-0 wait from the start of
the lead-in, which shows how long the lead-in must be for the window's
first and last arrivals to wait alike.
"""
import argparse
import gc
import json
import os
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
from mars_bench import run as _run  # noqa: E402,F401  (paths and caches)


def round0_waits(run):
    """(arrival, wait for round 0's first token) of every arrival before
    the close, in arrival order, censored at the close."""
    from mars_bench.window import token_times
    first = {sid: ts[0] for (sid, r), ts in token_times(run).items()
             if r == 0}
    return [(t, min(first.get(sid, run.w1), run.w1) - t)
            for sid, t in sorted(run.arrival.items(), key=lambda x: x[1])
            if t < run.w1]


def sustained(run, failed: int) -> bool:
    from mars_bench.window import median
    waits = [w for t, w in round0_waits(run)
             if run.inside(t) and t + w < run.w1]
    half = len(waits) // 2
    if failed or not half:
        return not failed
    return median(waits[half:]) <= 2 * median(waits[:half]) + 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from mars_bench import bench
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    per_rate = None                  # output tokens/s per unit rate
    for rate in sorted(float(r) for r in args.rates.split(",")):
        keep = {}
        res = bench.run_cell(
            args.workload, args.seed, args.seconds, False,
            t_start=time.monotonic(), verify=False, keep=keep,
            shrink=lambda c, t: (c, dict(t, arrival_rate=rate)),
            say=lambda m: print(m, flush=True))
        run = keep.pop("run")
        waits = round0_waits(run)
        out = res["metrics"]["output_tokens_per_s"]["value"] / rate
        keeps_up = per_rate is None or out >= 0.85 * per_rate
        per_rate = out
        print("[sweep] " + json.dumps({
            "rate": rate, "output_per_rate": out,
            "sustained": sustained(run, res["failed"]) and keeps_up,
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "round0_waits": [[round(t, 2), round(w, 3)] for t, w in waits]}),
            flush=True)
        del res, run, keep
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
