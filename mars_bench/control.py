"""The readings a cell's check limits are set from, in one process on
one card: each gap statistic of the program over many seeds (the lower
reading is its largest) and of the fp8 control over a few (the upper
reading is its smallest), each over the streams a short window of the
cell's own traffic served.

    python3 mars_bench/control.py --workload <cell> --seconds 20 \\
        --seeds 11,12,13,... --control-seeds 11,12,13

The control is the reference put in the program's place in the nearest
precision below the configuration's bf16 (``reference.py``,
``precision="fp8"``). At each served position it reads the gap, on the
float32 reference, of the token the control puts first.
"""
import argparse
import gc
import json
import os
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
from mars_bench import run as _run  # noqa: E402,F401  (paths and caches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    from mars_bench import bench
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ctrl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    prog, ctrl = [], []
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = bench.run_cell(args.workload, seed, args.seconds, False,
                             t_start=time.monotonic(),
                             control=seed in ctrl_seeds,
                             say=lambda m: print(m, flush=True))
        prog.append(res["_gaps"])
        line = {"seed": seed, "correct": res["correct"],
                "tokens": res["checks"]["tokens_compared"]["value"],
                "program": res["_gaps"]}
        if "_control" in res:
            ctrl.append(res["_control"])
            line["control"] = res["_control"]
            line["control_correct"] = res["_control_correct"]
        print("[control] " + json.dumps(line), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload}
    for k in prog[0]:
        summary[k] = {"lower_reading": max(p[k] for p in prog),
                      "upper_reading": (min(c[k] for c in ctrl)
                                        if ctrl else None)}
    print("[control] " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
