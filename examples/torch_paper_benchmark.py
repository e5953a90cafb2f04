"""Reproduce a paper operating point on the PyTorch port: Qwen3-Coder-30B x
H100, ILR-2, all six scheduling policies on the discrete-event backend
(paper testbed analogue), through ``benchmarks_torch.common``; the
counterpart of ``paper_benchmark.py``.

    PYTHONPATH=src python examples/torch_paper_benchmark.py [--rate 0.25]

``--live CELL`` serves one of ``benchmarks_torch/serving_bench.py``'s cells
on the card (random bf16 weights at full width) and prints its end-to-end
metrics beside the simulator's prediction for the same configuration: the
same sessions, the same engine settings, ``SimBackend``'s modelled H100
(``benchmarks/fig7_latency_h100.py`` is that prediction for Qwen3-Coder at
the paper's scale). ``--device cpu`` runs the live cell's ``.reduced()``
config in float32 at the bench's CPU sizes; the simulator then models the
same reduced config.
"""
import argparse
import sys

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import torch  # noqa: E402

from benchmarks_torch import serving_bench as sb  # noqa: E402
from benchmarks_torch.common import (POLICIES, fmt_row, run_point,  # noqa: E402
                                     speedup_vs_best_baseline)
from repro_torch.configs.qwen3_coder_30b import CONFIG, CONTEXT_LIMIT  # noqa: E402
from repro_torch.engine.backend import SimBackend  # noqa: E402
from repro_torch.engine.engine import Engine, run_sim  # noqa: E402
from repro_torch.models.perf_model import H100  # noqa: E402
from repro_torch.workloads.generator import generate  # noqa: E402

ROW = ("session_e2e_s", "ttft_resumed_s", "ttft_round0_s", "itl_s")


def sim_prediction(cell: sb.Cell, *, seed: int, device, policy: str) -> dict:
    """The cell's sessions and engine settings on the simulator."""
    cfg = sb.cell_config(cell, torch.device(device))
    sessions = generate(sb.workload(cell, seed), cfg, H100)
    for s in sessions:
        s.meta["ideal_modelled_s"] = s.ideal_time
    eng = Engine(sb.engine_config(cell), policy, SimBackend(cfg, H100))
    finished, horizon = run_sim(eng, sessions, max_time=2e5)
    return sb.e2e_metrics(cell, sessions, finished, horizon, eng, eng.bus,
                          [])


def live(args) -> int:
    dev = torch.device(args.device)
    cell = sb.CELLS[args.live]
    if dev.type == "cpu":
        cell = sb.cpu_cell(cell)
    res = sb.run(cell, seed=args.seed, policy="mars", device=dev)
    sb.report(res)
    sim = sim_prediction(cell, seed=args.seed, device=dev, policy="mars")
    print(f"\n{cell.name}, mars, {cell.spec['n_sessions']} sessions at "
          f"{cell.spec['arrival_rate']:g}/s: live on {res['device']} "
          f"against the simulator's H100")
    print(f"{'metric':16s} {'live median':>12s} {'sim median':>12s}")
    for name in ROW:
        print(f"{name:16s} {sb._fmt(res['e2e'][name]['median']):>12s} "
              f"{sb._fmt(sim['e2e'][name]['median']):>12s}")
    for name in ("goodput_frac", "failed_frac"):
        print(f"{name:16s} {res['e2e'][name]['value']:12.4f} "
              f"{sim['e2e'][name]['value']:12.4f}")
    print("(live goodput against the measured ideal, the simulator's "
          "against its modelled one)")
    return 0 if res["correct"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=0.25)
    ap.add_argument("--regime", default="ILR-2")
    ap.add_argument("--sessions", type=int, default=24)
    ap.add_argument("--live", choices=sorted(sb.CELLS), default=None,
                    help="serve this bench cell live instead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="--live only: cuda (full width, bf16) or cpu")
    args = ap.parse_args(argv)
    if args.live:
        return live(args)

    rows = []
    print(f"{args.regime} @ {args.rate} req/s, {args.sessions} sessions, "
          f"Qwen3-Coder-30B on H100:\n")
    print(f"{'policy':14s} {'mean':>8s} {'p90':>8s} {'p95':>8s} "
          f"{'ttft_p95':>9s} {'goodput':>9s}")
    for policy in POLICIES:
        s = run_point(CONFIG, H100, policy, args.regime, args.rate,
                      args.sessions, max_context=CONTEXT_LIMIT)
        r = fmt_row(s)
        rows.append(r)
        print(f"{policy:14s} {r['mean_s']:8.1f} {r['p90_s']:8.1f} "
              f"{r['p95_s']:8.1f} {r['ttft_p95_s']:9.2f} "
              f"{r['goodput3_req_s']:9.5f}")
    sp = speedup_vs_best_baseline(rows)
    print(f"\nMARS vs best baseline ({sp['best_baseline_policy']}): "
          f"{sp['speedup']}x mean-latency")
    return 0


if __name__ == "__main__":
    sys.exit(main())
