"""Shared benchmark harness: one paper figure per module.

Each figure module exposes ``run(quick: bool) -> list[dict]`` returning CSV
rows; ``benchmarks.run`` drives them all and prints
``name,us_per_call,derived`` summaries plus per-figure tables.

All serving benchmarks run the *real* MARS/baseline scheduler code on the
discrete-event backend (H100/H200 perf model, Qwen3-Coder-30B / GPT-OSS-120B
configs) — see DESIGN.md §2: the simulator is the paper's testbed analogue.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.core.goodput import summarize
from repro_torch.engine.backend import SimBackend
from repro_torch.engine.engine import Engine, EngineConfig, run_sim
from repro_torch.models import perf_model as pm
from repro_torch.workloads.generator import WorkloadSpec, generate

POLICIES = ["fcfs", "autellix", "infercept", "continuum", "continuum-dy", "mars"]


def engine_for(cfg, hw, policy: str, *, cpu_slots: int = 32,
               mars_cfg=None) -> Engine:
    kv_budget = hw.hbm_bytes - 2.1 * cfg.param_count()
    blocks = max(1024, int(kv_budget / pm.kv_cache_bytes(cfg, 1) / 32))
    backend = SimBackend(cfg, hw)
    return Engine(EngineConfig(total_kv_blocks=blocks, block_size=32,
                               token_budget=8192, max_decode_batch=64,
                               decode_granularity=8, cpu_slots=cpu_slots),
                  policy, backend, mars_cfg=mars_cfg)


def run_point(cfg, hw, policy: str, regime: str, rate: float,
              n_sessions: int, *, seed: int = 0, max_context=None,
              cpu_slots: int = 32, mars_cfg=None, alphas=(1.0, 2.0, 3.0)):
    spec = WorkloadSpec(regime=regime, arrival_rate=rate,
                        n_sessions=n_sessions, seed=seed,
                        max_context=max_context)
    sessions = generate(spec, cfg, hw)
    eng = engine_for(cfg, hw, policy, cpu_slots=cpu_slots, mars_cfg=mars_cfg)
    t0 = time.time()
    finished, horizon = run_sim(eng, sessions, max_time=2e5)
    stats = summarize(finished, horizon, alphas)
    stats["wall_s"] = time.time() - t0
    stats["policy"] = policy
    stats["regime"] = regime
    stats["rate"] = rate
    stats["engine"] = eng
    return stats


def fmt_row(stats: Dict) -> Dict:
    lat = stats["latency"]
    return {
        "policy": stats["policy"], "regime": stats["regime"],
        "rate": stats["rate"], "n": stats["n_finished"],
        "mean_s": round(lat.mean, 1), "p90_s": round(lat.p90, 1),
        "p95_s": round(lat.p95, 1),
        "ttft_p95_s": round(stats["ttft"].p95, 2),
        "goodput3_req_s": round(stats["goodput"][3.0], 5),
        "tok_s": round(stats["token_throughput"], 1),
    }


def bench_main(run_fn, dry_help: str = "CI smoke", add_args=None) -> None:
    """Shared CLI epilogue for the standalone benchmarks: ``--dry``/
    ``--full`` mode selection, JSON-lines rows on stdout, and the
    machine-readable ``--json OUT`` file the bench-regression gate
    (scripts/check_bench.py) consumes — one place to evolve the wire
    shape, five call sites.

    ``add_args(parser)`` lets a bench register extra flags; it must return
    the list of dest names, which are forwarded to ``run_fn`` as keyword
    arguments (e.g. the obs bench's ``--trace OUT.json``)."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--dry", action="store_true", help=dry_help)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--json", metavar="OUT", default=None,
                    help="also write rows as machine-readable JSON")
    extra_names = add_args(ap) if add_args is not None else []
    args = ap.parse_args()
    extra = {k: getattr(args, k) for k in extra_names}
    rows = run_fn(quick=not args.full, dry=args.dry, **extra)
    for row in rows:
        print(json.dumps(row))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows}, f, indent=1)
            f.write("\n")


def speedup_vs_best_baseline(rows: List[Dict], metric: str = "mean_s") -> Dict:
    base = [r for r in rows if r["policy"] != "mars"]
    mars = [r for r in rows if r["policy"] == "mars"]
    if not base or not mars:
        return {}
    best = min(base, key=lambda r: r[metric])
    return {"mars": mars[0][metric], "best_baseline": best[metric],
            "best_baseline_policy": best["policy"],
            "speedup": round(best[metric] / max(mars[0][metric], 1e-9), 2)}
