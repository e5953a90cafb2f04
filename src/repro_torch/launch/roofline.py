"""Roofline analysis: the port of ``repro.launch.roofline``, priced for the
NVIDIA H100.

Reads dry-run records (``launch/dryrun.py``; or runs the cells) and
derives the three terms per (arch x shape) on the production mesh:

    compute term    = flops_per_device / peak FLOP/s
    memory term     = bytes_accessed_per_device / HBM bandwidth
    collective term = collective_bytes_per_device / link bandwidth

The records are per device, so these are the chips-normalised formulas.
Also reports MODEL_FLOPS = 6·N·D (train) / 2·N_active·tokens (serve), the
useful-compute ratio, the dominant term and a one-line lever.

Hardware: ``perf_model.H100``'s data-sheet figures, 989 TFLOP/s (bf16,
dense), 3.35 TB/s HBM, 450 GB/s a link (NVLink). The terms are reckoned
from counts and those figures, not measured; the counts come from a trace
on fake tensors (eager ops, unfused: see ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline --report r.json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models import perf_model as pm

HW = pm.H100


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return pm.train_flops(cfg, tokens)
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return pm.flops_per_token(cfg, spec.seq_len // 2) * tokens
    # decode: one token per sequence against seq_len context
    return pm.flops_per_token(cfg, spec.seq_len) * spec.global_batch


def analyze(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    arch, shape = rec["arch"], rec["shape"]
    n_dev = rec["n_devices"]
    t_compute = rec.get("flops", 0.0) / HW.peak_flops
    t_memory = rec.get("bytes_accessed", 0.0) / HW.hbm_bw
    t_coll = rec.get("collectives", {}).get("total", 0.0) / HW.link_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch, shape)
    hlo_global = rec.get("flops", 0.0) * n_dev
    ratio = mf / hlo_global if hlo_global else float("nan")
    step_time = max(terms.values())
    useful_rate = mf / n_dev / max(step_time, 1e-12)
    frac = useful_rate / HW.peak_flops
    lever = {
        "compute": "raise MFU: larger fused matmul tiles / reduce remat "
                   "recompute / bf16 everywhere",
        "memory": "cut HBM traffic: fuse attention (flash), chunk the CE "
                  "loss, shrink logits dtype, cap local-layer KV",
        "collective": "reshard: fewer all-gathers (keep activations sharded),"
                      " overlap the sums with compute, bf16 collectives",
    }[dominant]
    return {"arch": arch, "shape": shape, "n_devices": n_dev,
            "hardware": HW.name, "reckoned": True,
            "terms_s": {k: round(v, 6) for k, v in terms.items()},
            "dominant": dominant, "model_flops": mf,
            "hlo_flops_global": hlo_global,
            "useful_ratio": round(ratio, 4),
            "roofline_fraction": round(frac, 4),
            "per_device_bytes": {
                "args": rec.get("argument_size_in_bytes"),
                "temp": rec.get("temp_size_in_bytes")},
            "lever": lever}


def table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'dom':>10s} {'useful':>7s} {'roofl%':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        t = r["terms_s"]
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} {t['compute']:10.4f} "
            f"{t['memory']:10.4f} {t['collective']:10.4f} {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.3f} {100*r['roofline_fraction']:7.2f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", default=None,
                    help="dryrun JSON report to analyze")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.report:
        with open(args.report) as f:
            records = json.load(f)
    else:
        from repro_torch.launch.dryrun import init_fake_world, run_cell
        from repro_torch.launch.mesh import make_production_mesh
        init_fake_world(256)
        mesh = make_production_mesh(multi_pod=False)
        records = [run_cell(a, s, mesh=mesh)
                   for a in ARCH_IDS for s in SHAPES]
    rows = [a for a in (analyze(r) for r in records) if a]
    print(table(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
