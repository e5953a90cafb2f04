"""Depth-extrapolated roofline probe: the port of
``repro.launch.roofline_probe``.

It traces each (arch x shape) cell at two REDUCED depths (``dryrun.run_cell``
with the config passed in, not patched into the registry), fits the
linear-in-depth cost model

    cost(L) = fixed + L * per_layer

and extrapolates to the architecture's full depth. It emits the dry run's
record schema, so ``launch/roofline.py`` reads either. The reference needs
the probe because XLA's cost analysis counts a loop body once; the port's
trace runs every layer, so its full-depth dry run already counts them all
and the probe is a cheaper estimate of the same numbers (the tests hold
the two equal).

    PYTHONPATH=src python -m repro_torch.launch.roofline_probe --all \\
        --out probe.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Optional, Tuple

from repro_torch.configs.registry import ARCH_IDS, cell_is_supported, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import init_fake_world, run_cell
from repro_torch.launch.mesh import make_production_mesh

_FIELDS = ("flops", "bytes_accessed")


def _probe_depths(cfg) -> Tuple[int, int, int]:
    """(L1, L2, full_L) chosen so layer patterns stay representative."""
    if cfg.family == "zamba2":
        k = cfg.shared_attn_every
        return k, 2 * k, cfg.n_layers
    step = len(cfg.layer_pattern)
    return 2 * step, 4 * step, cfg.n_layers


def _with_depth(cfg, L: int):
    if cfg.family == "whisper":
        # encoder and decoder scale together
        frac = L / cfg.n_layers
        return dataclasses.replace(cfg, n_layers=L,
                                   n_enc_layers=max(1, round(cfg.n_enc_layers * frac)))
    return dataclasses.replace(cfg, n_layers=L)


def _extract(rec: Dict) -> Optional[Dict[str, float]]:
    if rec.get("status") != "ok":
        return None
    out = {f: rec.get(f, 0.0) for f in _FIELDS}
    for k, v in rec.get("collectives", {}).items():
        out[f"coll_{k}"] = v
    return out


def probe_cell(arch: str, shape_name: str, mesh, cfg=None) -> Dict:
    """The extrapolated record of one cell; ``cfg`` (default: the
    registry's) is the full-depth config."""
    cfg = cfg or get_config(arch)
    ok, why = cell_is_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    L1, L2, Lf = _probe_depths(cfg)
    costs = {}
    for L in (L1, L2):
        rec = run_cell(arch, shape_name, mesh=mesh, verbose=False,
                       cfg=_with_depth(cfg, L))
        c = _extract(rec)
        if c is None:
            rec.update({"arch": arch, "shape": shape_name, "probe_depth": L})
            return rec
        costs[L] = c
    out = {"arch": arch, "shape": shape_name, "status": "ok",
           "device": "fake-cpu", "n_devices": int(mesh.size()),
           "probe_depths": [L1, L2, Lf], "collectives": {}}
    for key in costs[L1]:
        per_layer = (costs[L2][key] - costs[L1][key]) / (L2 - L1)
        fixed = costs[L1][key] - L1 * per_layer
        val = max(0.0, fixed + Lf * per_layer)
        if key.startswith("coll_"):
            out["collectives"][key[5:]] = val
        else:
            out[key] = val
    print(f"[probe] {arch} x {shape_name}: flops={out.get('flops', 0):.3e} "
          f"bytes={out.get('bytes_accessed', 0):.3e} "
          f"coll={out['collectives'].get('total', 0):.3e}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    init_fake_world(256)
    mesh = make_production_mesh(multi_pod=False)
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    records = [probe_cell(a, s, mesh) for a, s in cells]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[probe] wrote {args.out}")
    return 1 if any(r["status"] == "error" for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
