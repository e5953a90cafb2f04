"""The PyTorch port's benchmark: serve one cell of ``BENCHMARK.json`` on
one card for a fixed window and print one JSON line.

    python3 mars_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The run makes its weights on the card from
``--seed``, warms the cell's shapes, serves a lead-in of the cell's own
traffic (``lead_in_s`` of its traffic file), then measures for exactly
``--seconds``, checks the outputs against the plain reference and prints,
as its last line on standard output, ``{"correct", "attempted",
"failed", "metrics", "device"[, "breakdown"], "checks"}``: the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``; ``checks`` holds every number compared beside its limit,
and the same numbers end standard error. Earlier lines give each metric's
sample count, the generator's lateness, the peak device memory and the
card's name and power limit.

It exits non-zero, and prints no result, without a CUDA device (or with
fewer than the cell asks for), without the program (``src/repro_torch``),
and when the JAX package or JAX itself has been loaded by the time the
window closes.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# every compile cache of the run inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(BUILD, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from mars_bench import bench

    cell, _cfg, _traffic = bench.cell_files(bench.load_benchmark(),
                                            args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"[run] card: {card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    res = bench.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START,
                         say=lambda m: print(m, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"loaded by the run: {bad} (the benchmark must not load "
              "JAX or the JAX package)", file=sys.stderr)
        return 3
    for key in [k for k in res if k.startswith("_")]:
        del res[key]
    for name, c in res["checks"].items():
        print(f"[check] {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"[check] correct: {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
