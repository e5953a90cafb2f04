"""Fleet serving on the PyTorch port: the cluster router (paper §7 scale-out
path) in front of live ``TorchBackend`` replicas, with a crash mid-run and
recovery on the survivors; the counterpart of ``cluster_serving.py``, whose
replicas are simulated.

    PYTHONPATH=src python examples/torch_cluster_serving.py [--replicas 2]
    PYTHONPATH=src python examples/torch_cluster_serving.py --device cpu

Each replica is an ``Engine`` over its own ``TorchBackend`` (its own page
pool, the weights shared) and real tool threads; ``run_cluster_live``
ticks them on the wall clock and heartbeats the router with each one's
radix digest. ``--kill`` replicas stop ticking and heartbeating a third
of the way through the arrivals; the router fails them after the
heartbeat timeout and re-places their sessions, which recompute their
context on a survivor. On the card the replicas serve ``llama3.2-1b`` at
its published width in bf16; ``--device cpu`` serves its ``.reduced()``
config in float32. Without a card and without ``--device cpu`` it raises.

``--trace OUT.json`` attaches one critical-path tracer per replica and
writes a multi-process Perfetto trace at exit, plus the fleet-wide
per-session latency-breakdown table.
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.events import EventBus  # noqa: E402
from repro_torch.core.goodput import LatencyStats  # noqa: E402
from repro_torch.distributed.router import ClusterRouter, RouterConfig  # noqa: E402
from repro_torch.engine.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.engine.tools import RealToolExecutor  # noqa: E402
from repro_torch.engine.torch_runner import TorchBackend  # noqa: E402
from repro_torch.launch.serve import run_cluster_live  # noqa: E402
from repro_torch.models.perf_model import H100  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402
from repro_torch.obs import DetectorSuite, HealthReport  # noqa: E402
from repro_torch.workloads.generator import WorkloadSpec, generate  # noqa: E402

PAGE = 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--kill", type=int, default=1,
                    help="replicas to fail mid-run")
    ap.add_argument("--families", type=int, default=2,
                    help="shared-prefix session families (0 = independent)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="write a per-replica Perfetto trace and print the "
                         "fleet critical-path breakdown at exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda: full width, bf16; cpu: .reduced(), float32")
    args = ap.parse_args(argv)
    if not 0 <= args.kill < args.replicas:
        raise ValueError("--kill must leave at least one replica")

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    on_card = dev.type == "cuda"
    cfg = get_config("llama3.2-1b")
    if not on_card:
        cfg = cfg.reduced()
    dtype = torch.bfloat16 if on_card else torch.float32
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dtype,
                     dev)
    # the generator's prompts are at least 2,000 tokens; each replica's
    # pool holds four such sessions
    pages = 384
    spec = WorkloadSpec(regime="ILR-1", arrival_rate=args.rate,
                        n_sessions=args.sessions, seed=0,
                        max_context=4096 if on_card else 2048,
                        rounds_lo=2, rounds_hi=3, decode_mean=24,
                        tool_time_scale=0.02 if on_card else 0.002,
                        n_families=args.families, chunk_tokens=PAGE)
    sessions = generate(spec, cfg, H100)

    router = ClusterRouter(RouterConfig(heartbeat_timeout=2.0,
                                        straggler_penalty_cap=0.25))
    engines, tools, backends, detectors, tracers = {}, [], [], {}, {}
    try:
        for i in range(args.replicas):
            rid = f"replica-{i}"
            backend = TorchBackend(cfg, params=params, total_pages=pages,
                                   page_size=PAGE, device=dev, dtype=dtype)
            backends.append(backend)
            bus = EventBus()
            tools.append(RealToolExecutor(cpu_slots=4, bus=bus))
            engines[rid] = Engine(
                EngineConfig(total_kv_blocks=pages, block_size=PAGE,
                             token_budget=512, max_decode_batch=8,
                             cpu_slots=4),
                "mars", backend, bus=bus, tool_exec=tools[-1])
            router.register(rid, engines[rid], now=0.0)
            # per-replica incident detectors feed the fleet health rollup
            detectors[rid] = DetectorSuite.install(engines[rid])
            if args.trace:
                from repro_torch.obs import Tracer
                tracers[rid] = Tracer.install(engines[rid])
        dead = sorted(engines)[-args.kill:] if args.kill else []
        kill_at = sessions[len(sessions) // 3].arrival_time

        def crash(now):                          # mid-run failure injection
            if dead and dead[0] in engines and now >= kill_at:
                print(f"[t={now:.1f}s] killing {dead}")
                for rid in dead:
                    del engines[rid]             # no more ticks or beats

        finished, wall = run_cluster_live(router, engines, sessions,
                                          timeout=600, on_round=crash)
    finally:
        for t in tools:
            t.shutdown()
        for backend in backends:
            backend.close()

    lat = LatencyStats.of([s.e2e_latency for s in finished])
    fails = sum(1 for e in router.events if e["ev"] == "failed")
    prefix = router.cluster_prefix_stats()
    print(f"\nfleet: {args.replicas} replicas ({args.kill} failed mid-run), "
          f"{len(finished)}/{args.sessions} sessions completed in "
          f"{wall:.1f}s")
    print(f"latency mean {lat.mean:.2f}s p95 {lat.p95:.2f}s; router events: "
          f"{fails} failures detected")
    print(f"cluster prefix reuse: hit rate "
          f"{prefix['cluster_prefix_hit_rate']:.2f} over "
          f"{prefix['cluster_prefix_queries']} sessions, "
          f"{prefix['cluster_indexed_blocks']} indexed blocks across "
          f"{len(prefix['replicas'])} advertising replicas")
    print()
    print(HealthReport.collect(router, detectors=detectors).render())
    if args.trace:
        from repro_torch.obs import breakdown_table, export_perfetto
        export_perfetto(tracers, args.trace)
        rows = [tr.critical_path(sid)
                for rid, tr in sorted(tracers.items())
                for sid in tr.finished_sids()]
        rows = [r for r in rows if r]
        rows.sort(key=lambda r: -r["e2e"])
        print("\nfleet critical-path breakdown (slowest sessions first):")
        print(breakdown_table(rows))
        print(f"Perfetto trace written to {args.trace} "
              f"({len(tracers)} replica process tracks; "
              f"open at ui.perfetto.dev)")


if __name__ == "__main__":
    main()
