"""Serving driver: the MARS engine over the simulator or the PyTorch
backend.

    # simulated paper-scale serving (H100 x Qwen3-Coder-30B, ILR-1):
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \\
        --policy mars --regime ILR-1 --rate 0.2 --sessions 32

    # live engine on the GPU (reduced llama3.2-1b, real tools):
    PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \\
        --arch llama3.2-1b --policy mars --sessions 4

    # the same at the published width of the config, in bf16:
    PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \\
        --full-width

    # gemma2-27b (sliding windows, softcaps) at full width: the backend
    # takes the dense slot layout and the flash_attention kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \\
        --arch gemma2-27b --full-width

    # an MoE model (40 experts, top-8) on the paged layout
    PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \\
        --arch granite-moe-3b-a800m --full-width

``--device cpu`` runs the live engine on the CPU with the kernels' plain
versions; without it the live engine needs a CUDA card and raises when
there is none.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.events import EventBus
from repro_torch.core.goodput import summarize
from repro_torch.engine.backend import SimBackend
from repro_torch.engine.engine import Engine, EngineConfig, run_live, run_sim
from repro_torch.engine.tools import RealToolExecutor
from repro_torch.models import perf_model as pm
from repro_torch.workloads.generator import WorkloadSpec, generate


def serve_sim(*, policy: str, regime: str, rate: float, n_sessions: int,
              hw_name: str = "h100", model: str = "qwen3", seed: int = 0,
              alpha: float = 3.0, verbose: bool = True):
    if model == "qwen3":
        from repro_torch.configs.qwen3_coder_30b import (CONFIG as cfg,
                                                         CONTEXT_LIMIT)
    else:
        from repro_torch.configs.gpt_oss_120b import (CONFIG as cfg,
                                                      CONTEXT_LIMIT)
    hw = pm.HW[hw_name]
    kv_budget = hw.hbm_bytes - 2.1 * cfg.param_count()   # weights + overhead
    blocks = int(kv_budget / pm.kv_cache_bytes(cfg, 1) / 32)
    spec = WorkloadSpec(regime=regime, arrival_rate=rate,
                        n_sessions=n_sessions, seed=seed,
                        max_context=CONTEXT_LIMIT, slo_alpha=alpha)
    sessions = generate(spec, cfg, hw)
    backend = SimBackend(cfg, hw)
    eng = Engine(EngineConfig(total_kv_blocks=blocks, block_size=32,
                              token_budget=8192, max_decode_batch=64,
                              decode_granularity=8, cpu_slots=8),
                 policy, backend)
    finished, horizon = run_sim(eng, sessions, max_time=2e5)
    stats = summarize(finished, horizon)
    if verbose:
        print(f"[serve-sim] {policy} {regime} rate={rate}: "
              f"fin={stats['n_finished']}/{n_sessions} "
              f"mean={stats['latency'].mean:.1f}s "
              f"p95={stats['latency'].p95:.1f}s "
              f"goodput(a=3)={stats['goodput'][3.0]*1e3:.2f} m req/s")
    return stats, eng


def serve_live(*, arch: str, policy: str, n_sessions: int,
               device="cuda", full_width: bool = False,
               verbose: bool = True):
    """Live serving on :class:`TorchBackend`. By default the config is
    ``.reduced()`` and runs in float32, as the JAX driver does;
    ``full_width`` serves the config as published, in bf16."""
    from repro_torch.core.session import Round, make_session
    from repro_torch.engine.torch_runner import TorchBackend
    cfg = get_config(arch)
    if not full_width:
        cfg = cfg.reduced()
    dtype = torch.bfloat16 if full_width else torch.float32
    backend = TorchBackend(cfg, max_slots=max(4, n_sessions), max_len=512,
                           device=device, dtype=dtype)
    bus = EventBus()
    tools = RealToolExecutor(cpu_slots=2, bus=bus)
    try:
        eng = Engine(EngineConfig(
            total_kv_blocks=max(4, n_sessions) * 511 // 32, block_size=32,
            token_budget=256, max_decode_batch=8, decode_granularity=4,
            cpu_slots=2), policy, backend, bus=bus, tool_exec=tools)
        rng = np.random.default_rng(0)
        sessions = []
        for i in range(n_sessions):
            rounds = [Round(int(rng.integers(64, 160)), 12, "terminal", 0.2),
                      Round(32, 8, "file_editor", 0.1),
                      Round(24, 8, None, 0.0)]
            sessions.append(make_session(0.05 * i, rounds, ideal_time=1.0))
        finished, horizon = run_live(eng, sessions, timeout=180)
    finally:
        tools.shutdown()
        backend.close()
    if verbose:
        for s in finished:
            gen = len(s.meta.get("generated", []))
            print(f"[serve-live] sid={s.sid} e2e={s.e2e_latency:.2f}s "
                  f"tokens={gen} ttfts={[round(t, 3) for t in s.ttfts]}")
    return finished


def run_cluster_live(router, engines, sessions, *, timeout: float = 300.0,
                     on_round=None):
    """Wall-clock run of live engines behind a ``ClusterRouter``, as
    ``examples/cluster_serving.py`` runs simulated ones: each round places
    the sessions that have arrived (``arrival_time`` in seconds from the
    start), ticks every replica in ``engines`` ({rid: Engine}, registered
    with the router) and heartbeats it with its KV utilisation, tool
    backlog, active sessions, tick seconds and radix digest, then lets the
    router detect missed heartbeats and re-place requeued sessions.

    ``on_round(now)``, called first in every round, is the caller's fault
    hook: it may remove a replica from ``engines`` (no more ticks or
    heartbeats: the router fails it after ``heartbeat_timeout``) or make
    it ``leave`` and re-place what it returns. Ends when every session has
    arrived, every replica left in ``engines`` is done, nothing is
    requeued and the router holds no live replica outside ``engines`` (a
    removed one still owes its sessions until the router fails it). An
    idle round sleeps 5 ms, as ``run_live`` does. Returns (the finished sessions of every replica, seconds)."""
    t0 = time.monotonic()
    arrivals = sorted(sessions, key=lambda s: s.arrival_time)
    every = dict(engines)                # finished sessions stay counted
    i = 0
    while time.monotonic() - t0 < timeout:
        now = time.monotonic() - t0
        if on_round is not None:
            on_round(now)
        while i < len(arrivals) and arrivals[i].arrival_time <= now:
            router.place(arrivals[i], now=now)
            i += 1
        busy = False
        for rid, eng in list(engines.items()):
            el, progressed = eng.tick(now)
            busy |= progressed or el > 0
            router.heartbeat(rid, kv_utilization=eng.telem.kv_utilization,
                             tool_backlog=eng.tools.backlog,
                             active_sessions=len(eng.active),
                             step_latency=max(el, 1e-3),
                             radix_digest=eng.radix_digest(), now=now)
        router.check_failures(now=now)
        router.dispatch_requeued(now=now)
        if i >= len(arrivals) and not router.requeued and \
                all(e.done() for e in engines.values()) and \
                all(rid in engines for rid, r in router.replicas.items()
                    if r.alive):
            break
        if not busy:
            time.sleep(0.005)
    finished = [s for e in every.values() for s in e.finished]
    return finished, time.monotonic() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["sim", "torch"], default="sim")
    ap.add_argument("--policy", default="mars")
    ap.add_argument("--regime", default="ILR-1")
    ap.add_argument("--rate", type=float, default=0.2)
    ap.add_argument("--sessions", type=int, default=24)
    ap.add_argument("--hw", default="h100")
    ap.add_argument("--model", default="qwen3")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the config as published (bf16), not "
                         ".reduced()")
    args = ap.parse_args(argv)
    if args.backend == "sim":
        serve_sim(policy=args.policy, regime=args.regime, rate=args.rate,
                  n_sessions=args.sessions, hw_name=args.hw, model=args.model)
    else:
        serve_live(arch=args.arch, policy=args.policy,
                   n_sessions=args.sessions, device=args.device,
                   full_width=args.full_width)


if __name__ == "__main__":
    main()
