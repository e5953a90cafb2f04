"""OpenHands-style agent loop on the live MARS engine of the PyTorch port
(``TorchBackend``; the counterpart of ``agentic_serving.py``): each session
is an agent task whose tool callables REALLY run (sandboxed workspace: file
edits, command execution, a task tracker) while the engine schedules LLM
rounds.

    PYTHONPATH=src python examples/torch_agentic_serving.py [--disk-tier]
    PYTHONPATH=src python examples/torch_agentic_serving.py --device cpu

On the card it serves ``qwen2.5-3b`` at its published width in bf16;
``--device cpu`` serves its ``.reduced()`` config in float32 with the
kernels' plain versions. Without a card and without ``--device cpu`` it
raises.

``--disk-tier`` enables the NVMe cold tier with a real-file spool: every
tool yield parks its KV through the staged host->disk path (forced, so the
tiny demo contexts exercise it) and restores promote back through host
DRAM. Either way the per-tier occupancy / hit-rate breakdown prints at
exit.

``--trace OUT.json`` attaches the critical-path tracer (repro_torch.obs) and
writes a Perfetto trace at exit (open at ui.perfetto.dev), plus prints the
per-session latency-breakdown table.

``--cpu-cores N`` sizes the shared host-CPU pool (default 2) that the
real tool threads and the swap/spool staging paths all lease from; the
pool's occupancy / queue-wait breakdown prints at exit.
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.events import EventBus  # noqa: E402
from repro_torch.core.session import Round, make_session  # noqa: E402
from repro_torch.engine.engine import Engine, EngineConfig, run_live  # noqa: E402
from repro_torch.engine.tools import RealToolExecutor  # noqa: E402
from repro_torch.engine.torch_runner import TorchBackend  # noqa: E402


class Workspace:
    """Per-session sandbox (private runtime dir + guarded tools)."""

    def __init__(self, sid: int, root: str):
        self.dir = os.path.join(root, f"session_{sid}")
        os.makedirs(self.dir, exist_ok=True)
        self.tracker = []

    def _guard(self, path: str) -> str:
        full = os.path.realpath(os.path.join(self.dir, path))
        if not full.startswith(os.path.realpath(self.dir)):
            raise ValueError(f"fs escape: {path}")
        return full

    def file_editor(self, path: str, content: str):
        with open(self._guard(path), "w") as f:
            f.write(content)

    def terminal(self, cmd: list):
        return subprocess.run(cmd, cwd=self.dir, capture_output=True,
                              timeout=10, text=True).stdout

    def task_tracker(self, note: str):
        self.tracker.append(note)


def _print_tier_breakdown(engine):
    stats = engine.telem.kv_tier_stats()
    for tier in ("host", "disk"):
        t = stats.get(tier)
        if t is None:
            print(f"  {tier} tier: (off)")
            continue
        print(f"  {tier} tier: {t['used_blocks']}/{t['capacity_blocks']} "
              f"blocks ({t['occupancy']:.0%}), stores={t['stores']} "
              f"hit_rate={t['hit_rate']:.2f}")
    print(f"  demotions={stats['demotions']} "
          f"staged_restores={stats['staged_restores']} "
          f"direct_to_disk={stats['direct_to_disk']}")


def _print_cpu_pool(engine):
    stats = engine.cpu_pool.stats()
    leases = ", ".join(f"{k}={n}" for k, n in
                       sorted(stats["n_leases"].items())) or "none"
    busy = sum(stats["busy_s"].values())
    print(f"  {stats['cores']} cores, leases: {leases}")
    print(f"  busy={busy:.2f}s queue_wait={stats['queue_wait_total_s']:.2f}s "
          f"max_backlog={stats['max_backlog']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--disk-tier", action="store_true",
                    help="enable the NVMe cold tier (real-file spool) and "
                         "force the staged offload path at tool yields")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="write a Perfetto trace and print the per-session "
                         "critical-path breakdown at exit")
    ap.add_argument("--cpu-cores", type=int, default=2, metavar="N",
                    help="shared host-CPU pool size: tool threads and "
                         "swap/spool staging all lease from it (default 2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: full width, bf16; cpu: .reduced(), float32")
    args = ap.parse_args(argv)

    on_card = torch.device(args.device).type == "cuda"
    cfg = get_config("qwen2.5-3b")
    if not on_card:
        cfg = cfg.reduced()
    spool = tempfile.mkdtemp(prefix="mars_spool_") if args.disk_tier else None
    backend = TorchBackend(cfg, max_slots=4, max_len=512, disk_spool=spool,
                           device=args.device,
                           dtype=torch.bfloat16 if on_card else torch.float32)
    bus = EventBus()
    tools = RealToolExecutor(cpu_slots=args.cpu_cores, bus=bus)
    engine = Engine(
        EngineConfig(total_kv_blocks=4 * 511 // 32, token_budget=256,
                     max_decode_batch=4, decode_granularity=4,
                     cpu_slots=args.cpu_cores,
                     disk_tier_blocks=(1024 if args.disk_tier else 0)),
        "mars", backend, bus=bus, tool_exec=tools)
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer.install(engine)
    if args.disk_tier:
        # demo contexts are far below disk_min_tokens: force the staged
        # path so the run really exercises spill -> promote -> restore
        from repro_torch.core.session import KVAction
        engine.policy.on_tool_yield = \
            lambda s, now: (KVAction.OFFLOAD_DISK, 0.0)

    root = tempfile.mkdtemp(prefix="mars_agents_")
    rng = np.random.default_rng(1)
    sessions = []
    try:
        for i in range(3):
            ws = Workspace(i, root)
            rounds = [
                Round(int(rng.integers(80, 160)), 12, "file_editor", 0.0),
                Round(40, 10, "terminal", 0.0),
                Round(32, 10, "task_tracker", 0.0),
                Round(24, 8, None, 0.0),
            ]
            s = make_session(0.1 * i, rounds, ideal_time=1.0)
            # real tool callables per round (the agent's actions)
            s.meta["tool_fns"] = {
                0: lambda ws=ws, i=i: ws.file_editor(
                    "solution.py", f"def answer():\n    return {i}\n"),
                1: lambda ws=ws: ws.terminal(
                    [sys.executable, "-c", "print('tests pass')"]),
                2: lambda ws=ws: ws.task_tracker("done: wrote solution"),
            }
            s.meta["workspace"] = ws
            sessions.append(s)

        t0 = time.time()
        finished, _ = run_live(engine, sessions, timeout=180)
        print(f"agent loop: {len(finished)}/3 tasks completed in "
              f"{time.time()-t0:.1f}s")
        for s in finished:
            ws = s.meta["workspace"]
            sol = os.path.join(ws.dir, "solution.py")
            print(f"  task {s.sid}: e2e {s.e2e_latency:.2f}s, "
                  f"solution_written={os.path.exists(sol)}, "
                  f"tracker={ws.tracker}")
        print("KV tier breakdown:")
        _print_tier_breakdown(engine)
        print("CPU pool:")
        _print_cpu_pool(engine)
        if tracer is not None:
            from repro_torch.obs import breakdown_table, export_perfetto
            export_perfetto(tracer, args.trace)
            rows = [tracer.critical_path(sid)
                    for sid in tracer.finished_sids()]
            print("per-session critical-path breakdown:")
            print(breakdown_table([r for r in rows if r]))
            print(f"Perfetto trace written to {args.trace} "
                  f"(open at ui.perfetto.dev)")
    finally:
        tools.shutdown()
        backend.close()
        shutil.rmtree(root, ignore_errors=True)
        if spool is not None:
            shutil.rmtree(spool, ignore_errors=True)


if __name__ == "__main__":
    main()
