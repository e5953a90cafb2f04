"""Quickstart on the PyTorch port: serve a model with batched agentic
requests through the MARS engine on ``TorchBackend`` (the Hopper kernels on
the card, real tool threads); the counterpart of ``quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py              # H100
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the card it serves ``llama3.2-1b`` at its published width in bf16;
``--device cpu`` serves its ``.reduced()`` config in float32 with the
kernels' plain versions. Without a card and without ``--device cpu`` it
raises.
"""
import argparse
import sys
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: full width, bf16; cpu: .reduced(), float32")
    args = ap.parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    cfg = get_config("llama3.2-1b")
    if not on_card:
        cfg = cfg.reduced()
    dtype = torch.bfloat16 if on_card else torch.float32
    print(f"model: {cfg.name} ({cfg.param_count():,} params, "
          f"{'full width' if on_card else 'reduced'}, {dtype})")
    backend = TorchBackend(cfg, max_slots=4, max_len=512, device=args.device,
                           dtype=dtype)
    print(f"calibrated oracle: prefill {backend.prefill_rate():.0f} tok/s, "
          f"decode step {backend._decode_s_per_step*1e3:.1f} ms")

    bus = EventBus()
    tools = RealToolExecutor(cpu_slots=2, bus=bus)
    engine = Engine(
        EngineConfig(total_kv_blocks=4 * 511 // 32, block_size=32,
                     token_budget=256, max_decode_batch=4,
                     decode_granularity=4, cpu_slots=2),
        "mars", backend, bus=bus, tool_exec=tools)

    rng = np.random.default_rng(0)
    sessions = []
    for i in range(4):
        rounds = [
            Round(int(rng.integers(80, 200)), 16, "terminal", 0.3),
            Round(48, 12, "file_editor", 0.15),
            Round(32, 8, None, 0.0),
        ]
        sessions.append(make_session(0.1 * i, rounds, ideal_time=1.0))

    t0 = time.time()
    try:
        finished, _ = run_live(engine, sessions, timeout=120)
    finally:
        tools.shutdown()
        backend.close()
    print(f"\nserved {len(finished)} multi-round sessions in "
          f"{time.time()-t0:.1f}s:")
    for s in finished:
        print(f"  session {s.sid}: {len(s.rounds)} rounds, "
              f"{len(s.meta['generated'])} tokens generated, "
              f"e2e {s.e2e_latency:.2f}s, per-round TTFT "
              f"{[f'{t:.3f}s' for t in s.ttfts]}")
    warm = engine.bus.counts.get("unpin", 0)
    print(f"\nunified-info-stream event counts: "
          f"{ {k: v for k, v in sorted(engine.bus.counts.items())} }")
    print(f"warm resumptions (KV retained across tools): {warm}")


if __name__ == "__main__":
    main()
