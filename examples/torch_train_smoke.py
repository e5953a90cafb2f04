"""Train a llama-family model with checkpoint/restart on the PyTorch port
(``repro_torch.launch.train``; the counterpart of ``train_smoke.py``).

    PYTHONPATH=src python examples/torch_train_smoke.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_smoke.py --device cpu --steps 30

On the card it trains ``llama3.2-1b`` at its published width (float32,
the ``flash_attention`` kernel forward); ``--device cpu`` trains its
``.reduced()`` config with the kernels' plain versions. Without a card
and without ``--device cpu`` it raises.
"""
import argparse
import shutil
import sys
import tempfile
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda: full width; cpu: .reduced()")
    args = ap.parse_args(argv)

    reduced = torch.device(args.device).type == "cpu"
    cfg = get_config("llama3.2-1b")
    if reduced:
        cfg = cfg.reduced()
    print(f"training {cfg.name}: {cfg.param_count():,} params "
          f"({'reduced' if reduced else 'full width'})")
    ckpt_dir = tempfile.mkdtemp(prefix="mars_train_")
    t0 = time.time()
    try:
        losses, _ = train("llama3.2-1b", reduced=reduced, steps=args.steps,
                          seq_len=args.seq_len, batch=args.batch,
                          ckpt_dir=ckpt_dir, ckpt_every=50, log_every=20,
                          device=args.device)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq_len
    print(f"\n{args.steps} steps ({toks:,} tokens) in {dt:.0f}s "
          f"({toks/dt:.0f} tok/s); loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
