"""The trainer: real steps under a mesh (``make_test_mesh`` over the
current process group, as the reference trainer runs under its test mesh),
with checkpoint/restart fault tolerance and the data-stream state capture
needed for exact resume. The port of ``repro.launch.train``. Without a
process group it runs in a world of one rank of its own (gloo on the CPU,
NCCL on the card; destroyed at the end): a (1, 1) mesh whose DTensors
compute what one device computes.

    # on the card: llama3.2-1b at its published width, float32
    PYTHONPATH=src python -m repro_torch.launch.train --full-width \\
        --steps 20 --seq-len 1024 --batch 4 --ckpt /tmp/ckpt [--resume]

    # on the CPU: the .reduced() config
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 50 --ckpt /tmp/ckpt [--resume]

On the card the forward runs the Hopper kernels (``flash_attention`` for
the dense, moe, zamba2 and whisper families, ``wkv6`` for rwkv6) and the
backward their autograd Functions. Whisper trains on zero frames (B, 16,
D), as in JAX, and its ``seq_len`` is at most ``max_target_len`` (448).
Without a card, ``device="cuda"`` raises.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.steps import (build_train_step, shard_opt_state,
                                           shard_params)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model_zoo
from repro_torch.train.data import DataConfig, SyntheticLMStream
from repro_torch.train.optimizer import OptConfig, init_opt


@contextlib.contextmanager
def _world(dev: torch.device):
    """The current process group, or a one-rank group of this process's
    own for the call (gloo on the CPU, NCCL on the card)."""
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def train(arch: str, *, reduced: bool = True, steps: int = 50,
          seq_len: int = 128, batch: int = 8, ckpt_dir: str = None,
          resume: bool = False, ckpt_every: int = 20, log_every: int = 10,
          dtype=torch.float32, verbose: bool = True, stop_after: int = None,
          remat: bool = False, chunked_ce: bool = False, device="cuda"):
    """Train ``arch`` for ``steps`` steps (``stop_after``: stop early, as a
    crash would) from ``model_zoo.init`` with seed 0 on the synthetic
    stream; resume from the latest checkpoint under ``ckpt_dir`` when
    ``resume``; save asynchronously every ``ckpt_every`` steps. Returns
    (losses, params), the params whole on every rank. Each logged line carries the step's wall time (to
    the loss read back), its tokens/s and, on the card, the peak device
    memory."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = model_zoo.init(cfg, 0, dtype, device=device)  # no card: raises
    dev = torch.device(device)
    with _world(dev):
        return _train(cfg, params, dev, steps=steps, seq_len=seq_len,
                      batch=batch, ckpt_dir=ckpt_dir, resume=resume,
                      ckpt_every=ckpt_every, log_every=log_every, dtype=dtype,
                      verbose=verbose, stop_after=stop_after, remat=remat,
                      chunked_ce=chunked_ce)


def _train(cfg, params, dev, *, steps, seq_len, batch, ckpt_dir, resume,
           ckpt_every, log_every, dtype, verbose, stop_after, remat,
           chunked_ce):
    mesh = make_test_mesh(device_type=dev.type)
    opt_state = shard_opt_state(cfg, mesh, init_opt(params))
    params = shard_params(cfg, mesh, params)
    data = SyntheticLMStream(DataConfig(cfg.vocab_size, seq_len, batch))
    opt = OptConfig(total_steps=steps, warmup_steps=max(1, steps // 10))
    step_fn = build_train_step(cfg, mesh, opt=opt, remat=remat,
                               chunked_ce=chunked_ce)
    start = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        target = (params, opt_state, data.state_dict())
        (params, opt_state, data_state), start = ckpt.restore(
            ckpt_dir, target, device=dev, shardings=sh.shardings_of(target))
        data.load_state_dict(data_state)
        if verbose:
            print(f"[train] resumed from step {start}")
    losses = []
    pending = None
    end = steps if stop_after is None else min(steps, stop_after)
    for step in range(start, end):
        t0 = time.perf_counter()
        toks, tgts = data.next_batch()
        batch_d = {"tokens": torch.from_numpy(toks).to(dev),
                   "targets": torch.from_numpy(tgts).to(dev)}
        if cfg.family == "whisper":   # the stub front end's frames
            batch_d["frames"] = torch.zeros(
                (toks.shape[0], 16, cfg.d_model), dtype=dtype, device=dev)
        if cfg.frontend == "image_patches":
            batch_d["embeds"] = torch.zeros(
                (toks.shape[0], cfg.n_frontend_tokens, cfg.d_model),
                dtype=dtype, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch_d)
        losses.append(float(metrics["loss"]))
        wall = time.perf_counter() - t0
        if verbose and (step % log_every == 0 or step == steps - 1):
            mem = (f" peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
                   if dev.type == "cuda" else "")
            print(f"[train] step {step:4d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{wall:.3f}s {toks.size / wall:.0f} tok/s{mem}")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(ckpt_dir,
                                (params, opt_state, data.state_dict()),
                                step=step + 1, async_=True)
    if pending is not None:
        pending.join()
    return losses, sh.gather(params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full-width", action="store_true",
                    help="train the config as published, not .reduced()")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.time()
    losses, _ = train(args.arch, reduced=not args.full_width,
                      steps=args.steps, seq_len=args.seq_len,
                      batch=args.batch, ckpt_dir=args.ckpt,
                      resume=args.resume, device=args.device)
    print(f"[train] {len(losses)} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
