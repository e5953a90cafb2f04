"""A 4-rank gloo world, mesh (data 2, model 2), on the CPU: the multi-rank
half of tests/test_torch_distributed.py, run in one subprocess.

    PYTHONPATH=src python tests/_torch_world.py OUT_DIR

The ranks rendezvous through a ``FileStore`` under OUT_DIR (no network).
Rank 0 writes ``OUT_DIR/results.json`` (the measured differences) and
``OUT_DIR/ep.npz`` (the expert-parallel MoE's output and gradients with
their inputs, which the test holds against JAX's ``moe_ffn``). Every
comparison with the port's single-device path is made here, on every
rank, each rank computing the single-device side itself.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

WORLD = 4
TRAIN_ARCHS = ("llama3.2-1b", "dbrx-132b", "granite-moe-3b-a800m",
               "rwkv6-1.6b", "zamba2-1.2b", "whisper-tiny")
B, S, FRAMES = 4, 32, 16
DECODE_STEPS = 2


def no_drop(cfg):
    """Capacity for every routed entry: the expert-parallel capacity is
    per shard (as in the JAX package), so with drops the sharded and the
    single-device dispatch legitimately drop different entries."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts) / cfg.moe.top_k))


def ep_inputs(cfg, seed=1):
    """The MoE weights (init_moe's shapes and scales) and tokens, f32."""
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.num_experts
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"router": f(D, E) * D ** -0.5, "w_gate": f(E, D, F) * D ** -0.5,
         "w_up": f(E, D, F) * D ** -0.5, "w_down": f(E, F, D) * F ** -0.5}
    return p, f(4, 16, D)


def batch_of(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, -1, axis=1).copy())}
    if cfg.family == "whisper":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32))
    return batch


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))


def _leaves(tree):
    from repro_torch.distributed.checkpoint import _flatten
    return _flatten(tree)


def check_ep(mesh, out, rank):
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.layers import ParallelCtx
    from repro_torch.models.transformer import _moe_block
    cfg = no_drop(get_config("dbrx-132b").reduced())
    p, x = ep_inputs(cfg)
    pctx = ParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model",
                       ep_axis="data")
    tp = {"moe": {k: torch.from_numpy(v) for k, v in p.items()}}
    lp = sh.distribute(tp, mesh, sh.param_specs(cfg, mesh, tp))
    for leaf in lp["moe"].values():
        leaf.requires_grad_(True)
    xd = sh.distribute(torch.from_numpy(x), mesh, sh.P(("data",), None, None))
    got = _moe_block(cfg, lp, xd, pctx)
    grads = torch.autograd.grad((got ** 2).sum(), list(lp["moe"].values()))
    whole = {"out": got.full_tensor().detach().numpy()}
    for k, g in zip(lp["moe"], grads):
        whole["grad_" + k] = g.full_tensor().numpy()
    if rank == 0:
        np.savez(os.path.join(out, "ep.npz"), x=x, **p, **whole)


def _step_capturing_grads(step, *args):
    """``step(*args)`` and the (loss, grads) its ``loss_and_grads`` gave."""
    from repro_torch.distributed import steps
    seen, orig = {}, steps.loss_and_grads

    def capture(*a, **k):
        seen["out"] = orig(*a, **k)
        return seen["out"]
    steps.loss_and_grads = capture
    try:
        out = step(*args)
    finally:
        steps.loss_and_grads = orig
    return out, seen["out"]


def check_train(arch, mesh):
    """One ``build_train_step(cfg, mesh)`` step against
    ``build_train_step(cfg)`` on the same weights and batch: the loss and
    every gradient (captured from the step's ``loss_and_grads``), then
    the updated params."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import steps
    from repro_torch.models import model_zoo
    from repro_torch.train.optimizer import init_opt
    cfg = no_drop(get_config(arch).reduced())
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    batch = batch_of(cfg, 7)
    clone = lambda t: {k: clone(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.clone()
    p1 = clone(params)
    (p1, _, m1), (loss1, g1) = _step_capturing_grads(
        steps.build_train_step(cfg, remat=False), p1, init_opt(p1), batch)
    pd = steps.shard_params(cfg, mesh, clone(params))
    o2 = steps.shard_opt_state(cfg, mesh, init_opt(clone(params)))
    (p2, _, m2), (loss2, g2) = _step_capturing_grads(
        steps.build_train_step(cfg, mesh, remat=False), pd, o2, batch)
    grad = max(_rel(a, b.full_tensor())
               for (_, a), (_, b) in zip(_leaves(g1), _leaves(g2)))
    moved = max(float((a - b.full_tensor()).abs().max())
                for (_, a), (_, b) in zip(_leaves(p1), _leaves(p2)))
    return {"loss": abs(float(loss1) - float(loss2.full_tensor()))
            / abs(float(loss1)), "grad": grad,
            "step_loss": abs(float(m1["loss"]) - float(m2["loss"]))
            / abs(float(m1["loss"])), "step_params": moved,
            "sharded_leaves": sum(
                any(p.is_shard() for p in b.placements)
                for _, b in _leaves(p2))}


def _padded(cache, extra):
    """The cache with its per-position K/V grown by ``extra`` zero rows
    (dim 2 of the (L, B, S, H, D) fields), the states as they are."""
    pad = lambda t: torch.cat([t, t.new_zeros(
        t.shape[:2] + (extra,) + t.shape[3:])], dim=2)
    names = {"KVCache": ("k", "v"), "ZambaCache": ("k", "v"),
             "EncDecCache": ("self_k", "self_v")}.get(type(cache).__name__,
                                                      ())
    return dataclasses.replace(cache, **{n: pad(getattr(cache, n))
                                         for n in names})


def check_serve(arch, mesh):
    """Greedy tokens of the prefill step and of DECODE_STEPS decode steps,
    with and without the mesh."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.models import model_zoo
    cfg = no_drop(get_config(arch).reduced())
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    pd = steps.shard_params(cfg, mesh, params)
    batch = batch_of(cfg, 11)
    batch.pop("targets")
    t1, c1 = steps.build_prefill_step(cfg)(params, batch)
    t2, c2 = steps.build_prefill_step(cfg, mesh)(pd, batch)
    t2 = t2.full_tensor()
    same = [bool(torch.equal(t1, t2))]
    c1 = _padded(c1, DECODE_STEPS)
    c2 = sh.distribute(_padded(sh.gather(c2), DECODE_STEPS), mesh,
                       sh.cache_specs(cfg, mesh, B))
    d1, d2 = steps.build_decode_step(cfg), steps.build_decode_step(cfg, mesh)
    tok1, tok2 = t1, t2
    for i in range(DECODE_STEPS):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        tok1, c1 = d1(params, c1, tok1, pos)
        tok2, c2 = d2(pd, c2, tok2, pos)
        tok2 = tok2.full_tensor()
        same.append(bool(torch.equal(tok1, tok2)))
    return {"tokens_equal": same}


def check_paged(mesh):
    """One chunked prefill of a sequence, then a decode step of it beside
    an idle lane, on a paged pool split over the heads: logits with the
    mesh against without."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.models import model_zoo
    from repro_torch.models import transformer as tf
    cfg = get_config("llama3.2-1b").reduced()
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    pd = steps.shard_params(cfg, mesh, params)
    pctx = sh.make_pctx(cfg, mesh)
    P_, page, C = 6, 8, 8
    scratch = P_
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, C),
                                         dtype=np.int32))
    prefill = (toks, i32([list(range(C))]), i32([0, 1, scratch]),
               i32([0] * C), i32(list(range(C))), i32(C))
    decode = (i32([5, 9]), i32([C, 0]), i32([[0, 1, scratch],
                                           [scratch] * 3]),
              i32([C + 1, 1]), i32([1, scratch]), i32([0, 0]))
    rep = lambda t: sh.distribute(t, mesh, sh.P())
    spec = sh.P(None, None, None, "model", None)
    out = {}
    for name, p, pool in (
            ("plain", params, tf.PagedKVCache.zeros(
                cfg, P_ + 1, page, torch.float32)),
            ("mesh", pd, sh.distribute(tf.PagedKVCache.zeros(
                cfg, P_ + 1, page, torch.float32), mesh,
                tf.PagedKVCache(spec, spec)))):
        kw = {"pctx": pctx} if name == "mesh" else {}
        args = [rep(t) for t in prefill] if name == "mesh" else prefill
        lp, pool = tf.lm_prefill_paged(cfg, p, pool, *args, **kw)
        args = [rep(t) for t in decode] if name == "mesh" else decode
        ld, pool = tf.lm_decode_paged(cfg, p, pool, *args, **kw)
        out[name] = [x.full_tensor() if name == "mesh" else x
                     for x in (lp, ld[:1], pool.k)]
    return {"prefill": _rel(out["plain"][0], out["mesh"][0]),
            "decode": _rel(out["plain"][1], out["mesh"][1]),
            "pool": _rel(out["plain"][2], out["mesh"][2])}


def check_split_cache_decode(mesh):
    """gemma2-27b ``.reduced()`` (local/global windows, softcaps), one
    sequence: decode steps against a cache split on its sequence over
    'data' (the long-context layout, ``seq_shard``) on the (2, 2) mesh,
    and on its head dim over 'model' on a (1, 4) mesh (2 KV heads do not
    divide by 4); logits against the steps without a mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.models import model_zoo
    from repro_torch.models import transformer as tf
    cfg = get_config("gemma2-27b").reduced()
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        1, cfg.vocab_size, (1, S), dtype=np.int32))
    _, cache = tf.lm_prefill(cfg, params, toks)
    cache = _padded(cache, 2 * DECODE_STEPS)
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    out = {}
    for name, m, seq_shard in (("seq", mesh, True), ("head_dim", mesh14,
                                                     False)):
        c1 = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone())
        c2 = sh.distribute(cache, m, sh.cache_specs(cfg, m, 1,
                                                    seq_shard=seq_shard))
        pd = steps.shard_params(cfg, m, params)
        pctx = sh.make_pctx(cfg, m)
        tok, worst = toks[:, -1], 0.0
        for i in range(DECODE_STEPS):
            pos = torch.full((1,), S + i, dtype=torch.int32)
            l1, c1 = tf.lm_decode(cfg, params, c1, tok, pos)
            l2, c2 = tf.lm_decode(cfg, pd, c2, *(sh.distribute(
                t, m, sh.P()) for t in (tok, pos)), pctx=pctx)
            worst = max(worst, _rel(l1, l2.full_tensor()))
            tok = torch.argmax(l1, dim=-1).to(torch.int32)
        out[name] = {"logits": worst, "cache": _rel(c1.k, c2.k.full_tensor()),
                     "split": [str(p) for p in c2.k.placements]}
    return out


def check_checkpoint(mesh, out, rank):
    """Saved on the (2, 2) mesh, restored onto (data 4, model 1) and onto
    one device: every leaf bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.models import model_zoo
    cfg = get_config("llama3.2-1b").reduced()
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    d = os.path.join(out, "ckpt")
    ckpt.save(d, steps.shard_params(cfg, mesh, params), step=3)
    dist.barrier()
    mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    on41, step = ckpt.restore(d, params,
                              shardings=sh.param_shardings(cfg, mesh41,
                                                           params))
    whole, _ = ckpt.restore(d, params, device="cpu")
    exact41 = all(torch.equal(a, b.full_tensor()) for (_, a), (_, b)
                  in zip(_leaves(params), _leaves(on41)))
    exact1 = all(torch.equal(a, b) for (_, a), (_, b)
                 in zip(_leaves(params), _leaves(whole)))
    placed = all(b.device_mesh is mesh41 for _, b in _leaves(on41))
    return {"step": step, "exact_4x1": exact41, "exact_1": exact1,
            "on_4x1": placed}


def _rank(rank, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(out, "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(device_type="cpu")
        results = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        check_ep(mesh, out, rank)
        for arch in TRAIN_ARCHS:
            results["train " + arch] = check_train(arch, mesh)
            results["serve " + arch] = check_serve(arch, mesh)
        results["paged"] = check_paged(mesh)
        results["split_cache"] = check_split_cache_decode(mesh)
        results["checkpoint"] = check_checkpoint(mesh, out, rank)
        if rank == 0:
            with open(os.path.join(out, "results.json"), "w") as f:
                json.dump(results, f, indent=1)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=WORLD, join=True)
