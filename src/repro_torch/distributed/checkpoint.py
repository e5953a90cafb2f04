"""Fault-tolerant checkpointing: the port of ``repro.distributed.checkpoint``.

Model/optimizer checkpoints: per-leaf ``.npy`` files + a manifest with
integrity hashes, written to a temp dir and atomically renamed (a crashed
writer never corrupts the latest checkpoint). ``save`` can run async on a
background thread (training overlaps the host write); it takes a host
copy of every leaf before it returns, so the in-place optimizer may go on
updating the params while the thread writes. On restore, leaves are put
on ``device``, or distributed to the meshes and placements of
``shardings`` (elastic restore: a checkpoint saved on one mesh comes back
on another, or on one device). A DTensor leaf is saved whole: every rank
gathers it (``full_tensor``, a collective) and rank 0 writes.

The layout is the reference's, file for file: a leaf is named by its path
with ``__`` between the parts (dict keys, tuple indices, NamedTuple field
names; dict keys sorted, as ``jax.tree_util`` flattens them), so a
checkpoint that the JAX package wrote restores here. bfloat16 leaves are
stored as the JAX package stores them: the 2 bytes of each value as a
``.npy`` of 2-byte void (numpy has no bfloat16, and the port does not
need ``ml_dtypes``), and ``"bfloat16"`` in the manifest. ``restore`` reads
a 2-byte void array as bfloat16 bits, so either package's bf16 leaves
come back bit for bit.

Engine checkpoints: agent sessions are *restartable by construction* (their
context is re-derivable), so the engine snapshot stores only session progress
+ queue state as JSON; KV is rebuilt by prefix recompute on restart.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

_SEP = "__"
_BF16_BITS = np.dtype("V2")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flattening order. None is an empty
    subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        parts = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        parts = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        parts = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(_SEP.join(prefix) or "leaf", tree)]
    return [pair for name, sub in parts
            for pair in _flatten(sub, prefix + (name,))]


def _unflatten(target, leaves):
    """A tree with ``target``'s structure whose leaves are taken in order
    from the iterator ``leaves``."""
    if target is None:
        return None
    if isinstance(target, dict):
        vals = {k: _unflatten(target[k], leaves) for k in sorted(target)}
        return {k: vals[k] for k in target}
    if _is_namedtuple(target):
        return type(target)(*(_unflatten(x, leaves) for x in target))
    if isinstance(target, (tuple, list)):
        return type(target)(_unflatten(x, leaves) for x in target)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A numpy copy of ``leaf`` that shares no memory with it (a CPU
    tensor's ``.numpy()`` would); bfloat16 as its bits in 2-byte void."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().copy().view(_BF16_BITS)
        return t.cpu().numpy().copy()
    return np.array(leaf, copy=True)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_BITS else str(arr.dtype)


def _from_host(arr: np.ndarray) -> torch.Tensor:
    # reshape: ``ascontiguousarray`` makes a 0-d leaf (the step) 1-d
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if arr.dtype == _BF16_BITS or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(path: str, tree, *, step: int = 0, async_: bool = False,
         keep: int = 3) -> Optional[threading.Thread]:
    """Write a checkpoint at ``path``/step_<step>. Returns the writer thread
    when async. Every leaf is copied to the host before this returns. In a
    process group of more than one rank every rank must call it (DTensor
    leaves are gathered) and only rank 0 writes; the others return None."""
    leaves = [(n, _to_host(leaf)) for n, leaf in _flatten(tree)]
    if dist.is_initialized() and dist.get_rank() != 0:
        return None

    def _write():
        final = os.path.join(path, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for name, arr in leaves:
            fn = os.path.join(tmp, name + ".npy")
            np.save(fn, arr)
            with open(fn, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            manifest["leaves"][name] = {
                "shape": list(arr.shape), "dtype": _dtype_name(arr),
                "sha256_16": digest}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        _gc(path, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(path: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str, target_tree, *, step: Optional[int] = None,
            device=None, shardings=None, verify: bool = True):
    """Restore into the structure of ``target_tree`` (its leaves, tensors
    or numbers, only name the structure). Every leaf comes back as a
    tensor in the dtype it was saved in, on ``device`` (the CPU by
    default). ``shardings``: an optional tree of the same structure whose
    leaves are ``sharding.NamedSharding`` (or None): those leaves are
    distributed to their mesh and placements, each rank keeping its shard
    of the saved whole (cross-mesh elastic restore). Returns (tree,
    step)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    loaded = []
    for name, _ in _flatten(target_tree):
        arr = np.load(os.path.join(d, name + ".npy"))
        if verify and list(arr.shape) != manifest["leaves"][name]["shape"]:
            raise ValueError(f"checkpoint leaf {name}: shape "
                             f"{list(arr.shape)} != manifest "
                             f"{manifest['leaves'][name]['shape']}")
        t = _from_host(arr)
        sharding = placed.get(name)
        if sharding is not None:
            from repro_torch.distributed.sharding import placements
            mesh = sharding.mesh
            t = distribute_tensor(t.to(mesh.device_type), mesh,
                                  placements(mesh, sharding.spec),
                                  src_data_rank=None)
        elif device is not None:
            t = t.to(device)
        loaded.append(t)
    return _unflatten(target_tree, iter(loaded)), step


# ---------------------------------------------------------------------------
# engine session snapshot (serving-side fault tolerance)
# ---------------------------------------------------------------------------

def snapshot_engine(engine) -> Dict:
    """Serializable progress snapshot: sessions resume via prefix recompute."""
    def sess(s):
        return {"sid": s.sid, "arrival_time": s.arrival_time,
                "cur_round": s.cur_round, "decoded": s.decoded,
                "context_len": s.context_len, "phase": s.phase.value,
                "slo_alpha": s.slo_alpha, "ideal_time": s.ideal_time,
                "service_tokens": s.service_tokens,
                "rounds": [{"new_input_tokens": r.new_input_tokens,
                            "decode_tokens": r.decode_tokens,
                            "tool_kind": r.tool_kind,
                            "tool_seconds": r.tool_seconds}
                           for r in s.rounds]}
    return {"waiting": [sess(s) for s in engine.waiting],
            "active": [sess(s) for s in engine.active],
            "finished_sids": [s.sid for s in engine.finished]}


def restore_engine(engine, snap: Dict) -> int:
    """Re-enqueue unfinished sessions (cold KV, prefix recompute); returns
    the number of recovered sessions."""
    from repro_torch.core.session import Round, Session
    n = 0
    for rec in snap["waiting"] + snap["active"]:
        rounds = [Round(**r) for r in rec["rounds"]]
        s = Session(sid=rec["sid"], arrival_time=rec["arrival_time"],
                    rounds=rounds, slo_alpha=rec["slo_alpha"],
                    ideal_time=rec["ideal_time"])
        s.cur_round = rec["cur_round"]
        # a session snapshotted mid-tool has decoded == the round's full
        # target; redo the last token (and hence the tool) on recovery —
        # agentic rounds are re-derivable, tool side effects re-run.
        s.decoded = max(0, min(rec["decoded"],
                               rounds[s.cur_round].decode_tokens - 1))
        s.service_tokens = rec["service_tokens"]
        engine.submit(s)
        n += 1
    return n
