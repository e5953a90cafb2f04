"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step once on
a fake world. The port of ``repro.launch.dryrun``.

MUST be the process entry point: it initialises the ``fake`` process
group (``torch.testing``'s ``FakeStore``) at the mesh's world size, and a
process group is process-wide. For each cell it builds the step with
sharded stand-ins (``distributed.steps.build_cell``: DTensors whose local
shards are fake tensors) on the production mesh, runs it once under
``FakeTensorMode`` (a train step: forward, backward and ``adamw_update``)
and records, for one device (rank 0's shard):

  flops          operations of every local op the step runs, from
                 ``torch.utils.flop_counter``'s formulas (matmuls and
                 attention products; elementwise ops count 0), each op
                 counted once, on its local shapes
  bytes_accessed the bytes of every local op's tensor inputs and outputs,
                 views excluded: eager ops are unfused, so each
                 intermediate is counted where it is written and where it
                 is read (XLA counts after fusion)
  argument_size_in_bytes / output_size_in_bytes
                 the local shards of the step's inputs / outputs
  temp_size_in_bytes
                 the peak of live bytes in storages the step allocates
                 (fake storages, freed when their last tensor dies)
  collectives    bytes by kind under the reference's five keys plus
                 ``total``, each collective counted by its OUTPUT shape
                 (the reference's ``collective_bytes``), recorded from the
                 ``_c10d_functional`` and ``c10d`` ops

It launches nothing: on fake CPU tensors the kernel wrappers trace their
plain versions, as the reference's dry run on host devices takes its jnp
path; the record says ``"device": "fake-cpu"``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b \\
        --shape train_4k [--multi-pod] [--out report.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import ARCH_IDS, cell_is_supported, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed.steps import build_cell
from repro_torch.launch.mesh import make_production_mesh

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# op names of the functional collectives and of the c10d ops, by kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    if isinstance(x, dict):
        return [t for a in x.values() for t in _tensors(a)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CellCounter(TorchDispatchMode):
    """Counts the local ops a traced step runs: flops, bytes accessed,
    collective bytes by kind (output shapes) and the peak of live bytes
    the step allocates. DTensor-level ops are passed down (NotImplemented)
    so that each is counted once, as the local ops DTensor runs. DTensor's
    sharding propagation runs each new op once more on global-shape fake
    tensors, under the same fake mode: ``paused()`` wraps it
    (``_propagating``) and nothing is counted inside."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _free(self, key: int, n: int) -> None:
        if self._seen.pop(key, None) is not None:
            self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:                            # sharding propagation
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _KIND.get(name)
            if kind is not None:
                self.coll[kind] += sum(_nbytes(t) for t in _tensors(out))
            self._track(out)
            return out
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors(args) + _tensors(kwargs)
                + _tensors(out))
        self._track(out)
        return out

    def collective_bytes(self) -> Dict[str, float]:
        out = dict(self.coll)
        out["total"] = sum(out[k] for k in _COLLECTIVES)
        return out


@contextlib.contextmanager
def _propagating(counter: CellCounter):
    """Pause ``counter`` inside DTensor's tensor-meta propagation."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def wrapped(self, *a, **k):
        with counter.paused():
            return orig(self, *a, **k)
    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def collective_bytes(counter: CellCounter) -> Dict[str, float]:
    """Per-device bytes moved by each collective kind, by output shape."""
    return counter.collective_bytes()


def _local_bytes(tree) -> int:
    """Bytes of the local shards (DTensors) or tensors of a tree, each
    storage once."""
    seen, total = set(), 0
    for t in _tensors(_leaves(tree)):
        t = t._local_tensor if isinstance(t, DTensor) else t
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _leaves(tree):
    import dataclasses
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def init_fake_world(world_size: int) -> None:
    """The fake process group of ``world_size`` ranks, this process rank 0
    (once per process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, verbose: bool = True, cfg=None) -> Dict:
    """Trace one cell on ``mesh`` (the production mesh by default) and
    return its record. ``cfg`` replaces the registry's config of ``arch``
    (the roofline probe's reduced depths)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape_name]
    ok, why = cell_is_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    if mesh is None:
        init_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    names = mesh.mesh_dim_names
    rec: Dict = {"arch": arch, "shape": shape_name, "device": "fake-cpu",
                 "mesh": dict(zip(names, [int(s) for s in mesh.shape])),
                 "n_devices": int(mesh.size())}
    try:
        with FakeTensorMode():
            fn, args = build_cell(cfg, spec, mesh)
            rec["argument_size_in_bytes"] = _local_bytes(args)
            counter = CellCounter()
            with _propagating(counter), counter:
                out = fn(*args)
            rec["output_size_in_bytes"] = _local_bytes(out)
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["temp_size_in_bytes"] = int(counter.peak)
        rec["flops"] = float(counter.flops)
        rec["bytes_accessed"] = float(counter.bytes_accessed)
        rec["collectives"] = counter.collective_bytes()
        rec["status"] = "ok"
    except Exception as e:                         # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if verbose:
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (f" flops={rec['flops']:.3e}"
                     f" argB={rec['argument_size_in_bytes']:.3e}"
                     f" tmpB={rec['temp_size_in_bytes']:.3e}"
                     f" collB={rec['collectives']['total']:.3e}"
                     f" trace={rec['trace_s']}s")
        elif status == "error":
            extra = " " + rec["error"][:200]
        print(f"[dryrun] {arch} x {shape_name} "
              f"{'multi-pod' if multi_pod else 'single-pod'}: {status}{extra}",
              flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    init_fake_world(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    print(f"[dryrun] mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"({mesh.size()} ranks, backend=fake)", flush=True)
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    records = [run_cell(a, s, multi_pod=args.multi_pod, mesh=mesh)
               for a, s in cells]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    n_err = sum(1 for r in records if r["status"] == "error")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
