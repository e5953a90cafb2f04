"""Mesh construction: the port of ``repro.launch.mesh``.

Functions, not module-level state, so importing never touches the process
group. ``make_production_mesh`` keeps the reference's shapes and axis
names: single-pod (data=16, model=16) = 256 ranks; multi-pod adds a
leading pure-DP 'pod' axis (2 x 16 x 16 = 512 ranks). The sharding rules
and the tests that hold them against the JAX package are written for TP
16. Both build over the current process group (``torch.distributed``),
whose world must have the mesh's size: the dry run's fake group of 256 or
512 ranks, or a real one.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(n_devices: int = None, device_type="cpu"):
    """Small (data, model) mesh over the current process group's world
    (``n_devices`` ranks of it, all by default): model 2 where the count
    is even, else 1."""
    n = n_devices or dist.get_world_size()
    model = 2 if n % 2 == 0 and n >= 2 else 1
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
