"""Sharding rules: DP / TP / EP / SP mapping for every assigned architecture.
The port of ``repro.distributed.sharding``: the same rule table, in the
same order, over the port's param trees.

Conventions:
  * 'model' axis (TP=16): attention heads / d_ff / vocab; GQA KV tensors
    shard on kv-heads when divisible, else on head_dim.
  * 'data' (+ 'pod') axes: batch DP; for dbrx-style MoE the 'data' axis
    doubles as the EP axis (experts sharded, all-to-all dispatch).
  * long-context decode with global_batch=1 shards the KV *sequence* over
    'data' (SP).

A spec (``P``) is a tuple with one entry per leading tensor dimension: an
axis name, a tuple of axis names (major to minor) or None, as JAX's
``PartitionSpec``. ``placements`` turns one into DTensor placements for a
``DeviceMesh``. The rules read only the mesh's axis names and sizes
(``axis_names`` and a ``shape`` dict, or a ``DeviceMesh``'s
``mesh_dim_names`` and ``shape``), so a stand-in of production size needs
no devices. ``param_specs`` walks the param tree by path; unknown leaves
replicate.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParallelCtx

MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: ``P('data', None)``, ``P(('pod', 'data'), None)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh stand-in or a ``DeviceMesh``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return dict(zip(names, mesh.shape))


def _names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def make_pctx(cfg: ModelConfig, mesh) -> ParallelCtx:
    if mesh is None:
        return ParallelCtx()
    names = _names(mesh)
    dp = tuple(a for a in names if a in ("pod", "data"))
    ep = "data" if (cfg.moe is not None and cfg.moe.shard_mode == "ep"
                    and "data" in names) else None
    return ParallelCtx(mesh=mesh, dp_axes=dp, tp_axis=MODEL_AXIS, ep_axis=ep)


def _divisible(n: int, mesh, axis: str) -> bool:
    sizes = axis_sizes(mesh)
    return axis in sizes and n % sizes[axis] == 0


def placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh dimension) of ``spec`` on a
    ``DeviceMesh``: each axis named on tensor dimension ``d`` becomes
    ``Shard(d)`` on that mesh dimension; the others ``Replicate()``. A
    tuple of axes on one dimension must be in mesh order (major to minor),
    which is the order DTensor splits it in."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        idx = [names.index(a) for a in (ax if isinstance(ax, tuple)
                                        else (ax,))]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {ax} are not in mesh "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


# --- per-leaf rules ---------------------------------------------------------

def _sanitize(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop shardings whose dimension doesn't divide by the axis size."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(ax if dim % size == 0 else None)
    return P(*out)


def _rule(cfg: ModelConfig, mesh, path: Tuple[str, ...], ndim: int,
          shape: Tuple[int, ...]) -> P:
    name = path[-1]
    joined = "/".join(path)
    sizes = axis_sizes(mesh)
    ep = cfg.moe is not None and cfg.moe.shard_mode == "ep" \
        and "data" in sizes and cfg.moe.num_experts % sizes["data"] == 0
    E_AX = "data" if ep else None
    tp = sizes.get(MODEL_AXIS, 1)

    def pad(spec: Tuple) -> P:
        """Left-pad with None for stacked-layer leading dims."""
        return P(*((None,) * (ndim - len(spec)) + spec))

    # embeddings / heads: vocab-shard when divisible, else d_model-shard
    # (whisper 51865 / granite 49155 vocabs don't divide by 16)
    if name == "embed":
        return pad((MODEL_AXIS, None)) if cfg.vocab_size % tp == 0 \
            else pad((None, MODEL_AXIS))
    if name == "lm_head":
        return pad((None, MODEL_AXIS)) if cfg.vocab_size % tp == 0 \
            else pad((MODEL_AXIS, None))
    if name == "dec_pos":
        return pad((None, None))
    # attention
    if name in ("wq", "wk", "wv") and "attn" in joined:
        return pad((None, MODEL_AXIS))
    if name == "wo" and "attn" in joined:
        return pad((MODEL_AXIS, None))
    if name in ("bq", "bk", "bv"):
        return pad((MODEL_AXIS,))
    # dense MLP
    if name in ("w_gate", "w_up") and "moe" not in joined:
        return pad((None, MODEL_AXIS))
    if name == "w_down" and "moe" not in joined:
        return pad((MODEL_AXIS, None))
    # MoE experts
    if name == "router":
        return pad((None, None))
    # perf-iteration toggle: fine-grained tiny experts (granite, d_ff=512
    # -> 32/shard under TP) pay a per-layer (E,C,D) sum that dominates the
    # collective term; replicating them removes it at a modest
    # weight-memory cost.
    moe_replicated = cfg.moe is not None and cfg.moe.shard_mode == "tp" and \
        "moe_replicated" in os.environ.get("REPRO_OPT", "")
    if name in ("w_gate", "w_up") and "moe" in joined:
        return pad((E_AX, None, None if moe_replicated else MODEL_AXIS))
    if name == "w_down" and "moe" in joined:
        return pad((E_AX, None if moe_replicated else MODEL_AXIS, None))
    # RWKV time/channel mix
    if name in ("wr", "wk", "wv", "wg", "cm_wk", "cm_wr"):
        return pad((None, MODEL_AXIS))
    if name in ("wo", "cm_wv") and cfg.family == "rwkv6":
        return pad((MODEL_AXIS, None))
    # Mamba2
    if name in ("w_z", "w_x"):
        return pad((None, MODEL_AXIS))
    if name in ("conv_x_w",):
        return pad((MODEL_AXIS, None))
    if name in ("conv_x_b", "gn_scale"):
        return pad((MODEL_AXIS,))
    if name == "w_out" and cfg.family == "zamba2":
        return pad((MODEL_AXIS, None))
    # zamba shared-block input projection
    if name == "in_proj":
        return pad((None, None))
    return P(*((None,) * ndim))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict of leaves (anything with a
    ``shape``), keeping its nesting."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, mesh, params_or_specs) -> Any:
    """Tree of ``P`` matching the params tree (tensors or ``TensorSpec``s)."""

    def spec_of(path, leaf) -> P:
        shape = tuple(leaf.shape)
        spec = _rule(cfg, mesh, path, len(shape), shape)
        return _sanitize(spec, shape, mesh)

    return _map_with_path(spec_of, params_or_specs)


def param_shardings(cfg: ModelConfig, mesh, params_or_specs) -> Any:
    return _map_with_path(lambda _, s: NamedSharding(mesh, s),
                          param_specs(cfg, mesh, params_or_specs))


def opt_moment_spec(pspec: P, shape: Tuple[int, ...], mesh) -> P:
    """ZeRO-1-style distributed optimizer: Adam moments additionally shard
    their largest dim over 'data' (f32 moments are 4x the bf16 params).
    The update stays elementwise; the params are gathered back after the
    step."""
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        return pspec
    used = set()
    for ax in pspec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                used.add(a)
    if "data" in used:               # EP weights already consume the data axis
        return pspec
    dsize = sizes["data"]
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    best, best_dim = -1, None
    for i, (dim, ax) in enumerate(zip(shape, spec)):
        if ax is None and dim % dsize == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim is not None and best >= dsize:
        spec[best_dim] = "data"
    return P(*spec)


# --- activation / cache specs ------------------------------------------------

def batch_spec(mesh) -> P:
    dp = tuple(a for a in _names(mesh) if a in ("pod", "data"))
    return P(dp, None)


def kv_head_axis(cfg: ModelConfig, mesh) -> Tuple[Optional[str], Optional[str]]:
    """(spec axis for kv-heads dim, spec axis for head_dim dim)."""
    if _divisible(cfg.n_kv_heads, mesh, MODEL_AXIS):
        return MODEL_AXIS, None
    if _divisible(cfg.head_dim_, mesh, MODEL_AXIS):
        return None, MODEL_AXIS
    return None, None


def cache_specs(cfg: ModelConfig, mesh, batch: int, *,
                seq_shard: bool = False) -> Any:
    """``P`` tree matching ``model_zoo.cache_specs``' structure.

    ``seq_shard=True`` (long-context, batch=1): shard the KV sequence over
    'data' (SP) instead of the batch.
    """
    h_ax, d_ax = kv_head_axis(cfg, mesh)
    dp = tuple(a for a in _names(mesh) if a in ("pod", "data"))
    b_ax: Any = dp if not seq_shard and batch % _dp_size(mesh) == 0 else None
    s_ax = "data" if seq_shard else None
    kv = P(None, b_ax, s_ax, h_ax, d_ax)
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import KVCache
        return KVCache(kv, kv)
    if cfg.family == "whisper":
        from repro_torch.models.whisper import EncDecCache
        return EncDecCache(kv, kv, kv, kv)
    if cfg.family == "rwkv6":
        from repro_torch.models.rwkv6 import RWKVState
        hx = MODEL_AXIS if _divisible(cfg.d_model // cfg.rwkv.head_size, mesh,
                                      MODEL_AXIS) else None
        return RWKVState(P(None, b_ax, None), P(None, b_ax, None),
                         P(None, b_ax, hx, None, None))
    if cfg.family == "zamba2":
        from repro_torch.models.mamba2 import MambaState
        from repro_torch.models.zamba2 import ZambaCache
        hm = MODEL_AXIS if _divisible(cfg.ssm.n_heads(cfg.d_model), mesh,
                                      MODEL_AXIS) else None
        mamba = MambaState(P(None, b_ax, None, None),
                           P(None, b_ax, hm, None, None))
        return ZambaCache(mamba, kv, kv)
    raise ValueError(cfg.family)


def _dp_size(mesh) -> int:
    n = 1
    for a, size in axis_sizes(mesh).items():
        if a in ("pod", "data"):
            n *= size
    return n


# --- placing tensors on a mesh ----------------------------------------------

def distribute(tree, mesh, specs):
    """Every tensor leaf of ``tree`` (a nested dict, a cache dataclass or
    a NamedTuple) as a DTensor with the placements of the matching ``P``
    in ``specs`` (a tree of the same structure). Each rank's local shard
    is cut from rank 0's tensor (``distribute_tensor``)."""
    from torch.distributed.tensor import distribute_tensor
    return _zip_map(lambda t, s: distribute_tensor(t, mesh,
                                                   placements(mesh, s)),
                    tree, specs)


def zeros(tree, mesh, specs):
    """DTensor zeros with the shapes and dtypes of ``tree``'s tensor
    leaves and the placements of ``specs`` (no communication: every rank
    makes its own shard)."""
    from torch.distributed.tensor import zeros as dzeros
    return _zip_map(lambda t, s: dzeros(tuple(t.shape), dtype=t.dtype,
                                        device_mesh=mesh,
                                        placements=placements(mesh, s)),
                    tree, specs)


def _zip_map(fn, tree, specs):
    if isinstance(specs, P) or specs is None:
        return fn(tree, specs or P())
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _zip_map(fn, getattr(tree, f.name),
                                              getattr(specs, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return _tuple_like(tree, [_zip_map(fn, t, s)
                                  for t, s in zip(tree, specs)])
    raise TypeError(f"no spec tree for {type(tree).__name__}")


def spec_of(t) -> P:
    """The ``P`` of a DTensor's placements."""
    names = t.device_mesh.mesh_dim_names
    dims = [[] for _ in range(t.dim())]
    for name, pl in zip(names, t.placements):
        if pl.is_shard():
            dims[pl.dim].append(name)
    return P(*(None if not d else d[0] if len(d) == 1 else tuple(d)
               for d in dims))


def shardings_of(tree):
    """``NamedSharding`` of every DTensor leaf, None for other leaves, in
    ``tree``'s structure (the ``shardings`` of a checkpoint restore onto
    the same placements)."""
    if isinstance(tree, DTensor):
        return NamedSharding(tree.device_mesh, spec_of(tree))
    if isinstance(tree, dict):
        return {k: shardings_of(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: shardings_of(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return _tuple_like(tree, [shardings_of(t) for t in tree])
    return None


def gather(tree):
    """Every DTensor leaf of ``tree`` as its whole tensor on every rank
    (``full_tensor``); other leaves as they are."""
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: gather(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return _tuple_like(tree, [gather(t) for t in tree])
    return tree


def _tuple_like(tree, items):
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
