"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, exactly, on full-size shapes.

For all 10 architectures, on mesh stand-ins of production size (data 16,
model 16) and (pod 2, data 16, model 16) that carry only axis names and
sizes: ``param_specs`` leaf by leaf (the port's param shapes from
``model_zoo.init`` under ``FakeTensorMode``, JAX's from ``eval_shape``),
``opt_moment_spec`` of every leaf, the per-device bytes of the bf16
params and the f32 moments, ``cache_specs`` at a batch that the data axes
divide and one they do not (and with ``seq_shard``), ``batch_spec``,
``kv_head_axis`` and ``make_pctx``. The ``moe_replicated`` toggle on
granite-moe-3b-a800m with ``REPRO_OPT`` set for both packages. Then the
spec-to-placements mapping, tuple axes included. JAX's
``PartitionSpec`` writes a one-axis tuple as the axis; specs are compared
after that normalisation.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.models import model_zoo as jzoo
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import model_zoo

MESHES = {"single-pod": {"data": 16, "model": 16},
          "multi-pod": {"pod": 2, "data": 16, "model": 16}}


class _FakeMesh:
    """Shape/axis-name stand-in so spec rules can be checked without
    devices (tests/test_distributed.py's)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


class _Names:
    """What ``placements`` reads of a ``DeviceMesh``: its dimension names."""

    def __init__(self, *names):
        self.mesh_dim_names = names


def _norm(spec):
    out = []
    for ax in tuple(spec):
        if isinstance(ax, tuple):
            ax = None if not ax else ax[0] if len(ax) == 1 else ax
        out.append(ax)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """{path: shape} of the port's and of JAX's full-size params."""
    with FakeTensorMode():
        tparams = model_zoo.init(get_config(arch), 0, torch.bfloat16,
                                 device="cpu")
    jparams = jax.eval_shape(
        lambda k: jzoo.init(jget_config(arch), k, jnp.bfloat16),
        jax.random.PRNGKey(0))
    return tparams, jparams


def _by_path(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _by_path(sub, prefix + (str(k),)).items()}
    return {"/".join(prefix): tree}


def _jax_by_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {"/".join(k.key for k in path): leaf for path, leaf in flat}


def _specs(arch, mesh_shape):
    tparams, jparams = _shapes(arch)
    mesh = _FakeMesh(mesh_shape)
    got = _by_path(sh.param_specs(get_config(arch), mesh, tparams))
    want = _jax_by_path(jsh.param_specs(jget_config(arch), mesh, jparams))
    return got, want, _by_path(tparams), mesh


def test_the_architectures_are_the_same():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_moment_specs_match_jax(arch, mesh_name):
    got, want, shapes, mesh = _specs(arch, MESHES[mesh_name])
    assert got.keys() == want.keys()
    for path in want:
        assert _norm(got[path]) == _norm(want[path]), path
        shape = tuple(shapes[path].shape)
        assert _norm(sh.opt_moment_spec(got[path], shape, mesh)) == \
            _norm(jsh.opt_moment_spec(want[path], shape, mesh)), path


def _shards(spec, mesh):
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_device_param_and_moment_bytes_match_jax(arch, mesh_name):
    got, want, shapes, mesh = _specs(arch, MESHES[mesh_name])

    def per_device(specs, moment_spec):
        total = 0
        for path, spec in specs.items():
            shape = tuple(shapes[path].shape)
            n = int(np.prod(shape))
            total += n // _shards(spec, mesh) * 2               # bf16
            total += 2 * n // _shards(moment_spec(spec, shape, mesh), mesh) \
                * 4                                             # f32 mu, nu
        return total
    assert per_device(got, sh.opt_moment_spec) == \
        per_device(want, jsh.opt_moment_spec)


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return dict(zip(obj._fields, obj))


def _cache_equal(got, want, where=""):
    if isinstance(want, jax.sharding.PartitionSpec):
        assert _norm(got) == _norm(want), where
        return
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys(), where
    for k in w:
        _cache_equal(g[k], w[k], f"{where}.{k}")


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_and_cache_specs_match_jax(arch, mesh_name):
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = _FakeMesh(MESHES[mesh_name])
    for batch, seq_shard in ((128, False), (8, False), (1, True)):
        _cache_equal(sh.cache_specs(cfg, mesh, batch, seq_shard=seq_shard),
                     jsh.cache_specs(jcfg, mesh, batch, seq_shard=seq_shard),
                     f"{arch} batch {batch}")
    assert _norm(sh.batch_spec(mesh)) == _norm(jsh.batch_spec(mesh))
    assert sh.kv_head_axis(cfg, mesh) == jsh.kv_head_axis(jcfg, mesh)
    assert sh._dp_size(mesh) == jsh._dp_size(mesh)
    got, want = sh.make_pctx(cfg, mesh), jsh.make_pctx(jcfg, mesh)
    assert (got.dp_axes, got.tp_axis, got.ep_axis, got.sp_axis, got.dp_spec) \
        == (want.dp_axes, want.tp_axis, want.ep_axis, want.sp_axis,
            want.dp_spec)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_moe_replicated_toggle_matches_jax(mesh_name, monkeypatch):
    monkeypatch.setenv("REPRO_OPT", "moe_replicated")
    got, want, _, _ = _specs("granite-moe-3b-a800m", MESHES[mesh_name])
    moe = [p for p in want if "/moe/w_" in p]
    assert moe
    for path in want:
        assert _norm(got[path]) == _norm(want[path]), path
    for path in moe:                 # the experts whole on every rank
        assert "model" not in _norm(got[path]), path


def test_placements_of_specs():
    mesh = _Names("pod", "data", "model")
    P = sh.P
    assert sh.placements(mesh, P()) == (Replicate(),) * 3
    assert sh.placements(mesh, P(None, "model")) == \
        (Replicate(), Replicate(), Shard(1))
    assert sh.placements(mesh, P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(mesh, P("data", None, None, "model")) == \
        (Replicate(), Shard(0), Shard(3))
    assert sh.placements(mesh, P(None, ("data", "model"))) == \
        (Replicate(), Shard(1), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements(mesh, P(("data", "pod"), None))
    assert sh.placements(_Names("data", "model"), P((), None)) == \
        (Replicate(), Replicate())
