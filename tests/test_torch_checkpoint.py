"""The port's checkpointing (``repro_torch.distributed.checkpoint``) on the
CPU, against the JAX package's where both can run.

- Round trip and garbage collection, async save and atomic publish, as
  tests/test_distributed.py checks the reference: restored leaves equal
  the saved ones bit for bit.
- An async save that is followed at once by an in-place update (what the
  port's optimizer does) still restores the values of the save.
- A checkpoint the JAX package wrote, of a float32 and of a bfloat16
  model, optimizer state and data state, restores into the port's tree
  bit for bit (leaf names, structure and bf16 bits).
- ``snapshot_engine``/``restore_engine`` over the copied ``Engine``: every
  recovered session completes, as the reference's test asks.
"""
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.distributed import checkpoint as jckpt
from repro.models import model_zoo as jzoo
from repro.train import optimizer as jopt
from repro_torch.configs.registry import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models import model_zoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as topt


@pytest.fixture
def tmpdir_():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a tensor, so equality is bit equality."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    return t.contiguous().view(view).numpy()


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip_and_gc(tmpdir_, dtype):
    cfg = get_config("llama3.2-1b").reduced()
    params = model_zoo.init(cfg, 0, dtype, device="cpu")
    for step in (1, 2, 3, 4, 5):
        ckpt.save(tmpdir_, params, step=step, keep=2)
    assert ckpt.latest_step(tmpdir_) == 5
    assert len([x for x in os.listdir(tmpdir_)
                if x.startswith("step_")]) == 2
    restored, step = ckpt.restore(tmpdir_, params)
    assert step == 5
    for a, b in zip(topt.tree_leaves(params), topt.tree_leaves(restored)):
        _same(b, a)
    assert ckpt.latest_step(os.path.join(tmpdir_, "nowhere")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(os.path.join(tmpdir_, "nowhere"), params)


def test_checkpoint_async_and_atomicity(tmpdir_):
    tree = {"a": torch.arange(8.0), "b": {"c": torch.ones((3, 3))}}
    th = ckpt.save(tmpdir_, tree, step=7, async_=True)
    th.join(timeout=60)
    assert not th.is_alive()
    got, step = ckpt.restore(tmpdir_, tree)
    assert step == 7
    _same(got["b"]["c"], torch.ones((3, 3)))
    assert not any(x.endswith(".tmp") for x in os.listdir(tmpdir_))


def test_async_save_then_in_place_update_restores_the_saved_values(tmpdir_):
    """``save`` copies every leaf to the host before it returns: an
    optimizer step that overwrites the params in place while the writer
    thread runs does not reach the checkpoint."""
    cfg = get_config("llama3.2-1b").reduced()
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    state = topt.init_opt(params)
    saved = topt.tree_map(torch.clone, params)
    th = ckpt.save(tmpdir_, (params, state), step=1, async_=True)
    grads = topt.tree_map(torch.ones_like, params)
    params, state, _ = topt.adamw_update(topt.OptConfig(lr=1.0), params,
                                         grads, state)
    th.join(timeout=60)
    assert not th.is_alive()
    (got, got_state), _ = ckpt.restore(tmpdir_, (params, state))
    for a, b, now in zip(topt.tree_leaves(saved), topt.tree_leaves(got),
                         topt.tree_leaves(params)):
        _same(b, a)
        assert not torch.equal(now, a)       # the update did move it
    assert int(got_state.step) == 0 and int(state.step) == 1
    assert not any(m.any() for m in topt.tree_leaves(got_state.mu))


@pytest.mark.parametrize("arch,jd,td", [
    ("llama3.2-1b", jnp.float32, torch.float32),
    ("llama3.2-1b", jnp.bfloat16, torch.bfloat16),
    ("rwkv6-1.6b", jnp.bfloat16, torch.bfloat16),   # f32 leaves in bf16
])
def test_jax_written_checkpoint_restores_bit_exactly(tmpdir_, arch, jd, td):
    """The JAX package saves (params, opt_state, data_state) the way its
    trainer does, after one update; the port restores it into its own
    tree and every leaf's bits equal the JAX arrays'."""
    jcfg = jget_config(arch).reduced()
    jp = jzoo.init(jcfg, jax.random.PRNGKey(0), jd)
    jstate = jopt.init_opt(jp)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32), jp)
    update = jax.jit(lambda p, g, s: jopt.adamw_update(jopt.OptConfig(), p,
                                                      g, s))
    jp, jstate, _ = update(jp, grads, jstate)
    jckpt.save(tmpdir_, (jp, jstate, {"step": 3}), step=1)

    cfg = get_config(arch).reduced()
    tp = model_zoo.init(cfg, 1, td, device="cpu")
    target = (tp, topt.init_opt(tp), {"step": 0})
    (rp, rstate, rdata), step = ckpt.restore(tmpdir_, target)
    assert step == 1 and int(rdata["step"]) == 3
    want = params_from_numpy(jax.tree.map(np.asarray, jp))
    for a, b in zip(topt.tree_leaves(want), topt.tree_leaves(rp)):
        _same(b, a)
    assert rstate.step.dtype == torch.int32 and int(rstate.step) == 1
    for jt, tt in ((jstate.mu, rstate.mu), (jstate.nu, rstate.nu)):
        for a, b in zip(jax.tree.leaves(jt), topt.tree_leaves(tt)):
            _same(b, torch.from_numpy(np.array(a)))
    # leaf names are the reference's
    names = [n for n, _ in ckpt._flatten(target)]
    assert sorted(names) == sorted(
        f[:-4] for f in os.listdir(os.path.join(tmpdir_, "step_00000001"))
        if f.endswith(".npy"))


def test_port_written_bf16_keeps_the_reference_manifest(tmpdir_):
    """The port writes bf16 as the reference does (2-byte void, "bfloat16"
    in the manifest), and reads it back bit for bit."""
    import json
    x = torch.tensor([1.0, -2.5, 3.140625, 65504.0]).to(torch.bfloat16)
    ckpt.save(tmpdir_, {"x": x}, step=2)
    with open(os.path.join(tmpdir_, "step_00000002", "MANIFEST.json")) as f:
        meta = json.load(f)["leaves"]["x"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [4]
    arr = np.load(os.path.join(tmpdir_, "step_00000002", "x.npy"))
    assert arr.dtype == np.dtype("V2")
    got, _ = ckpt.restore(tmpdir_, {"x": x})
    _same(got["x"], x)


def test_engine_snapshot_restore():
    from repro_torch.configs.qwen3_coder_30b import CONFIG as QWEN3
    from repro_torch.engine.backend import SimBackend
    from repro_torch.engine.engine import Engine, EngineConfig, run_sim
    from repro_torch.models.perf_model import H100
    from repro_torch.workloads.generator import WorkloadSpec, generate
    spec = WorkloadSpec(regime="ILR-1", arrival_rate=1.0, n_sessions=6,
                        seed=2, max_context=250_000)
    sessions = generate(spec, QWEN3, H100)
    eng = Engine(EngineConfig(total_kv_blocks=9000), "mars",
                 SimBackend(QWEN3, H100))
    for s in sessions:
        eng.submit(s)
    now = 0.0
    for _ in range(60):                       # run partway, then "crash"
        el, _ = eng.tick(now)
        now += max(el, 0.05)
    snap = ckpt.snapshot_engine(eng)
    assert snap["waiting"] or snap["active"]
    eng2 = Engine(EngineConfig(total_kv_blocks=9000), "mars",
                  SimBackend(QWEN3, H100))
    n = ckpt.restore_engine(eng2, snap)
    assert n == len(snap["waiting"]) + len(snap["active"])
    finished, _ = run_sim(eng2, [], max_time=1e5)
    assert len(finished) == n                 # all recovered sessions complete
