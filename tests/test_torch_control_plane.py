"""The port's own copy of the control plane against the reference, and the
port's import boundary.

``src/repro_torch`` carries copies of the JAX-free control plane
(``core``, ``kvcache``, ``engine``, ``configs``, ``models.config``,
``models.perf_model``, ``workloads.generator``, ``train.data``, ``obs``,
``distributed.router``) so that it imports nothing of ``repro``. These tests keep the copies honest: each
differs from its reference only in its import lines, and the copied
Engine over ``SimBackend`` replays a seeded scenario event for event. The
boundary test imports the port's entry points and ``chip_smoke.py`` in a
fresh interpreter in which ``jax`` and ``repro`` cannot be imported.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process holds both packages)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

COPIED = sorted(
    str(p.relative_to(SRC / "repro_torch"))
    for sub in ("core", "kvcache", "configs", "engine", "models",
                "workloads", "train", "obs", "distributed")
    for p in (SRC / "repro_torch" / sub).glob("*.py")
    if (SRC / "repro" / p.relative_to(SRC / "repro_torch")).exists()
    and p.name not in ("layers.py", "transformer.py", "rwkv6.py",
                       "mamba2.py", "zamba2.py", "whisper.py",
                       "model_zoo.py", "optimizer.py", "steps.py",
                       "checkpoint.py"))   # ported, not copied


def test_copies_cover_the_engine_closure():
    for name in ("engine/engine.py", "engine/backend.py", "engine/tools.py",
                 "engine/block_manager.py", "kvcache/pool.py",
                 "kvcache/swap_stream.py", "core/policies.py",
                 "models/config.py", "configs/registry.py",
                 "configs/llama3_2_1b.py", "workloads/generator.py",
                 "train/data.py", "obs/__init__.py", "obs/trace.py",
                 "obs/metrics.py", "obs/perfetto.py", "obs/slo.py",
                 "obs/detect.py", "obs/recorder.py", "obs/health.py",
                 "engine/faults.py", "distributed/router.py"):
        assert name in COPIED


@pytest.mark.parametrize("name", COPIED)
def test_copy_differs_from_reference_only_in_imports(name):
    mine = (SRC / "repro_torch" / name).read_text().splitlines()
    ref = (SRC / "repro" / name).read_text().splitlines()
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if a != b:
            assert a.replace("repro_torch.", "repro.") == b, (name, a)
            assert re.match(r"\s*(from|import) repro_torch\.", a) or \
                "import_module(f\"repro_torch.configs." in a, (name, a)


def _sim_engine(pkg):
    """The seeded MARS scenario of ``_sim_run``, built from ``pkg``'s own
    engine, generator and configs: (engine, sessions, ``run_sim``)."""
    import importlib
    eng_mod = importlib.import_module(f"{pkg}.engine.engine")
    backend_mod = importlib.import_module(f"{pkg}.engine.backend")
    gen = importlib.import_module(f"{pkg}.workloads.generator")
    pm = importlib.import_module(f"{pkg}.models.perf_model")
    cfg = importlib.import_module(f"{pkg}.configs.qwen3_coder_30b").CONFIG
    hw = pm.HW["h100"]
    spec = gen.WorkloadSpec(regime="ILR-1", arrival_rate=0.5, n_sessions=10,
                            seed=3, n_families=2)
    sessions = gen.generate(spec, cfg, hw)
    for i, s in enumerate(sessions):        # the packages' sid counters
        s.sid = 70_000 + i                  # differ; pin them
    eng = eng_mod.Engine(eng_mod.EngineConfig(
        total_kv_blocks=6000, block_size=32, token_budget=8192,
        max_decode_batch=64, decode_granularity=8, cpu_slots=8,
        disk_tier_blocks=-1), "mars", backend_mod.SimBackend(cfg, hw))
    return eng, sessions, eng_mod.run_sim


def _sim_run(pkg):
    """One seeded MARS scenario on the simulator, built from ``pkg``'s
    own engine, generator and configs."""
    eng, sessions, run_sim = _sim_engine(pkg)
    finished, horizon = run_sim(eng, sessions, max_time=2e5)
    eng.check_invariants()
    log = [(e.kind, e.t, e.sid, repr(sorted(e.data.items())))
           for e in eng.bus.log]
    return log, {s.sid: s.finish_time for s in finished}, horizon


def test_copied_engine_replays_reference_on_sim():
    ref_log, ref_fin, ref_h = _sim_run("repro")
    log, fin, h = _sim_run("repro_torch")
    assert len(ref_fin) >= 8          # the scenario really serves
    assert fin == ref_fin and h == ref_h
    assert len(log) == len(ref_log)
    assert log == ref_log


_BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked in the port")
        return None
sys.meta_path.insert(0, _Block())
import repro_torch.engine.torch_runner
import repro_torch.launch.serve
import repro_torch.kernels.ops
import repro_torch.kernels.flash_attention
import repro_torch.models.transformer
import repro_torch.models.mamba2
import repro_torch.models.zamba2
import repro_torch.models.whisper
import repro_torch.launch.train
import repro_torch.distributed.steps
import repro_torch.distributed.checkpoint
import repro_torch.train.optimizer
import repro_torch.obs
import repro_torch.engine.faults
import repro_torch.distributed.router
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
