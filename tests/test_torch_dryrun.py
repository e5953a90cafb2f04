"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``roofline``, ``roofline_probe``).

The fake worlds run in one subprocess (a process group is process-wide):
an 8-rank ``fake`` group, mesh (data 4, model 2), in which

- the collective counter, on a small DTensor program, counts the
  all-gather, all-reduce, reduce-scatter and all-to-all bytes of known
  output shapes (the counterpart of tests/test_dryrun.py's HLO parser
  test), and only those;
- ``run_cell`` traces ``llama3.2-1b.reduced()`` and ``dbrx-132b.reduced()``
  train cells (the dbrx one expert-parallel, with ZeRO moments): status
  ok, flops > 0, all-to-all bytes > 0 for dbrx, and the argument bytes
  equal to the local shards that the sharding rules give the params, the
  f32 moments, the batch and the step counter;
- the probe's two-depth extrapolation of a 6-layer ``llama3.2-1b.reduced()``
  prefill equals the direct trace at depth 6 (flops within 1e-6
  relative: the port traces every layer, so the fit is exact).

In this process: ``cell_is_supported`` equals JAX's on all 40 cells, and
``analyze`` on tests/test_dryrun.py's record reads the same counts as
JAX's (its terms times the H100 figures equal JAX's terms times the v5e
figures) with a memory term of 5e12 / 3.35e12 s.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import cell_is_supported as j_supported
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch import roofline as jroof
from repro_torch.configs.registry import ARCH_IDS, cell_is_supported
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline

SCRIPT = textwrap.dedent(r"""
    import dataclasses, json, sys
    import numpy as np
    import torch
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          zeros)
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun, roofline_probe
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model_zoo

    dryrun.init_fake_world(8)
    mesh = make_test_mesh()                          # (data 4, model 2)
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}

    # the counter on a small program of known collectives (f32 = 4 bytes)
    with FakeTensorMode():
        x = zeros((8, 6), device_mesh=mesh, placements=[Shard(0), Shard(1)])
        c = dryrun.CellCounter()
        with dryrun._propagating(c), c:
            x.redistribute(mesh, [Shard(0), Replicate()])   # gather (2, 6)
            x.redistribute(mesh, [Replicate(), Shard(1)])   # gather (8, 3)
            p = DTensor.from_local(torch.zeros(4, 4), mesh,
                                   [Partial(), Replicate()], run_check=False)
            p.redistribute(mesh, [Replicate(), Replicate()])    # reduce 4x4
            q = DTensor.from_local(torch.zeros(8, 4), mesh,
                                   [Partial(), Replicate()], run_check=False)
            q.redistribute(mesh, [Shard(0), Replicate()])  # scatter to (2, 4)
            funcol.all_to_all_single(torch.zeros(8, 2), None, None,
                                     (mesh, 0))             # a2a (8, 2)
    out["counter"] = c.collective_bytes()
    out["counter_flops"] = c.flops

    def expected_args(cfg, spec):
        # local shard bytes the rules give: bf16 params, f32 moments,
        # the batch's int32 tokens and targets, the int32 step
        sizes = sh.axis_sizes(mesh)
        with FakeTensorMode():
            params = model_zoo.init(cfg, 0, torch.bfloat16, device="cpu")
        specs = sh.param_specs(cfg, mesh, params)
        def shards(s):
            n = 1
            for ax in s:
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    if a is not None:
                        n *= sizes[a]
            return n
        def walk(p, s):
            if isinstance(p, dict):
                return sum(walk(p[k], s[k]) for k in p)
            n = p.numel()
            m = sh.opt_moment_spec(s, tuple(p.shape), mesh)
            return n // shards(s) * 2 + 2 * (n // shards(m) * 4)
        batch = 2 * spec.global_batch * spec.seq_len * 4 // sh._dp_size(mesh)
        return walk(params, specs) + batch + 4

    for arch in ("llama3.2-1b", "dbrx-132b"):
        cfg = get_config(arch).reduced()
        rec = dryrun.run_cell(arch, "train_4k", mesh=mesh, cfg=cfg,
                              verbose=False)
        rec["expected_args"] = expected_args(cfg, SHAPES["train_4k"])
        rec.pop("traceback", None)
        out[arch] = rec

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), n_layers=6)
    probe = roofline_probe.probe_cell("llama3.2-1b", "prefill_32k", mesh,
                                      cfg=cfg)
    direct = dryrun.run_cell("llama3.2-1b", "prefill_32k", mesh=mesh,
                             cfg=cfg, verbose=False)
    out["probe"] = {"probe": probe.get("flops"), "direct": direct.get("flops"),
                    "depths": probe.get("probe_depths"),
                    "status": [probe["status"], direct["status"]]}
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_world():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    run = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
    assert run.returncode == 0 and line, run.stdout[-3000:] + \
        run.stderr[-6000:]
    return json.loads(line[-1][len("RESULT "):])


def test_collective_counter_counts_output_shapes(fake_world):
    assert fake_world["mesh"] == {"data": 4, "model": 2}
    c = fake_world["counter"]
    assert c["all-gather"] == (2 * 6 + 8 * 3) * 4
    assert c["all-reduce"] == 4 * 4 * 4
    assert c["reduce-scatter"] == 2 * 4 * 4
    assert c["all-to-all"] == 8 * 2 * 4
    assert c["collective-permute"] == 0
    assert c["total"] == sum(c[k] for k in ("all-gather", "all-reduce",
                                            "reduce-scatter", "all-to-all"))
    assert fake_world["counter_flops"] == 0


def test_skip_rules_match_jax():
    assert ARCH_IDS == J_ARCH_IDS and tuple(SHAPES) == tuple(J_SHAPES)
    for a in ARCH_IDS:
        for s in SHAPES:
            assert cell_is_supported(a, s) == j_supported(a, s), (a, s)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b"])
def test_run_cell_traces_a_train_cell(fake_world, arch):
    rec = fake_world[arch]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["device"] == "fake-cpu" and rec["n_devices"] == 8
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["temp_size_in_bytes"] > 0
    assert rec["argument_size_in_bytes"] == rec["expected_args"]
    coll = rec["collectives"]
    assert coll["total"] > 0
    if arch == "dbrx-132b":                      # expert parallel
        assert coll["all-to-all"] > 0
    else:
        assert coll["all-to-all"] == 0


def test_probe_extrapolation_equals_the_full_depth_trace(fake_world):
    p = fake_world["probe"]
    assert p["status"] == ["ok", "ok"] and p["depths"] == [2, 4, 6]
    assert p["probe"] == pytest.approx(p["direct"], rel=1e-6)


def test_roofline_analysis_reads_the_reference_counts():
    rec = {"status": "ok", "arch": "llama3.2-1b", "shape": "train_4k",
           "n_devices": 256, "flops": 5e13, "bytes_accessed": 5e12,
           "collectives": {"total": 7e10}}
    row = roofline.analyze(rec)
    want = jroof.analyze(rec)
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["terms_s"]["memory"] == pytest.approx(5e12 / 3.35e12)
    assert row["reckoned"] and row["hardware"] == "h100-nvl"
    assert 0 < row["useful_ratio"] < 2 and row["lever"]
    assert row["model_flops"] == want["model_flops"]
    for term, (ours, theirs) in {"compute": (989e12, 197e12),
                                 "memory": (3.35e12, 819e9),
                                 "collective": (450e9, 50e9)}.items():
        assert row["terms_s"][term] * ours == pytest.approx(
            want["terms_s"][term] * theirs, rel=1e-4), term
