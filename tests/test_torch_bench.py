"""The port's serving bench (``benchmarks_torch/serving_bench.py``) and its
copy of the reference bench helpers (``benchmarks_torch/common.py``) on
the CPU: the cells' sessions equal the reference generator's, the
simulator rows equal the reference's, every metric is printed by name
with its unit and sample count, ``correct`` holds on a clean run of each
cell's ``.reduced()`` config and turns false when a swapped-in KV page is
overwritten, and nothing the bench or the new examples import reaches
``jax`` or ``repro``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks_torch import common as tcommon  # noqa: E402
from benchmarks_torch import serving_bench as sb  # noqa: E402

CELLS = sorted(sb.CELLS)
E2E = ("ttft_resumed_s", "ttft_round0_s", "itl_s", "session_e2e_s",
       "goodput_frac", "goodput_sessions_per_s", "output_tokens_per_s",
       "failed_frac")


@pytest.fixture
def one_thread():
    """Tiny products on the live engine: spare the cores the other xdist
    workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(cell):
    from repro.configs import qwen3_coder_30b
    from repro.configs.registry import get_config
    from repro.models import perf_model as rpm
    from repro.workloads import generator as rgen
    cfg = (qwen3_coder_30b.CONFIG if cell.arch == "qwen3-coder-30b-a3b"
           else get_config(cell.arch))
    spec = rgen.WorkloadSpec(**dataclasses.asdict(sb.workload(cell, 0)))
    return rgen.generate(spec, cfg, rpm.H100)


def _view(s):
    return (s.arrival_time, s.ideal_time, s.slo_alpha,
            [dataclasses.astuple(r) for r in s.rounds],
            {k: v for k, v in s.meta.items()})


@pytest.mark.parametrize("name", CELLS)
def test_cell_sessions_equal_reference_generator(name):
    from repro_torch.models import perf_model as pm
    from repro_torch.workloads.generator import generate
    cell = sb.CELLS[name]
    cfg = sb.cell_config(cell, torch.device("cuda"))   # the published one
    mine = generate(sb.workload(cell, 0), cfg, pm.H100)
    ref = _reference(cell)
    assert len(mine) == len(ref) == cell.spec["n_sessions"]
    assert [_view(s) for s in mine] == [_view(s) for s in ref]
    # the cut of scale the cell states
    top = 0.85 * cell.spec["max_context"]
    assert all(s.total_prompt_tokens <= top + len(s.rounds) for s in mine)


def test_common_differs_from_reference_only_in_imports():
    mine = (ROOT / "benchmarks_torch" / "common.py").read_text().splitlines()
    ref = (ROOT / "benchmarks" / "common.py").read_text().splitlines()
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if a != b:
            assert re.match(r"from repro_torch\.", a), a
            assert a.replace("repro_torch.", "repro.") == b, a


def test_common_sim_row_equals_reference():
    import benchmarks.common as rcommon
    from repro.configs.qwen3_coder_30b import CONFIG as rcfg
    from repro.models.perf_model import H100 as rh100
    from repro_torch.configs.qwen3_coder_30b import CONFIG, CONTEXT_LIMIT
    from repro_torch.models.perf_model import H100
    rows = {}
    for pkg, mod, cfg, hw in (("ref", rcommon, rcfg, rh100),
                              ("port", tcommon, CONFIG, H100)):
        rows[pkg] = [mod.fmt_row(mod.run_point(
            cfg, hw, policy, "ILR-1", 0.2, 6, seed=0,
            max_context=CONTEXT_LIMIT)) for policy in ("fcfs", "mars")]
    assert rows["port"] == rows["ref"]
    assert rows["port"][1]["n"] == 6
    assert tcommon.speedup_vs_best_baseline(rows["port"]) == \
        rcommon.speedup_vs_best_baseline(rows["ref"])


@pytest.mark.parametrize("name", CELLS)
def test_bench_prints_every_metric_and_is_correct(name, tmp_path, capsys,
                                                  one_thread):
    out = tmp_path / "res.json"
    rc = sb.main(["--cell", name, "--device", "cpu", "--json", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text[-3000:]
    for metric in E2E:
        m = re.search(rf"^\[metric\] {metric}: (.*)$", text, re.M)
        assert m, (metric, text[-3000:])
        unit = sb.UNITS[metric]
        assert unit in m.group(1) and re.search(r"\(n=\d+\)$", m.group(1)), \
            m.group(0)
    assert "[check] correct: True" in text
    res = json.loads(out.read_text())
    assert res["correct"] and res["e2e"]["failed_frac"]["value"] == 0
    assert res["checks"]["rescore"]["tokens"] > 0
    assert res["checks"]["rescore"]["max_gap_z"] < 1e-3   # f32, same calls
    assert res["e2e"]["itl_s"]["n"] > 10


def test_correct_turns_false_on_an_overwritten_page(one_thread):
    """One KV page of a swapped-in session is overwritten right after its
    restore: the served tokens no longer follow from the context, and the
    re-score says so while the counts and the engine invariants hold."""
    from repro_torch.core.session import KVAction
    hit = []

    def install(eng, backend):
        eng.policy.on_tool_yield = lambda s, now: (KVAction.OFFLOAD, 0.0)
        impl = backend._impl
        inner = impl.swap_in

        def swap_in(s, lease):
            inner(s, lease)
            restore = s.meta.get("restore_positions", [])
            if restore and not hit:
                pid = impl.binding.page_of(lease[restore[0]])
                g = torch.Generator().manual_seed(5)
                for t in (impl.cache.k, impl.cache.v):
                    t[:, pid] = 30 * torch.randn(t[:, pid].shape,
                                                 generator=g)
                hit.append(s.sid)

        impl.swap_in = swap_in

    cell = sb.cpu_cell(sb.CELLS["llama1b-ilr1-families-1chip"])
    res = sb.run(cell, device="cpu", install=install, say=lambda m: None)
    assert hit and hit[0] in res["checks"]["rescore"]["sids"]
    assert res["checks"]["decode_counts"] and res["checks"]["invariants"]
    assert not res["checks"]["rescore"]["ok"]
    assert res["checks"]["rescore"]["max_gap_z"] > sb.TAU_Z
    assert res["correct"] is False


def test_bench_raises_without_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sb.main(["--cell", CELLS[0]])


_BLOCKER = """
import importlib.abc, importlib.util, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"{name} is blocked in the port")
        return None
sys.meta_path.insert(0, _Block())
import benchmarks_torch.common
import benchmarks_torch.serving_bench
for name in EXAMPLES:
    spec = importlib.util.spec_from_file_location(
        "example_" + name, "examples/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
assert not bad, bad
print("ok")
"""
EXAMPLES = ("torch_quickstart", "torch_agentic_serving", "torch_train_smoke",
            "torch_cluster_serving", "torch_paper_benchmark")


def test_bench_and_examples_import_without_jax_or_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    code = f"EXAMPLES = {EXAMPLES!r}\n" + _BLOCKER
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
