"""BENCHMARK.json against the contract's form, and the last line's keys."""
import json
import os
import re
import subprocess
import sys
import time

import pytest

from mars_bench import bench
from mars_bench.tests.cpu_cell import shrink

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_form():
    b = bench.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "mars_bench/run.py"]
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(
            ROOT, "mars_bench", "traffic", w["traffic"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(
            ROOT, "mars_bench", "metrics", m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in b["workloads"]:          # setup_s, another end-to-end metric
        ends = {m["name"] for m in bench.metric_names(b, w["name"], False)}
        assert "setup_s" in ends and len(ends) >= 2
        assert bench.metric_names(b, w["name"], True)
        for m in bench.metric_names(b, w["name"], True):
            assert m["moves"] in ends


def test_last_line_schema(one_thread):
    res = bench.run_cell("qwen3coder-ilr1-kvpressure-1chip", 21474836470,
                         2.0, False, t_start=time.monotonic(), device="cpu",
                         shrink=shrink, say=lambda m: None)
    for key in [k for k in res if k.startswith("_")]:
        del res[key]                  # as run.py does before printing
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {m["name"] for m in bench.metric_names(
        bench.load_benchmark(), "qwen3coder-ilr1-kvpressure-1chip", False)}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_no_card_means_no_result():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "mars_bench/run.py", "--workload",
                        "qwen3coder-ilr1-kvpressure-1chip", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout


def test_without_the_program_there_is_no_result(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "mars_bench"),
                    tmp_path / "mars_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "mars_bench/run.py", "--workload",
                        "qwen3coder-ilr1-kvpressure-1chip", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and "{" not in p.stdout
