"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
(``--device cpu``: each one's ``.reduced()`` config in float32, the
kernels' plain versions), each held to what its reference example shows.
"""
import importlib.util
import json
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _main(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny products on live engines: spare the cores the other xdist
    workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_resumes_warm(capsys):
    _main("torch_quickstart")(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 4 multi-round sessions" in out
    warm = int(re.search(r"warm resumptions \(KV retained across tools\): "
                         r"(\d+)", out).group(1))
    assert warm > 0


def test_agentic_serving_disk_tier_and_trace(tmp_path, capsys):
    trace = tmp_path / "agents.json"
    _main("torch_agentic_serving")(["--device", "cpu", "--disk-tier",
                                    "--trace", str(trace)])
    out = capsys.readouterr().out
    assert "agent loop: 3/3 tasks completed" in out
    assert out.count("solution_written=True") == 3
    assert "KV tier breakdown:" in out
    disk = re.search(r"disk tier: \d+/\d+ blocks .* stores=(\d+)", out)
    assert disk and int(disk.group(1)) > 0          # the staged path ran
    assert "per-session critical-path breakdown:" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_train_smoke_loss_falls(capsys):
    _main("torch_train_smoke")(["--device", "cpu", "--steps", "20",
                                "--seq-len", "32", "--batch", "4"])
    out = capsys.readouterr().out
    first, last = map(float, re.search(r"loss ([\d.]+) -> ([\d.]+)",
                                       out).groups())
    assert last < first


def test_cluster_serving_finishes_every_session(capsys):
    _main("torch_cluster_serving")(["--device", "cpu", "--sessions", "6"])
    out = capsys.readouterr().out
    assert "killing ['replica-1']" in out
    assert "6/6 sessions completed" in out
    assert re.search(r"router events: [1-9]\d* failures detected", out)


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_agentic_serving",
                                  "torch_train_smoke",
                                  "torch_cluster_serving"])
def test_example_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        _main(name)([])
