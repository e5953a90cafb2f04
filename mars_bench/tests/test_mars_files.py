"""A new configuration, architecture, traffic mix, metric and cell are
found by name: only new files and a new BENCHMARK.json entry, no edit of
the harness."""
import json
import os
import shutil
import time

from mars_bench import arch, bench, roofline
from mars_bench.tests.cpu_cell import shrink

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NEW_METRIC = '''"""Lanes per mixed iteration in the window."""
from mars_bench.window import iters_in_window


def read(run):
    its = iters_in_window(run)
    return (sum(len(i.lanes) for i in its) / len(its), len(its)) \\
        if its else None
'''


NEW_ARCH = '''"""GQA again, each of its functions recording that it was called."""
from mars_bench.arch import gqa

CALLS = set()
HOOKS = ("program_config", "make_params", "forward_logits", "toy",
         "active_params", "attn_flops", "kv_bytes_per_token_layer",
         "decode_attn_work", "prefill_attn_work")


def _recorded(name):
    def call(*args, **kwargs):
        CALLS.add(name)
        return getattr(gqa, name)(*args, **kwargs)
    return call


globals().update({name: _recorded(name) for name in HOOKS})
'''


def profile_the_window(cfg, traffic):
    """The tests' toy sizes, the profiler on for the whole window."""
    cfg, traffic = shrink(cfg, traffic)
    return cfg, dict(traffic, profile_s=traffic["lead_in_s"] + 2.0)


def test_new_files_are_found(tmp_path, one_thread):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "mars_bench"),
                    tmp_path / "mars_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mb = tmp_path / "mars_bench"
    cfg = json.loads((mb / "configs" / "internlm2-20b.json").read_text())
    cfg.update(name="toy-dense", arch="recorded_gqa")
    (mb / "arch" / "recorded_gqa.py").write_text(NEW_ARCH)
    (mb / "configs" / "toy-dense.json").write_text(json.dumps(cfg))
    tr = json.loads((mb / "traffic" / "ilr1-kvpressure.json").read_text())
    tr["decode_mean"] = 32
    (mb / "traffic" / "toy-short.json").write_text(json.dumps(tr))
    (mb / "metrics" / "lanes_per_iter.py").write_text(NEW_METRIC)
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy-dense", "source": "test",
                         "file": "mars_bench/configs/toy-dense.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "toy.short", "config": "toy-dense",
                           "traffic": "toy-short", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "lanes_per_iter", "unit": "lanes",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine", "moves": "itl_p95_s",
                           "workloads": ["toy.short"]})
    for m in b["per_layer"]:          # the new architecture runs GQA kernels
        if m["name"] in ("decode_attn_roofline", "prefill_attn_roofline"):
            m["workloads"].append("toy.short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell, c, t = bench.cell_files(bench.load_benchmark(tmp_path),
                                  "toy.short", tmp_path)
    assert c["name"] == "toy-dense" and t["decode_mean"] == 32
    names = [m["name"] for m in
             bench.metric_names(bench.load_benchmark(tmp_path), "toy.short",
                                True)]
    assert "lanes_per_iter" in names and "prefix_hit_frac" not in names
    res = bench.run_cell("toy.short", 3, 2.0, True, t_start=time.monotonic(),
                         device="cpu", root=tmp_path,
                         shrink=profile_the_window, say=lambda m: None)
    assert res["metrics"]["lanes_per_iter"]["value"] > 0
    assert res["correct"]
    new = arch.module(c)
    assert new.__file__ == str(mb / "arch" / "recorded_gqa.py")
    roofline.kv_bytes_per_token_layer(c)      # read by no metric yet
    assert new.CALLS == set(new.HOOKS)
