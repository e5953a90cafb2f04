"""Nothing the harness runs loads JAX or the JAX package ``repro``, and
the reference loads nothing of the program (``repro_torch``). Top-level
module names are compared whole: ``repro_torch`` begins with ``repro``."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBE = r'''
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
{body}
top = sorted({{m.split(".")[0] for m in sys.modules}})
print("TOP", " ".join(top))
'''

RUN_A_CELL = '''
from mars_bench import bench
from mars_bench.tests.cpu_cell import shrink
bench.run_cell("internlm2-ilr1-families-1chip", 5, 1.5, True,
               t_start=time.monotonic(), device="cpu", shrink=shrink,
               say=lambda m: None)
import mars_bench.run
'''


def loaded(body):
    code = PROBE.format(root=ROOT, src=os.path.join(ROOT, "src"), body=body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("TOP ")][-1]
    return set(line.split()[1:])


def test_a_run_loads_no_jax():
    top = loaded(RUN_A_CELL)
    assert "repro_torch" in top and "mars_bench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    archs = sorted(f[:-3] for f in os.listdir(os.path.join(
        ROOT, "mars_bench", "arch")) if f.endswith(".py"))
    assert "gqa" in archs
    top = loaded("import mars_bench.reference, mars_bench.weights, "
                 "mars_bench.roofline, mars_bench.arch\n"
                 + "".join(f"import mars_bench.arch.{a}\n" for a in archs
                           if a != "__init__"))
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_no_file_reads_the_old_benchmarks():
    pat = re.compile(r"\bbenchmarks(_torch)?\b|import\s+repro\b|"
                     r"from\s+repro\s+import|from\s+repro\.")
    hits = []
    for d, _dirs, files in os.walk(os.path.join(ROOT, "mars_bench")):
        for f in files:
            if f.endswith(".py") and f != os.path.basename(__file__):
                src = open(os.path.join(d, f)).read()
                hits += [f"{f}: {m.group(0)}" for m in pat.finditer(src)]
    assert not hits, hits
