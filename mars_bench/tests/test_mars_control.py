"""The control of ``correct``: the reference in fp8 put in the program's
place comes out not correct by the rule (``check.passes``) that passes
the program. On the card at the cell's own
size (a short window of the cell's traffic, its own check sample); on
the CPU at toy sizes the f32 program is exact and the control is not."""
import time

import pytest

from mars_bench import bench
from mars_bench.tests.cpu_cell import shrink

CELLS = ["qwen3coder-ilr1-kvpressure-1chip", "internlm2-ilr1-families-1chip"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, card):
    res = bench.run_cell(cell, 2718281828, 15.0, False,
                         t_start=time.monotonic(), control=True,
                         say=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["_control_correct"] is False, res["_control"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_departs_on_the_cpu(cell, one_thread):
    keep = {}
    res = bench.run_cell(cell, 1618033988, 3.0, False,
                         t_start=time.monotonic(), device="cpu",
                         shrink=shrink, control=True, keep=keep,
                         say=lambda m: None)
    assert res["_gaps"]["max_gap_sd"] < 1e-3
    assert res["_control"]["max_gap_sd"] > 10 * max(
        res["_gaps"]["max_gap_sd"], 1e-4)
