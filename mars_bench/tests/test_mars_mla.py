"""The MLA architecture (``arch/mla.py``) and its cell,
``kanana2-ilr1-families-1chip``.

On the CPU: the cell at the architecture's toy widths through ``bench``
is ``correct``, its f32 program exact against the reference and the fp8
control departing; the traced run reads ``moe_keep_frac`` from the
program's counters; the roofline counts at the published widths; a
program whose routed experts are misaddressed fails. On the card
(``card``): at the cell's own size the fp8 control fails where the
program passes, as ``test_mars_control.py`` holds the other cells, and
the misaddressed routed experts fail too."""
import json
import os
import time

import pytest

from mars_bench import arch, bench, roofline
from mars_bench.tests.cpu_cell import shrink

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "kanana2-ilr1-families-1chip"


def published():
    with open(os.path.join(HERE, "configs",
                           "kanana-2-30b-a3b-instruct-2601.json")) as f:
        return json.load(f)


def test_the_cell_names_the_mla_architecture():
    cfg = published()
    assert arch.module(cfg).__file__ == os.path.join(HERE, "arch", "mla.py")
    cell, c, t = bench.cell_files(bench.load_benchmark(), CELL)
    assert c["arch"] == "mla" and t["n_families"] == 4
    assert c["reduced"] == {}


def test_the_roofline_counts_the_published_attention():
    cfg = published()
    assert roofline.active_params(cfg) == 3_088_842_752
    assert roofline.kv_bytes_per_token_layer(cfg) == 1152
    assert roofline.attn_flops(cfg, 10) == 48 * 20480 * 10
    q_o = 32 * (192 + 128) * 2
    assert roofline.decode_attn_work(cfg, [5, 7]) == (20480 * 12.0,
                                                      1152 * 12 + 2 * q_o)
    assert roofline.prefill_attn_work(cfg, 100, 4) == (
        20480 * (400 + 10.0), 1152 * 104 + 4 * q_o)


def _roll_routed_experts(monkeypatch):
    """The program serves with every MoE layer's routed experts' w_down
    rolled by one expert (expert e projects out through expert e + 1's
    weights); the reference is handed the drawn weights back before it
    runs. The router, the shared MLP and everything else are untouched,
    so only the routed experts' contributions are wrong."""
    from mars_bench import check, weights
    make, compare = weights.make_params, check.compare

    def roll(params, shift):
        w = params["moe"]["w_down"]
        for layer in range(w.shape[0]):
            w[layer].copy_(w[layer].roll(shift, 0))

    def rolled_make(*a, **k):
        params = make(*a, **k)
        roll(params, 1)
        return params

    def restored_compare(cfg, params, *a, **k):
        roll(params, -1)
        return compare(cfg, params, *a, **k)
    monkeypatch.setattr(weights, "make_params", rolled_make)
    monkeypatch.setattr(check, "compare", restored_compare)


def test_misaddressed_routed_experts_fail_the_toy_cell(one_thread,
                                                        monkeypatch):
    _roll_routed_experts(monkeypatch)
    res = bench.run_cell(CELL, 2718281829, 3.0, False,
                         t_start=time.monotonic(), device="cpu",
                         shrink=shrink, say=lambda m: None)
    assert not res["correct"]


def test_the_toy_cell_is_correct_and_its_control_departs(one_thread):
    res = bench.run_cell(CELL, 2718281829, 3.0, False,
                         t_start=time.monotonic(), device="cpu",
                         shrink=shrink, control=True, say=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["_gaps"]["max_gap_sd"] < 1e-3
    assert res["_control"]["max_gap_sd"] > 10 * max(
        res["_gaps"]["max_gap_sd"], 1e-4)


def test_the_traced_toy_cell_reads_the_moe_counters(one_thread):
    def profiled(cfg, traffic):
        cfg, traffic = shrink(cfg, traffic)
        return cfg, dict(traffic, profile_s=traffic["lead_in_s"] + 2.0)
    res = bench.run_cell(CELL, 31415927, 2.0, True, t_start=time.monotonic(),
                         device="cpu", shrink=profiled, say=lambda m: None)
    keep = res["metrics"]["moe_keep_frac"]["value"]
    assert 0.0 < keep <= 1.0 and res["_counts"]["moe_keep_frac"] > 0
    # no card, no device records: the kernels' shares read nothing
    assert "mla_decode_roofline" not in res["metrics"]
    assert "mla_prefill_roofline" not in res["metrics"]


@pytest.mark.card
def test_control_fails_where_the_program_passes(card):
    res = bench.run_cell(CELL, 2718281828, 15.0, False,
                         t_start=time.monotonic(), control=True,
                         say=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["_control_correct"] is False, res["_control"]


@pytest.mark.card
def test_misaddressed_routed_experts_fail_the_cell(card, monkeypatch):
    """At the cell's own size the routed experts reach the compared
    logits: rolled, they fail the check."""
    _roll_routed_experts(monkeypatch)
    res = bench.run_cell(CELL, 2718281827, 15.0, False,
                         t_start=time.monotonic(), say=print)
    print("[routed roll] " + json.dumps(res["checks"]))
    assert not res["correct"], res["checks"]
