"""The timed path broken underneath a run: ``correct`` comes out false.
The look for a card is skipped (the run is on the CPU at toy sizes); the
rest of the run is the benchmark's own."""
import time

import pytest
import torch

from mars_bench import bench
from mars_bench.tests.cpu_cell import shrink

CELLS = ["qwen3coder-ilr1-kvpressure-1chip", "internlm2-ilr1-families-1chip"]


def run(cell):
    return bench.run_cell(cell, 987654321012, 3.0, False,
                          t_start=time.monotonic(), device="cpu",
                          shrink=shrink, say=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, one_thread):
    res = run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_token_altered_where_produced(cell, one_thread, monkeypatch):
    """Every decode lane's token replaced by its neighbour in the
    vocabulary, as the iteration returns it."""
    from repro_torch.engine import torch_runner
    inner = torch_runner.lm_mixed_paged

    def altered(cfg, *a, **k):
        p, d, cache = inner(cfg, *a, **k)
        return p, (d + 1) % cfg.vocab_size, cache
    monkeypatch.setattr(torch_runner, "lm_mixed_paged", altered)
    res = run(cell)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for n, c in res["checks"].items()
               if n in res["_gaps"])


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(cell, one_thread, monkeypatch):
    """The prefill packs' KV writes dropped: the pool keeps its old
    contents where a pack should have written."""
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "paged_write",
                        lambda pool, pages, offsets, new: pool)
    res = run(cell)
    assert not res["correct"]


def test_half_the_lanes_left_out(one_thread, monkeypatch):
    """The decode batch's later half fed the first half's tokens."""
    from repro_torch.engine import torch_runner
    inner = torch_runner.lm_mixed_paged

    def halved(cfg, params, cache, *a, **k):
        a = list(a)
        d_tokens = a[7]
        B = d_tokens.shape[0]
        if B >= 2:
            d_tokens = d_tokens.clone()
            d_tokens[B // 2:] = d_tokens[:B - B // 2]
            a[7] = d_tokens
        return inner(cfg, params, cache, *a, **k)
    monkeypatch.setattr(torch_runner, "lm_mixed_paged", halved)
    res = run(CELLS[1])
    assert not res["correct"]
