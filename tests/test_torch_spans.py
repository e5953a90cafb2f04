"""``repro_torch.obs.spans`` and the spans the port's serving iteration
records: the recorder's on and off paths, the tree one mixed iteration
leaves (``run_batch`` down to ``moe.*``), its counters against the batch,
tokens and ``dispatch_stats`` unchanged by recording, and the spans' clock
against ``torch.profiler``'s.

A ``TorchBackend(device="cpu")`` on a ``.reduced()`` config in float32 runs
one hand-built batch: three prefill packs of 40, 100 and 70 tokens (C 128,
P 4) beside two decode lanes.
"""
import time

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.session import Round, make_session
from repro_torch.engine.backend import BatchWork
from repro_torch.engine.torch_runner import TorchBackend
from repro_torch.obs import spans

PAGE = 32
CHUNKS = (40, 100, 70)
LANES = (50, 77)              # the decode lanes' positions
STATS_KEYS = {"batches", "wall_s", "swap_out_s", "cow_s", "swap_in_s",
              "prefill_s", "decode_s", "prefill_calls", "decode_calls",
              "mixed_s", "mixed_calls", "prefill_gather_bytes",
              "prefill_inplace_bytes"}


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _backend(arch):
    return TorchBackend(get_config(arch).reduced(), layout="paged",
                        total_pages=64, page_size=PAGE, max_slots=4,
                        device="cpu", dtype=torch.float32, seed=0,
                        async_swap=False)


def _batch(mixed=True):
    """Three packs from position 0 and two lanes, each on its own pages."""
    work = BatchWork(decodes=[], prefills=[], swapins=[], mixed=mixed)
    nxt = 0
    for sid, chunk in enumerate(CHUNKS):
        s = make_session(0.0, [Round(200, 4)], sid=sid)
        work.prefills.append((s, chunk))
        work.leases[sid] = tuple(range(nxt, nxt + 7))
        nxt += 7
    for k, pos in enumerate(LANES):
        s = make_session(0.0, [Round(pos, 8)], sid=10 + k)
        s.resident_len = pos
        s.meta["next_token"] = 5 + k
        work.decodes.append((s, 1))
        n = pos // PAGE + 1
        work.leases[s.sid] = tuple(range(nxt, nxt + n))
        nxt += n
    return work


def _tokens(work):
    return ([s.meta["next_token"] for s, _ in work.prefills],
            [s.meta["generated"] for s, _ in work.decodes])


def _children(sp, i):
    return [j for j, s in enumerate(sp) if s.parent == i]


def _names(sp, i):
    return [sp[j].name for j in _children(sp, i)]


def test_off_records_nothing():
    assert spans.span("layer.attn") is spans.NOOP
    assert spans.begin("swap_out", spans.clock()) is spans.NOOP
    assert spans.root("run_batch", spans.clock()) is spans.NOOP
    spans.count("readbacks", 1)
    b = _backend("llama3.2-1b")
    b.run_batch(_batch(), 0.0)
    assert spans.drain() == ([], 0)


def test_nesting_counts_and_attrs_of_one_span():
    spans.enable()
    with spans.span("outer"):
        spans.count("n", 2)
        with spans.span("inner"):
            spans.count("n", 5)
        spans.count("n", 1)
    sp, dropped = spans.drain()
    assert dropped == 0
    # a span keeps no attributes beyond its name, place, times and counts
    assert spans.Span._fields == ("name", "parent", "t0", "t1", "counts")
    assert [(s.name, s.parent, s.counts) for s in sp] == [
        ("outer", -1, {"n": 3}), ("inner", 0, {"n": 5})]
    assert sp[0].t0 <= sp[1].t0 <= sp[1].t1 <= sp[0].t1


def test_recording_reads_the_wall_clock_only_at_enable(monkeypatch):
    """Stamps come from the monotonic clock plus ``time.time_ns()``'s
    offset read at ``enable()``: on the wall clock's time line, and never
    running backwards if the wall clock is stepped while recording."""
    b = _backend("llama3.2-1b")
    spans.enable()
    assert abs(spans.clock() - time.time_ns()) < 5_000_000

    def stepped():
        raise AssertionError("the wall clock read while recording")
    monkeypatch.setattr(spans, "time_ns", stepped)
    took = b.run_batch(_batch(), 0.0)
    sp, _ = spans.drain()
    assert took > 0 and sp[0].name == "run_batch"
    assert all(s.t1 >= s.t0 for s in sp)


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)
    spans.enable()
    for _ in range(5):
        with spans.span("s"):
            pass
    sp, dropped = spans.drain()
    assert (len(sp), dropped) == (3, 2)


def test_drain_refuses_inside_an_open_span():
    spans.enable()
    with spans.span("open"):
        with pytest.raises(RuntimeError):
            spans.drain()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_mixed_iteration_tree(arch):
    b = _backend(arch)
    cfg = b.cfg
    spans.enable()
    b.run_batch(_batch(), 0.0)
    sp, dropped = spans.drain()
    assert dropped == 0
    for s in sp:                              # every child inside its parent
        assert s.t1 >= s.t0 > 0
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s.name, p.name)
    assert sp[0].name == "run_batch" and sp[0].parent == -1
    assert _names(sp, 0) == ["swap_out", "cow", "swap_in", "run_mixed"]
    rm = _children(sp, 0)[-1]
    assert _names(sp, rm) == ["run_mixed.inputs", "run_mixed.forward",
                              "run_mixed.readback", "run_mixed.commit"]
    inputs, forward = _children(sp, rm)[:2]
    assert _names(sp, inputs) == ["context_ids"] * 3
    steps = _children(sp, forward)
    # P 4: the three packs and one slack pack, then the decode lanes
    assert [sp[j].name for j in steps] == ["step.pack"] * 4 + ["step.decode"]
    for j in steps:
        assert _names(sp, j) == ["layer.attn", "layer.ffn"] * cfg.n_layers
        for f in _children(sp, j):
            want = (["moe.route", "moe.dispatch", "moe.experts",
                     "moe.combine"]
                    if cfg.family == "moe" and sp[f].name == "layer.ffn"
                    else [])
            assert _names(sp, f) == want


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_counters_equal_the_batch(arch):
    b = _backend(arch)
    spans.enable()
    b.run_batch(_batch(), 0.0)
    sp, _ = spans.drain()
    rm = next(s for s in sp if s.name == "run_mixed")
    counts = dict(rm.counts)
    if b.cfg.moe is not None:
        # every real row's routed entries (the packs' 210 tokens and the 2
        # lanes) over every MoE layer, and those the dispatch kept
        routed = (210 + 2) * b.cfg.moe.top_k * b.cfg.n_layers
        assert counts.pop("moe_entries_routed") == routed
        assert 0 < counts.pop("moe_entries_kept") <= routed
    # the four packs and the decode lanes, each a stage run eagerly
    assert counts == {"pack_tokens_real": 210,
                      "pack_tokens_computed": 4 * 128,
                      "lanes_real": 2, "lanes_computed": 2,
                      "stages_eager": 5}
    rb = next(s for s in sp if s.name == "run_mixed.readback")
    assert rb.counts == {"readbacks": 2}
    # each pack's session draws its 200-token round 0, position by position
    assert [s.counts for s in sp if s.name == "context_ids"] == \
        [{"context_tokens_synthesized": 200}] * 3


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "round"])
def test_recording_changes_no_token_and_no_dispatch_stat(mixed):
    got = {}
    for on in (False, True):
        b = _backend("granite-moe-3b-a800m")
        work = _batch(mixed)
        if on:
            spans.enable()
        took = b.run_batch(work, 0.0)
        st = b.dispatch_stats
        assert set(st) == STATS_KEYS
        assert (st["batches"], st["prefill_calls"], st["decode_calls"],
                st["mixed_calls"]) == (1, 3, 2, int(mixed))
        phases = st["swap_out_s"] + st["cow_s"] + st["swap_in_s"] + (
            st["mixed_s"] if mixed else st["prefill_s"] + st["decode_s"])
        assert took == st["wall_s"] == pytest.approx(phases)
        got[on] = _tokens(work)
        sp, _ = spans.drain()
        if on:
            want = ["run_mixed"] if mixed else ["prefill", "decode"]
            assert _names(sp, 0)[3:] == want
            # dispatch_stats' phases are the spans' own boundaries
            run_batch = sp[0]
            assert (run_batch.t1 - run_batch.t0) * 1e-9 == \
                pytest.approx(took)
        else:
            assert sp == []
    assert got[True] == got[False]


def test_run_batch_records_while_the_profiler_records():
    b = _backend("llama3.2-1b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        b.run_batch(_batch(), 0.0)
        # outside an iteration nothing follows the profiler
        assert spans.span("layer.attn") is spans.NOOP
    b.run_batch(_batch(), 0.0)
    sp, _ = spans.drain()
    assert sum(s.name == "run_batch" for s in sp) == 1
    assert sum(s.name == "step.pack" for s in sp) == 4


def test_spans_share_the_profilers_clock():
    """A ``record_function`` range inside a program span: its kineto start
    and end lie inside the span, within 50 us."""
    spans.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with spans.span("outer"):
                time.sleep(0.002)
                with torch.profiler.record_function("probe"):
                    torch.ones(64, 64).sum()
                    time.sleep(0.002)
                time.sleep(0.002)
    sp, _ = spans.drain()
    probes = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe")
    assert len(probes) == len(sp) == 3
    tol = 50_000
    for s, (a, z) in zip(sp, probes):
        assert s.t0 - tol <= a < z <= s.t1 + tol
        # and not merely somewhere early or late in a long span
        assert a - s.t0 >= 2_000_000 - tol and s.t1 - z >= 2_000_000 - tol
