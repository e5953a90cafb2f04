"""The metrics that read the program's own spans (``program_spans.py``):
each reader on a synthetic run with hand-made spans and device records,
nothing to read from a program without the recorder, the interval
arithmetic, and, on the card, the spans' clock against the device
records'."""
import sys

import pytest

from mars_bench import bench
from mars_bench import program_spans as P
from mars_bench.trace import ITER, TICK
from mars_bench.window import Iter, Kernel, Profile, Run

OFF = 1000.0                  # the profiler's clock minus the run's
NEW = ("iter_inputs_ms", "iter_enqueue_ms", "iter_readback_ms",
       "idle_enqueue_frac", "pack_pad_frac")


def _iteration(sp, t, real, computed):
    """One mixed iteration's spans from ``t`` (the profiler's clock):
    inputs 50 ms (context_ids 40), forward 150 (a pack: attn 40, ffn 50
    holding moe.experts 20; a decode step 50), readback 90, commit 10."""
    def add(name, parent, a, b, counts=None):
        sp.append(P.PSpan(name, parent, t + a, t + b, counts or {}))
        return len(sp) - 1
    rb = add("run_batch", -1, 0.0, 0.31)
    rm = add("run_mixed", rb, 0.0, 0.3,
             {"pack_tokens_real": real, "pack_tokens_computed": computed,
              "lanes_real": 3, "lanes_computed": 4})
    add("context_ids", add("run_mixed.inputs", rm, 0.0, 0.05), 0.0, 0.04,
        {"context_tokens_synthesized": 100})
    fw = add("run_mixed.forward", rm, 0.05, 0.2)
    pack = add("step.pack", fw, 0.05, 0.15)
    add("layer.attn", pack, 0.05, 0.09)
    add("moe.experts", add("layer.ffn", pack, 0.09, 0.14), 0.10, 0.12)
    add("step.decode", fw, 0.15, 0.2)
    add("run_mixed.readback", rm, 0.2, 0.29, {"readbacks": 2})
    add("run_mixed.commit", rm, 0.29, 0.3)


def _run():
    """Window [10, 20) on the run's clock; the profiler covers two
    iterations, at 18.0 and 19.8 s: the second ends after the close. Two
    device records: the first iteration's from 0.10 s (in its pack) to
    0.28 s (in its readback), the second's from 0.12 to 0.15 s."""
    sp = []
    _iteration(sp, OFF + 18.0, 210, 512)
    _iteration(sp, OFF + 19.8, 100, 128)
    iters = [Iter(17.0, 17.3, [], [], profiled=False),
             Iter(18.0, 18.3, [], [], profiled=True),
             Iter(19.8, 20.1, [], [], profiled=True)]
    prof = Profile(OFF + 18.0, OFF + 20.3,
                   [Kernel("k", OFF + 18.10, 0.18),
                    Kernel("k", OFF + 19.92, 0.03)],
                   [(TICK, OFF + 18.0, OFF + 18.35),
                    (ITER, OFF + 18.0, OFF + 18.3),
                    (TICK, OFF + 19.8, OFF + 20.3),
                    (ITER, OFF + 19.8, OFF + 20.1)])
    run = Run(seconds=10.0, w0=10.0, w1=20.0, setup_s=1.0, events=[],
              arrival={}, rounds={}, iters=iters, cfg={}, traffic={},
              profile=prof)
    run.program_spans = sp
    return run


@pytest.mark.parametrize("name,value,n", [
    ("iter_inputs_ms", 50.0, 1),
    ("iter_enqueue_ms", 150.0, 1),
    ("iter_readback_ms", 90.0, 1),
    # forward idle: 0.05 s of the first (before its record), 0.07 + 0.05
    # of the second, over the 2.3 s profiled
    ("idle_enqueue_frac", 0.17 / 2.3, 2),
    # the window holds the first iteration alone
    ("pack_pad_frac", 1 - 210 / 512, 1),
])
def test_reader_on_hand_made_spans(name, value, n):
    got = bench.reader(name)(_run())
    assert got[0] == pytest.approx(value) and got[1] == n


def test_the_readers_extras():
    run = _run()
    _v, _n, x = bench.reader("iter_inputs_ms")(run)
    assert x["max_ms"] == pytest.approx(50.0)
    assert x["context_ids_share"] == pytest.approx(0.8)
    assert x["context_tokens_synthesized"] == 100
    _v, _n, x = bench.reader("iter_enqueue_ms")(run)
    assert x["self_ms"] == pytest.approx({
        "step.pack": 10.0, "layer.attn": 40.0, "layer.ffn": 30.0,
        "moe.experts": 20.0, "step.decode": 50.0})
    assert x["spans_dropped"] == 0
    assert bench.reader("iter_readback_ms")(run)[2] == \
        {"readbacks_per_iter": 2}
    assert bench.reader("pack_pad_frac")(run)[2] == {
        "pack_tokens_real": 210, "pack_tokens_computed": 512,
        "lanes_real": 3, "lanes_computed": 4}
    _v, _n, x = bench.reader("idle_enqueue_frac")(run)
    idle = x["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(
        bench.reader("device_idle_frac")(run)[0])
    assert idle["run_mixed.inputs"] == pytest.approx(0.1 / 2.3)
    assert idle["run_mixed.readback"] == pytest.approx(
        (0.01 + 0.09) / 2.3)
    # the longest gap lies between the two iterations; the first
    # iteration's pack waits 0.1 s for its first record
    gaps = x["longest_gaps"]
    assert gaps[0] == ["outside run_batch", pytest.approx(1.64)]
    assert ["run_batch/run_mixed/run_mixed.forward/step.pack/"
            "layer.attn", pytest.approx(0.1)] in gaps and len(gaps) == 3


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_recorder(name, monkeypatch):
    """A program without ``repro_torch.obs.spans`` (an older checkout):
    no spans, and each reader reads nothing."""
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    run = _run()
    run.program_spans = None
    assert bench.reader(name)(run) is None
    assert run.program_spans == []


def test_without_the_runs_clock_every_iteration_counts():
    run = _run()
    run.profile.spans[:] = [s for s in run.profile.spans if s[0] != ITER]
    assert P.run_clock_offset(run) is None
    assert bench.reader("pack_pad_frac")(run)[0] == pytest.approx(
        1 - 310 / 640)


def test_interval_arithmetic():
    a = [(0.0, 2.0), (3.0, 6.0)]
    b = [(1.0, 4.0), (5.0, 5.5)]
    assert P.overlap_s(a, b) == pytest.approx(2.5)
    assert P.minus(a, b) == [(0.0, 1.0), (4.0, 5.0), (5.5, 6.0)]
    assert P.minus(a, []) == a and P.minus([], b) == []


@pytest.mark.card
def test_device_records_share_the_spans_clock(card):
    """A kernel launched inside a program span and synchronised inside a
    child span: its device record starts after the parent's start and ends
    before the child's end, within 50 us. Printed besides: each record's
    start less its launch call's ``spans.clock()`` (the device clock's
    offset, plus the launch latency)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import spans
    x = torch.randn(4096, 4096, device=card)
    (x @ x).sum().item()
    launched = []
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                with spans.span("launch"):
                    time.sleep(0.001)
                    launched.append(spans.clock())
                    x @ x
                    with spans.span("sync"):
                        torch.cuda.synchronize()
                time.sleep(0.001)
    finally:
        spans.disable()
    sp, _ = spans.drain()
    pairs = [(s, sp[i + 1]) for i, s in enumerate(sp) if s.name == "launch"]
    recs = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if "CUDA" in str(e.device_type()) and e.duration_ns() > 0]
    assert len(pairs) == 5 and recs
    tol = 50_000
    slack = []
    for a, z in recs:
        inside = [k for k, (p, c) in enumerate(pairs)
                  if p.t0 - tol <= a and z <= c.t1 + tol]
        assert len(inside) == 1, (a, z, [(p.t0, c.t1) for p, c in pairs])
        p, c = pairs[inside[0]]
        slack.append((a - p.t0, c.t1 - z, a - launched[inside[0]]))
    us = [[round(v / 1e3, 1) for v in col] for col in zip(*slack)]
    print(f"device records {len(recs)}; start after the launch span "
          f"{min(us[0])}-{max(us[0])} us, end before the sync span's end "
          f"{min(us[1])}-{max(us[1])} us, start less the launch call "
          f"{min(us[2])}-{max(us[2])} us")
