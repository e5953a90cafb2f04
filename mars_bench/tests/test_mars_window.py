"""The window arithmetic on synthetic event streams."""
import pytest

from mars_bench import window as W
from mars_bench.window import Ev, Run


def run_of(events, arrival, rounds, w0=10.0, seconds=10.0):
    return Run(seconds=seconds, w0=w0, w1=w0 + seconds, setup_s=1.0,
               events=events, arrival=arrival, rounds=rounds, iters=[],
               cfg={}, traffic={})


def steps(sid, r, ts):
    return [Ev(W.DECODE_STEP, t, sid, {"round": r, "tokens": 1}) for t in ts]


def test_edges_and_rates():
    # session 0 arrives before the window, 1 inside it, 2 at its close
    ev = (steps(0, 0, [9.0, 9.5, 10.0, 10.5]) + steps(1, 0, [12.0, 12.5])
          + steps(2, 0, [20.0]))
    run = run_of(ev, {0: 5.0, 1: 11.0, 2: 20.0},
                 {0: [(100, 4)], 1: [(100, 2)], 2: [(100, 1)]})
    # tokens at 10.0 and 10.5 (w0 inclusive), 12.0, 12.5; 20.0 is out
    assert W.output_tokens(run) == 4
    assert [x[0] for x in W.rounds_due(run)] == [1]
    assert W.ttfts(run, resumed=False) == [1.0]


def test_censored_waits_and_open_gaps():
    ev = steps(0, 0, [11.0, 12.0]) + [Ev(W.TOOL_END, 13.0, 0, {})]
    run = run_of(ev, {0: 10.5, 1: 18.0}, {0: [(100, 5), (10, 3)],
                                           1: [(100, 5)]})
    # round 0 of 0: 0.5 s; of 1: no token by the close, censored at 2 s
    assert sorted(W.ttfts(run, resumed=False)) == [0.5, 2.0]
    # round 1 of 0 is due at the tool's end, no token: 20 - 13
    assert W.ttfts(run, resumed=True) == [7.0]
    # the 11 -> 12 gap, and the gap open from 12 to the close
    assert sorted(W.itl_gaps(run)) == [1.0, 8.0]
    assert W.attempted_failed(run) == (3, 0)


def test_gap_ending_before_the_window_is_left_out():
    ev = steps(0, 0, [8.0, 9.0, 10.5]) + [Ev(W.GPU_END, 10.5, 0,
                                             {"round": 0})]
    run = run_of(ev, {0: 7.0}, {0: [(100, 3)]})
    assert W.itl_gaps(run) == [1.5]          # 9.0 -> 10.5 only; ended


def test_failed_counts_refused_and_miscounted_rounds():
    ev = (steps(0, 0, [11.0, 11.5]) + [Ev(W.GPU_END, 11.5, 0, {"round": 0})]
          + [Ev(W.REJECT, 12.0, 1, {})])
    run = run_of(ev, {0: 10.5, 1: 12.0}, {0: [(100, 3)], 1: [(100, 2)]})
    assert W.attempted_failed(run) == (2, 2)


def test_sample_counts_and_percentiles():
    assert W.percentile([1, 2, 3, 4], 50) == 2.5
    assert W.percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert W.median([]) is None
    assert W.union_s([(0, 2), (1, 3), (5, 6)], 0.5, 5.5) == \
        pytest.approx(3.0)
    assert W.idle_gaps([(0, 2), (1, 3), (5, 6)], 0.0, 7.0) == \
        [(3, 5), (6, 7.0)]


def test_readers_on_a_synthetic_stream():
    from mars_bench import bench
    ev = (steps(0, 0, [11.0 + 0.1 * i for i in range(20)])
          + [Ev(W.GPU_SUBMIT, 10.6, 0, {"round": 0})])
    run = run_of(ev, {0: 10.5}, {0: [(100, 20)]})
    assert bench.reader("output_tokens_per_s")(run) == (2.0, 20)
    assert bench.reader("admit_wait_s")(run) == (pytest.approx(0.1), 1)
    value, n = bench.reader("itl_p95_s")(run)
    # 19 gaps of 0.1 s and the gap open from 12.9 s to the close
    assert n == 20 and value == pytest.approx(0.1 + 0.05 * 7.0)
