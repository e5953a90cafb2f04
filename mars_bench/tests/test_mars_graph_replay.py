"""``graph_replay_frac`` on hand-made program spans: the share of
replayed stages over the window's profiled iterations (an unprofiled one
carries no program spans and counts nothing), nothing to read without
stage counters, and iterations ending after the close left out."""
import pytest

from mars_bench import bench
from mars_bench import program_spans as P
from mars_bench.trace import ITER, TICK
from mars_bench.window import Iter, Profile, Run

OFF = 1000.0                  # the profiler's clock minus the run's


def _run(stage_counts, at=(18.0, 19.8)):
    """Window [10, 20) on the run's clock; one mixed iteration at each
    time of ``at`` (the profiler's clock less OFF), carrying the stage
    counters of ``stage_counts`` in turn, after one the profiler did not
    cover (at 12 s)."""
    sp, iters, marks = [], [Iter(12.0, 12.3, [], [], profiled=False)], []
    for t, counts in zip(at, stage_counts):
        rb = len(sp)
        sp.append(P.PSpan("run_batch", -1, OFF + t, OFF + t + 0.31, {}))
        sp.append(P.PSpan("run_mixed", rb, OFF + t, OFF + t + 0.3,
                          {"lanes_real": 3, **counts}))
        iters.append(Iter(t, t + 0.3, [], [], profiled=True))
        marks += [(TICK, OFF + t, OFF + t + 0.35),
                  (ITER, OFF + t, OFF + t + 0.3)]
    prof = Profile(OFF + at[0], OFF + at[-1] + 0.5, [], marks)
    run = Run(seconds=10.0, w0=10.0, w1=20.0, setup_s=1.0, events=[],
              arrival={}, rounds={}, iters=iters, cfg={}, traffic={},
              profile=prof)
    run.program_spans = sp
    return run


def test_share_of_replayed_stages():
    run = _run([{"stages_replayed": 3, "stages_captured": 1,
                 "stages_eager": 1},
                {"stages_replayed": 5}],
               at=(16.0, 18.0))
    got = bench.reader("graph_replay_frac")(run)
    assert got[0] == pytest.approx(8 / 10) and got[1] == 2
    assert got[2] == {"stages_replayed": 8, "stages_captured": 1,
                      "stages_eager": 1}


def test_iterations_ending_after_the_close_are_left_out():
    # the second iteration ends at 20.1, after the window's close; the
    # unprofiled one at 12 s has no spans to count
    run = _run([{"stages_eager": 2}, {"stages_replayed": 5}])
    got = bench.reader("graph_replay_frac")(run)
    assert got[0] == 0.0 and got[1] == 1


def test_nothing_to_read_without_stage_counters():
    assert bench.reader("graph_replay_frac")(_run([{}, {}])) is None
    run = _run([{}])
    run.program_spans = []
    assert bench.reader("graph_replay_frac")(run) is None
