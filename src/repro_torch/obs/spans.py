"""Host spans and counters inside the port's own serving code, kept in
memory on the profiler's clock.

The copied control plane (``engine/engine.py``, ``core/``, ``kvcache/``,
the rest of ``obs/``) reports through the event bus and carries none of
these: it stays line for line the reference's. The spans sit in the files
the port wrote for itself, at each boundary of one serving iteration::

    run_batch                       engine.torch_runner.TorchBackend
      swap_out, cow, swap_in
      run_mixed                     engine.torch_runner._PagedLayout
        run_mixed.inputs              pack and lane arrays, H2D copies
          context_ids                 TorchBackend._context_ids
        run_mixed.forward             the lm_mixed_paged enqueue
          step.pack, step.decode      models.transformer.lm_mixed_paged
            layer.attn, layer.ffn     lm_prefill_paged / lm_decode_paged
              moe.route, moe.dispatch, moe.experts, moe.combine
        run_mixed.readback            the tokens' .cpu() reads
        run_mixed.commit              the token bookkeeping
      prefill, decode               (the round path, instead of run_mixed)

A span records its name, the index of its parent (a per-thread stack),
its start and end in ns of ``clock()`` and the counters ``count`` added
while it was the innermost open span. ``clock()`` reads the monotonic
clock, so a duration is never negative, shifted by the offset of
``time.time_ns()`` read at import and again at each ``enable()``: the
stamps are on the clock of ``torch.profiler``'s records (kineto stamps
with ``time.time_ns()``), so spans and device records share one time line
unless the wall clock is stepped after that offset was read.

Recording is off by default. It is on while a caller has called
``enable()``, and, for the span of one iteration (``root``, which
``TorchBackend.run_batch`` opens), while ``torch.profiler`` is recording.
The latter exists only because the benchmark's run loop cannot yet call
``enable()`` over its window; it goes once the benchmark does. Off,
``span`` and ``begin`` return the shared ``NOOP`` and ``count`` returns
at once: no clock is read and nothing is allocated. On, a span costs two
clock reads and an entry appended to each of the buffer's lists. The
buffer holds at most ``CAPACITY`` spans (about 100 bytes each) between
two drains; spans past it are counted as dropped, and ``drain()`` hands
over the spans and that count and empties the buffer.

No ``record_function`` range and no NVTX mark is made: a range opened
while CUDA activity is profiled leaves a device-side record that would
read as device work.
"""
from __future__ import annotations

import threading
from time import monotonic_ns, time_ns
from typing import Dict, List, NamedTuple, Tuple

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 19        # records held between two drains


class Span(NamedTuple):
    """One span: ``parent`` indexes the list ``drain`` returned (-1: none);
    ``t0``/``t1`` in ns of ``clock()`` (``t1`` 0 while open)."""
    name: str
    parent: int
    t0: int
    t1: int
    counts: Dict[str, int]


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, t_ns: int) -> None:
        pass


NOOP = _Noop()


class _Stack(threading.local):
    def __init__(self):
        self.open: List[int] = []        # indices of the open spans


_off = time_ns() - monotonic_ns()    # clock() less the monotonic clock
_enabled = False          # enable() / disable()
_on = False               # recording now
# the buffer, one entry per span in each list (no object per span)
_names: List[str] = []
_parents: List[int] = []
_t0: List[int] = []
_t1: List[int] = []
_counts: Dict[int, Dict[str, int]] = {}
_dropped = 0
_tls = _Stack()


def clock() -> int:
    """Now, in ns on the spans' clock."""
    return monotonic_ns() + _off


class _Close:
    """What ``span`` returns: ``with``'s exit closes the innermost span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _t1[_tls.open.pop()] = monotonic_ns() + _off
        return False


_CLOSE = _Close()


class _Handle:
    """What ``begin`` and ``root`` return: closes at ``end(t_ns)``, or at
    ``with``'s exit; either also closes the spans an exception left open
    inside it."""
    __slots__ = ("i", "follow")

    def __init__(self, i: int, follow: bool):
        self.i, self.follow = i, follow

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not _t1[self.i]:
            self.end(clock())
        return False

    def end(self, t_ns: int) -> None:
        global _on
        st = _tls.open
        while st:
            i = st.pop()
            if not _t1[i]:
                _t1[i] = t_ns
            if i == self.i:
                break
        if self.follow:
            _on = _enabled


def _open(name: str, t_ns: int) -> int:
    """Index of the new span, -1 when the buffer is full."""
    global _dropped
    i = len(_names)
    if i >= CAPACITY:
        _dropped += 1
        return -1
    st = _tls.open
    _names.append(name)
    _parents.append(st[-1] if st else -1)
    _t0.append(t_ns)
    _t1.append(0)
    st.append(i)
    return i


def span(name: str):
    """A span from now until ``with``'s exit."""
    if not _on or _open(name, monotonic_ns() + _off) < 0:
        return NOOP
    return _CLOSE


def begin(name: str, t_ns: int):
    """A span from ``t_ns`` (a ``clock()`` the caller read) until its
    ``end(t_ns)``: phases that share their boundaries with the caller's
    own timers."""
    if not _on:
        return NOOP
    i = _open(name, t_ns)
    return NOOP if i < 0 else _Handle(i, False)


def root(name: str, t_ns: int):
    """``begin`` for the span of one iteration: it also records while
    ``torch.profiler`` is recording, and the recording it turned on ends
    with it."""
    global _on
    if _on:
        return begin(name, t_ns)
    if not getattr(_profiler, "_is_profiler_enabled", False):
        return NOOP
    i = _open(name, t_ns)
    if i < 0:
        return NOOP
    _on = True
    return _Handle(i, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span (a
    count outside every span is not kept)."""
    if not _on:
        return
    st = _tls.open
    if st:
        c = _counts.setdefault(st[-1], {})
        c[name] = c.get(name, 0) + n


def enable() -> None:
    """Record from now on; ``clock()`` takes ``time.time_ns()``'s offset
    anew."""
    global _enabled, _on, _off
    _off = time_ns() - monotonic_ns()
    _enabled = _on = True


def disable() -> None:
    global _enabled, _on
    _enabled = _on = False


def drain() -> Tuple[List[Span], int]:
    """The spans recorded since the last drain, in the order they opened,
    and how many were dropped for want of room; empties the buffer.
    Raises inside an open span."""
    global _names, _parents, _t0, _t1, _counts, _dropped
    if _tls.open:
        raise RuntimeError("drain() inside an open span")
    out = [Span(*rec, _counts.get(i, {})) for i, rec in
           enumerate(zip(_names, _parents, _t0, _t1))]
    dropped = _dropped
    _names, _parents, _t0, _t1 = [], [], [], []
    _counts, _dropped = {}, 0
    return out, dropped
