"""Background swap stream: KV page copies off the engine's critical path.

MARS's retention policy only pays off if offload is cheap relative to
recompute, yet a swapper that serializes every D2H/H2D page copy inside the
engine step inflates the very swap cost ``retention_decision`` prices. This
module provides the asynchronous alternative (InferCept-style swap-out, plus
prefetched swap-in):

* :class:`TransferFuture` — the completion handle for one host<->device
  transfer. ``HostTier.ready`` gates restorability on it (the sim path keeps
  the modeled ``ready_at`` as its "future"); the engine defers — never
  stalls on — a session whose swap-in future is unresolved.

* :class:`StagingBuffers` — double-buffered staging, keyed on the swap
  record's block list: at most ``n`` (default 2) transfers hold device-side
  staging snapshots at once. A further submit blocks until a buffer retires
  (backpressure bounds staging memory); while one buffer drains over PCIe
  the other fills — which is exactly the copy/compute overlap a dedicated
  DMA stream gives on real hardware. Slots are identities rather than
  preallocated byte ranges because swap records vary in page count; what
  the pair bounds is transfers in flight, not bytes.

* :class:`SwapStream` — a single worker thread executing transfer jobs in
  submission order. FIFO matters: a swap-out drain for a sid re-offloaded
  after a drop must land after the stale drain, and an H2D prefetch can
  never starve behind slot-holding D2H jobs submitted later (slot holders
  are always ahead of it in the queue).

The stream executes *host crossings* only. Device-side snapshot gathers
stay on the submitting thread, ordered by the JAX dispatch stream before
any subsequent cache writes — that ordering is what makes it safe for a
swapped-out block id to be re-leased and rewritten in the very tick whose
batch carries the swap-out.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional


class TransferFuture:
    """Completion handle for one host<->device KV transfer.

    ``done()`` is the only query the engine needs (deferral is polling, not
    blocking); ``result()`` blocks and re-raises the worker's exception, so
    a failed transfer surfaces at the consumer instead of vanishing on the
    worker thread.
    """

    __slots__ = ("sid", "direction", "_event", "_result", "_exc")

    def __init__(self, sid: int = -1, direction: str = "d2h"):
        self.sid = sid
        self.direction = direction
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"transfer {self.direction} sid={self.sid} still in flight")
        if self._exc is not None:
            raise self._exc
        return self._result

    # worker-side
    def _resolve(self, value) -> None:
        self._result = value
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()


def resolved_future(sid: int = -1, direction: str = "d2h",
                    value=None) -> TransferFuture:
    """An already-completed transfer (e.g. a swap record with no private
    blocks: nothing crosses PCIe, but the handshake still wants a future)."""
    fut = TransferFuture(sid, direction)
    fut._resolve(value)
    return fut


class StagingBuffers:
    """Double-buffered staging slots with blocking backpressure.

    ``acquire`` is called by the submitter *before* it snapshots device
    pages (the snapshot is what occupies staging memory); ``release`` by
    the worker once the crossing retired the buffer. Stats are plain
    counters read by tests and the benchmark.
    """

    def __init__(self, n: int = 2):
        assert n >= 1
        self.n = n
        self._free: List[int] = list(range(n))
        self._cv = threading.Condition()
        self._used_once: set = set()
        self.acquires = 0
        self.reuses = 0            # slot handed out again after retiring
        self.blocked_waits = 0     # submits that hit backpressure
        self.max_in_flight = 0

    def acquire(self) -> int:
        with self._cv:
            if not self._free:
                self.blocked_waits += 1
            while not self._free:
                self._cv.wait()
            slot = self._free.pop()
            self.acquires += 1
            if slot in self._used_once:
                self.reuses += 1
            self._used_once.add(slot)
            in_flight = self.n - len(self._free)
            self.max_in_flight = max(self.max_in_flight, in_flight)
            return slot

    def release(self, slot: int) -> None:
        with self._cv:
            assert slot not in self._free, f"double release of slot {slot}"
            self._free.append(slot)
            self._cv.notify()


class SwapStream:
    """Single background worker executing transfer jobs in FIFO order."""

    def __init__(self, n_buffers: int = 2, name: str = "kv-swap-stream", *,
                 cpu_pool=None):
        self.staging = StagingBuffers(n_buffers)
        # shared host-CPU core pool (live accounting): the worker holds one
        # core while a crossing's copy pump executes, so pool gauges see
        # real transfer CPU alongside tool threads. None => untracked.
        self.cpu_pool = cpu_pool
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=name)
        self._started = False
        self._closed = False
        self._lock = threading.Lock()
        # stats (benchmark / tests); h2n/n2h are the NVMe tier's
        # spill/fill crossings (host DRAM <-> disk spool)
        self.d2h_submitted = 0
        self.d2h_completed = 0
        self.h2d_submitted = 0
        self.h2d_completed = 0
        self.h2n_submitted = 0
        self.h2n_completed = 0
        self.n2h_submitted = 0
        self.n2h_completed = 0
        # per-direction transfer wall time (seconds executing on the
        # worker, queue wait excluded) — the observability layer's
        # MetricsRegistry snapshots these alongside queue_depth()
        self.xfer_seconds: Dict[str, float] = dict.fromkeys(
            ("d2h", "h2d", "h2n", "n2h"), 0.0)
        self.xfer_max_s: Dict[str, float] = dict.fromkeys(
            ("d2h", "h2d", "h2n", "n2h"), 0.0)

    DIRECTIONS = ("d2h", "h2d", "h2n", "n2h")

    def queue_depth(self) -> int:
        """Jobs submitted but not yet executed (approximate: the worker's
        in-progress job has already left the queue)."""
        return self._q.qsize()

    def stats(self) -> Dict[str, object]:
        """One-shot counter snapshot for metrics export."""
        out: Dict[str, object] = {"queue_depth": self.queue_depth()}
        for d in self.DIRECTIONS:
            out[f"{d}_submitted"] = getattr(self, f"{d}_submitted")
            out[f"{d}_completed"] = getattr(self, f"{d}_completed")
            out[f"{d}_seconds"] = self.xfer_seconds[d]
            out[f"{d}_max_s"] = self.xfer_max_s[d]
        st = self.staging
        out["staging"] = {"acquires": st.acquires, "reuses": st.reuses,
                          "blocked_waits": st.blocked_waits,
                          "max_in_flight": st.max_in_flight}
        return out

    def submit(self, fn: Callable[[], object], *, sid: int = -1,
               direction: str = "d2h") -> TransferFuture:
        """Enqueue ``fn`` on the worker; returns its completion future.
        ``fn`` owns releasing any staging slot it (or its submitter)
        acquired — the stream never sees slots, only jobs."""
        assert direction in self.DIRECTIONS
        fut = TransferFuture(sid, direction)
        with self._lock:
            assert not self._closed, "submit on a closed SwapStream"
            setattr(self, f"{direction}_submitted",
                    getattr(self, f"{direction}_submitted") + 1)
            if not self._started:
                self._thread.start()
                self._started = True
        self._q.put((fn, fut))
        return fut

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            pool, tok = self.cpu_pool, None
            if pool is not None:
                kind = "swap" if fut.direction in ("d2h", "h2d") else "spool"
                tok = pool.acquire(time.monotonic(), kind)
            try:
                t0 = time.monotonic()
                value = fn()
                # count before resolving: a consumer woken by result()
                # must never observe a stale completion counter
                if fut.direction in self.DIRECTIONS:
                    dt = time.monotonic() - t0
                    self.xfer_seconds[fut.direction] += dt
                    if dt > self.xfer_max_s[fut.direction]:
                        self.xfer_max_s[fut.direction] = dt
                    setattr(self, f"{fut.direction}_completed",
                            getattr(self, f"{fut.direction}_completed") + 1)
                fut._resolve(value)
            except BaseException as exc:          # surfaces at result()
                fut._fail(exc)
            finally:
                if tok is not None:
                    pool.release(time.monotonic(), tok)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted job has executed (tests/teardown)."""
        if not self._started:
            return
        done = TransferFuture(-1, "drain")       # not a transfer: uncounted
        self._q.put((lambda: None, done))
        done.result(timeout)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if started:
            self._q.put(None)
            self._thread.join(timeout=5.0)
