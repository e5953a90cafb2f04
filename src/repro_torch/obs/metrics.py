"""Metrics plane: counters, gauges and fixed-bucket histograms behind one
snapshot/export API.

The repo grew ad-hoc counters wherever a subsystem needed one — ``Telemetry``
(offload/prefix/digest counters), ``SwapStream`` (per-direction transfer
counts), ``TieredStore.stats()``, ``ClusterRouter.events`` — each with its
own read path. The :class:`MetricsRegistry` absorbs them behind *probes*:
a probe is a callable returning a dict, registered once and re-run at every
``snapshot()``, so live sources keep owning their counters (tests read them
directly, unchanged) while dashboards and exporters read one tree.

Histograms are fixed-bucket (log-spaced bounds by default): ``observe`` is
O(log buckets) and percentiles (p50/p95/p99) come from linear interpolation
inside the covering bucket — no sample retention, so a 10k-session soak
costs the same memory as a 10-session smoke.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Callable, Dict, List, Optional, Sequence


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written instantaneous value — or, with ``set_fn``, a live
    view: the callable is re-read at every ``snapshot()``, so sources
    that already own their counter (e.g. the EventBus ring's ``dropped``)
    surface without a copy-on-write hook in their hot path."""

    __slots__ = ("value", "_fn")

    def __init__(self):
        self.value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        self.value = v
        self._fn = None

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def read(self) -> float:
        if self._fn is not None:
            self.value = self._fn()
        return self.value


def log_bounds(lo: float = 1e-4, hi: float = 1e4,
               per_decade: int = 4) -> List[float]:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    n = int(round(per_decade * math.log10(hi / lo)))
    return [lo * (hi / lo) ** (i / n) for i in range(n + 1)]


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``bounds`` are bucket *upper* bounds; an extra overflow bucket catches
    values beyond the last bound (its percentile contribution is clamped to
    the largest observed value, so a stray outlier cannot report +inf).
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds = sorted(bounds) if bounds else log_bounds()
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0, 1]); 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= rank and c > 0:
                lo = self.bounds[i - 1] if i > 0 else min(self.min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max) if self.max > -math.inf else hi
                if hi <= lo:
                    return lo
                frac = (rank - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.max

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min, "max": self.max,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Get-or-create named metrics + registered live-source probes.

    Naming convention (see ROADMAP "Observability"): dot-separated
    ``<subsystem>.<noun>[_<unit>]`` — e.g. ``trace.e2e_s``,
    ``swap_stream.d2h_seconds``, ``router.requeue_depth``. Histogram names
    carry their unit suffix (``_s`` seconds, ``_tok`` tokens, ``_blocks``).
    """

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self._probes: Dict[str, Callable[[], Optional[dict]]] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(bounds)
        return h

    def register_probe(self, name: str,
                       fn: Callable[[], Optional[dict]]) -> None:
        """``fn`` re-runs at every snapshot; a None return drops the key
        (source not configured — e.g. no swap stream on the sim path)."""
        self._probes[name] = fn

    def snapshot(self) -> dict:
        out: dict = {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.read() for k, g in self.gauges.items()},
            "histograms": {k: h.snapshot()
                           for k, h in self.histograms.items()},
        }
        for name, fn in self._probes.items():
            v = fn()
            if v is not None:
                out[name] = v
        return out

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, default=str)


def bind_engine_probes(reg: MetricsRegistry, engine) -> None:
    """Absorb an engine's ad-hoc counter surfaces into ``reg``:

    * ``telemetry`` — the dual-pressure snapshot (flags, churn EMA, offload
      /prefix/digest counters, per-kind tool EMAs)
    * ``kv_tiers`` — ``Telemetry.kv_tier_stats()`` (TieredStore breakdown)
    * ``cpu_pool`` — shared host-core pool gauges (lease counts, busy and
      queue-wait seconds per kind, peak backlog/stretch)
    * ``swap_stream`` — live-backend background stream counters + queue
      depth (absent on the sim path)
    * ``dispatch`` — live-path run_batch phase timing (absent in sim)
    """
    telem = engine.telem

    def _telemetry():
        return {
            "free_blocks": telem.free_blocks,
            "total_blocks": telem.total_blocks,
            "pinned_blocks": telem.pinned_blocks,
            "kv_utilization": round(telem.kv_utilization, 4),
            "active_sessions": telem.active_sessions,
            "running_decodes": telem.running_decodes,
            "active_tools": telem.active_tools,
            "cpu_overloaded": telem.cpu_overloaded,
            "kv_overloaded": telem.kv_overloaded,
            "churn_ema_blocks": round(telem.churn_ema, 3),
            "offload_stores": telem.offload_stores,
            "offload_hits": telem.offload_hits,
            "prefix_queries": telem.prefix_queries,
            "prefix_hits": telem.prefix_hits,
            "prefix_hit_tokens": telem.prefix_hit_tokens,
            "digest_anchors": telem.digest_anchors,
            "digest_indexed_blocks": telem.digest_indexed_blocks,
            "tool_ema_s": {k: round(v, 3)
                           for k, v in telem.tool_ema.items()},
        }

    reg.register_probe("telemetry", _telemetry)
    reg.register_probe("kv_tiers", telem.kv_tier_stats)
    pool = getattr(engine, "cpu_pool", None)
    if pool is not None:
        reg.register_probe("cpu_pool", pool.stats)
    stream_stats = getattr(engine.backend, "swap_stream_stats", None)
    if stream_stats is not None:
        reg.register_probe("swap_stream", stream_stats)
    dispatch = getattr(engine.backend, "dispatch_stats", None)
    if dispatch is not None:
        reg.register_probe("dispatch", lambda: dict(dispatch))
    reg.register_probe(
        "events", lambda: {"counts": dict(engine.bus.counts),
                           "dropped": engine.bus.dropped})
    # the ring's eviction count as a first-class gauge: dashboards alert on
    # it directly (dropped > 0 voids the exclusive-timeline invariant — see
    # obs.detect's event_loss incident and trace_report --strict)
    reg.gauge("events.dropped").set_fn(lambda: float(engine.bus.dropped))


def bind_router_probe(reg: MetricsRegistry, router) -> None:
    """Absorb the cluster router's membership/placement/requeue counters
    and heartbeat-digest prefix stats."""
    reg.register_probe("router", router.stats)
    reg.register_probe("cluster_prefix", router.cluster_prefix_stats)
