"""Dual-pressure telemetry (paper §4.1): the consistent cross-plane view that
admission control and the internal scheduler both consume.

GPU-plane pressure is reported in the allocator's *native unit* — KV blocks —
via an O(1) probe of the block pool (never byte counters; paper argues bytes
obscure allocator granularity). CPU-plane pressure is characterized without
hardware instrumentation by (a) the number of in-flight tool invocations and
(b) per-kind EMA of observed tool durations.

``cpu_overloaded`` / ``kv_overloaded`` carry hysteresis: a plane must stay
past its threshold for ``hysteresis_checks`` consecutive ``tick()`` calls to
flip, and below it for the same count to clear, preventing admit/stop
oscillation. Probes (``probe_gpu`` etc.) only refresh raw readings; the
hysteresis counters and the churn-EMA decay advance on the explicit
``tick()`` the engine loop calls exactly once per iteration — flag cadence
is the engine's, not whatever cadence the GPU probe happens to run at.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core import events as ev
from repro_torch.core.events import EventBus


@dataclass
class TelemetryConfig:
    cpu_slots: int = 16                 # host cores available for tools
    cpu_overload_factor: float = 1.0    # overloaded if active >= slots*factor
    kv_overload_frac: float = 0.92      # pool utilization threshold (soft cap)
    kv_slack_frac: float = 0.80         # below this there is "slack"
    kv_churn_frac: float = 0.02         # churn EMA > frac*pool => overloaded
    hysteresis_checks: int = 3
    tool_ema_alpha: float = 0.3
    default_tool_seconds: float = 8.0


class Telemetry:
    """Aggregates the unified info stream into the dual-pressure snapshot."""

    def __init__(self, cfg: TelemetryConfig, bus: EventBus):
        self.cfg = cfg
        self.bus = bus
        # GPU plane (updated by the engine's O(1) block-pool probe)
        self.total_blocks = 1
        self.free_blocks = 1
        self.pinned_blocks = 0
        self.active_sessions = 0
        self.running_decodes = 0
        self.waiting_prefill_blocks = 0   # projected demand of admitted queue
        # CPU plane
        self.active_tools = 0
        self.tool_ema: Dict[str, float] = {}
        self._cpu_hot = 0
        self._cpu_cold = 0
        self._kv_hot = 0
        self._kv_cold = 0
        self.cpu_overloaded = False
        self.kv_overloaded = False
        self.last_window_update = -1e18
        # KV churn (preemption loss) EMA, in blocks — the congestion signal
        self.churn_ema = 0.0
        self._churn_accum = 0.0
        # host-DRAM offload tier (kvcache.host_tier)
        self.host_capacity_blocks = 0
        self.host_used_blocks = 0
        self.offload_stores = 0
        self.offload_hits = 0
        # tiered-store breakdown (kvcache.tiers): per-tier occupancy /
        # hit-rate snapshot plus migration counters, None until probed
        self.tier_stats: Optional[Dict] = None
        # cross-session prefix sharing (kvcache.radix)
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        # radix-root digest summary (what this replica advertises to the
        # cluster router for family-aware placement)
        self.digest_anchors = 0
        self.digest_indexed_blocks = 0
        self.digest_version = 0
        bus.subscribe(ev.TOOL_START, self._on_tool_start)
        bus.subscribe(ev.TOOL_END, self._on_tool_end)
        bus.subscribe(ev.PREEMPT, self._on_preempt)

    # --- event consumers ---------------------------------------------------
    def _on_tool_start(self, e) -> None:
        self.active_tools += 1

    def _on_tool_end(self, e) -> None:
        self.active_tools = max(0, self.active_tools - 1)
        kind = e.data.get("kind", "default")
        dur = float(e.data.get("duration", self.cfg.default_tool_seconds))
        a = self.cfg.tool_ema_alpha
        prev = self.tool_ema.get(kind)
        self.tool_ema[kind] = dur if prev is None else (1 - a) * prev + a * dur

    def _on_preempt(self, e) -> None:
        self._churn_accum += e.data.get("blocks", 0)

    # --- probes --------------------------------------------------------------
    def probe_gpu(self, total: int, free: int, pinned: int, active_sessions: int,
                  running_decodes: int, waiting_blocks: int) -> None:
        self.total_blocks = max(1, total)
        self.free_blocks = free
        self.pinned_blocks = pinned
        self.active_sessions = active_sessions
        self.running_decodes = running_decodes
        self.waiting_prefill_blocks = waiting_blocks

    def tick(self) -> None:
        """Advance hysteresis counters and decay the churn EMA — called by
        the engine once per tick (probes may run any number of times in
        between without skewing the flag cadence)."""
        self._update_flags()

    def _update_flags(self) -> None:
        c = self.cfg
        cpu_hot = self.active_tools >= c.cpu_slots * c.cpu_overload_factor
        # KV overload = sustained preemption churn (loss-based congestion
        # signal, like TCP): merely-full pools are healthy, thrashing is not.
        self.churn_ema = 0.9 * self.churn_ema + 0.1 * self._churn_accum
        self._churn_accum = 0.0
        kv_hot = self.churn_ema > c.kv_churn_frac * self.total_blocks
        self._cpu_hot = self._cpu_hot + 1 if cpu_hot else 0
        self._cpu_cold = self._cpu_cold + 1 if not cpu_hot else 0
        self._kv_hot = self._kv_hot + 1 if kv_hot else 0
        self._kv_cold = self._kv_cold + 1 if not kv_hot else 0
        if self._cpu_hot >= c.hysteresis_checks:
            self.cpu_overloaded = True
        if self._cpu_cold >= c.hysteresis_checks:
            self.cpu_overloaded = False
        if self._kv_hot >= c.hysteresis_checks:
            self.kv_overloaded = True
        if self._kv_cold >= c.hysteresis_checks:
            self.kv_overloaded = False

    def probe_host(self, used_blocks: int, capacity_blocks: int,
                   stores: int, hits: int) -> None:
        """Host-tier occupancy + hit-rate snapshot (same O(1) discipline as
        the GPU probe: counters only, no byte math)."""
        self.host_used_blocks = used_blocks
        self.host_capacity_blocks = capacity_blocks
        self.offload_stores = stores
        self.offload_hits = hits

    def probe_tiers(self, stats: Optional[Dict]) -> None:
        """Snapshot of the TieredStore breakdown (see ``kvcache.tiers``):
        per-tier occupancy, hit rates, demotions, staged restores."""
        self.tier_stats = stats

    def kv_tier_stats(self) -> Dict:
        """Per-tier KV-state breakdown for dashboards and benchmarks:
        occupancy, hit rate, demotions and staged restores per tier. Falls
        back to the flat host-tier counters when no TieredStore probe has
        landed (host-only or legacy configurations)."""
        if self.tier_stats is not None:
            return self.tier_stats
        return {
            "host": {
                "used_blocks": self.host_used_blocks,
                "capacity_blocks": self.host_capacity_blocks,
                "occupancy": self.host_occupancy,
                "stores": self.offload_stores,
                "hits": self.offload_hits,
                "hit_rate": round(self.offload_hit_rate, 4),
                "drops": 0,
            },
            "disk": None,
            "demotions": 0,
            "staged_restores": 0,
            "direct_to_disk": 0,
        }

    def probe_prefix(self, queries: int, hits: int, hit_tokens: int) -> None:
        self.prefix_queries = queries
        self.prefix_hits = hits
        self.prefix_hit_tokens = hit_tokens

    def probe_digest(self, digest: Optional[dict]) -> None:
        """Snapshot of the exported radix-root digest (see kvcache.radix):
        how much shareable state this replica advertises cluster-wide."""
        if not digest:
            self.digest_anchors = 0
            self.digest_indexed_blocks = 0
            self.digest_version = 0
            return
        self.digest_anchors = len(digest.get("anchors") or {})
        self.digest_indexed_blocks = digest.get("indexed_blocks", 0)
        self.digest_version = digest.get("v", 0)

    # --- derived -------------------------------------------------------------
    @property
    def kv_utilization(self) -> float:
        return 1.0 - self.free_blocks / self.total_blocks

    @property
    def prefix_hit_rate(self) -> float:
        """Sharing sessions per index-consulting session (≤ 1 by the
        record_query/record_hit discipline in kvcache.radix)."""
        return self.prefix_hits / max(1, self.prefix_queries)

    @property
    def host_occupancy(self) -> float:
        return self.host_used_blocks / max(1, self.host_capacity_blocks)

    @property
    def offload_hit_rate(self) -> float:
        return self.offload_hits / max(1, self.offload_stores)

    def has_kv_slack(self) -> bool:
        """Healthy = low churn (a full-but-stable pool is slack for AIMD
        purposes; actual capacity gating is the soft cap in calc_kv_limit)."""
        return self.churn_ema < 0.5 * self.cfg.kv_churn_frac * self.total_blocks

    def tool_estimate(self, kind: Optional[str]) -> float:
        if kind is None:
            return 0.0
        return self.tool_ema.get(kind, self.cfg.default_tool_seconds)

    def calc_cpu_limit(self) -> int:
        """Admission cap derived from host tool capacity: sessions spend a
        fraction of wall time in tools; the host sustains ~slots concurrent
        tools, so cap concurrent sessions at slots / duty + headroom."""
        c = self.cfg
        free_tool_slots = max(0, c.cpu_slots - self.active_tools)
        return self.active_sessions + free_tool_slots + c.cpu_slots

    def calc_kv_limit(self, avg_blocks_per_session: float) -> int:
        """Soft KV cap (paper: progressive, not binary): admission headroom
        shrinks smoothly as pool utilization approaches the slack target.
        Sessions interleave GPU and tool phases, so the cap is *not*
        sum-of-full-footprints — it grants concurrency proportional to the
        remaining headroom fraction and lets AIMD react to actual overload."""
        c = self.cfg
        # capacity guard-rail with bounded overcommit: sessions alternate GPU
        # and tool phases, so pool-capacity concurrency alone would idle the
        # GPU during tools (x4 covers typical tool duty cycles). The
        # *adaptive* actuator is the AIMD window reacting to churn — this cap
        # only bounds worst-case oversubscription against huge sessions.
        cap_sessions = 4.0 * self.total_blocks / max(1.0, avg_blocks_per_session)
        headroom = max(0.0, c.kv_overload_frac - self.kv_utilization) \
            / c.kv_overload_frac
        extra = headroom * self.total_blocks / max(1.0, avg_blocks_per_session)
        return max(1, int(round(cap_sessions + extra)))
