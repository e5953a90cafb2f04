"""Opportunistic Co-Scheduler (paper §4.3).

Two mechanisms:

* **Chunk shrinking** — when a selected prefill cannot be placed, the
  requested chunk is halved until the allocator can fit it (down to a single
  block) instead of jumping to destructive eviction: transient fragmentation
  becomes a temporary reduction in service granularity.

* **Adaptive KV retention** — at a tool boundary, KV is pinned only while

      warm_resume_benefit  >  residency_cost

  where benefit = prefix recompute time avoided, and cost = the opportunity
  cost of the held blocks over the tool's (EMA-estimated) remaining duration,
  priced by current demand pressure. Unlike InferCept/Continuum this is NOT a
  one-shot decision at invocation time: it is re-evaluated every tick, so a
  pin made under slack is revoked when pressure arrives. Pinned contexts are
  reclaimed (lowest retention score first) before any running victim is
  preempted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.session import KVAction, Session
from repro_torch.core.telemetry import Telemetry


@dataclass
class CoSchedulerConfig:
    token_budget: int = 8_192          # per-tick token budget (prefill+decode)
    max_decode_batch: int = 256
    decode_granularity: int = 8        # decode tokens per scheduling quantum
    min_chunk_tokens: int = 32         # = one KV block
    # iteration-level (mixed) batching: cap on the prefill share of one
    # iteration's token budget. Decode lanes are formed first and always
    # fit (1 token each); prefill chunks then fill min(what the decodes
    # left, prefill_budget_frac * budget) — a prefill-heavy arrival wave
    # can at worst double the iteration's token count, never monopolize it
    # (Sarathi-Serve's stall-free chunked-prefill split).
    prefill_budget_frac: float = 0.5
    # retention price scale: the per-session stall attribution double-counts
    # when several sessions pin concurrently (each gets blamed for the same
    # shortfall); 0.25 was calibrated by sweep — mean latency -28% on H200 /
    # -6% on H100 at ILR-2 with unchanged TTFT (EXPERIMENTS.md §Reproduction).
    pin_price_scale: float = 0.25
    block_size: int = 32
    # three-way retention (host-DRAM tier). Offload pays one PCIe round trip
    # but holds zero HBM: it wins exactly when recompute is expensive while
    # pressure makes pinning too costly.
    enable_offload: bool = True
    offload_price: float = 0.5       # swap-out fraction charged (DMA/PCIe use)
    offload_min_tokens: int = 4_096  # tiny contexts: recompute is cheaper
    # four-way retention (NVMe cold tier). Disk holds neither HBM nor DRAM
    # but restores in two staged hops (NVMe read gates readiness, then the
    # PCIe swap-in): it wins on long idle windows — CI runs, human waits —
    # where parking the bytes in DRAM wastes the warmer tier's capacity.
    enable_disk: bool = True
    disk_price: float = 0.5          # staged write path fraction charged
    disk_min_tokens: int = 8_192     # NVMe op latency: small contexts recompute
    disk_idle_min_s: float = 45.0    # expected tool time beyond which DRAM
    #                                  parking is wasteful and disk preferred


class OpportunisticCoScheduler:
    def __init__(self, cfg: CoSchedulerConfig, telem: Telemetry,
                 recompute_time_fn: Callable[[int], float],
                 prefill_rate_fn: Optional[Callable[[], float]] = None):
        """``recompute_time_fn(n_tokens)`` -> seconds to rebuild that prefix;
        ``prefill_rate_fn()`` -> sustainable prefill tokens/s (both supplied
        by the execution backend's perf oracle)."""
        self.cfg = cfg
        self.telem = telem
        self.recompute_time = recompute_time_fn
        self.prefill_rate = prefill_rate_fn or (lambda: 10_000.0)
        # host-tier PCIe cost model, bound by the engine once the tier
        # exists (None => no offload tier => binary pin/drop retention)
        self.swap_seconds: Optional[Callable[[int], float]] = None
        # per-block offload sizing: session -> tokens that actually cross
        # PCIe (private blocks only; radix-shared prefix stays on device).
        # None => whole-context pricing (pre-paged swapper semantics).
        self.swap_tokens: Optional[Callable] = None
        # async swap stream: when the backend prefetches H2D swap-ins on a
        # background worker, the restore overlaps the other sessions'
        # compute and stops serializing a GPU tick — only the priced
        # DMA/PCIe occupancy share of the transfer remains a cost.
        self.swap_in_overlapped: bool = False
        # NVMe cold-tier cost model, bound by the engine when the disk tier
        # exists (None => three-way retention, no OFFLOAD_DISK outcome)
        self.disk_read_seconds: Optional[Callable[[int], float]] = None
        self.disk_write_seconds: Optional[Callable[[int], float]] = None
        # CPU-side transfer delay, bound when a shared core pool exists:
        # ``cpu_wait(transfer_s, now)`` -> projected seconds the restore's
        # staging copy would queue for a host core right now. Warm
        # resumption is only chosen when the CPU side can deliver it — the
        # projected wait is subtracted from the offload/disk nets.
        self.cpu_wait: Optional[Callable[[float, float], float]] = None
        # the three nets behind the most recent retention_decision — the
        # observability audit reads this stash instead of re-running the
        # (swap-sizing, hence expensive) pricing a second time
        self.last_prices: dict = {}

    # --- chunk shrinking ------------------------------------------------------
    def shrink_chunk(self, want_tokens: int, free_blocks: int) -> int:
        """Largest admissible prefill chunk <= want under current free blocks;
        halves down to single-block granularity; 0 if not even one block."""
        bs = self.cfg.block_size
        if want_tokens <= 0 or free_blocks <= 0:
            return 0
        chunk = want_tokens
        while chunk >= self.cfg.min_chunk_tokens:
            if -(-chunk // bs) <= free_blocks:
                return chunk
            chunk //= 2
        return min(bs, want_tokens)   # single-block granularity floor

    def split_budget(self, token_budget: int, decode_tokens: int) -> int:
        """Prefill token budget for one mixed iteration: what the decode
        lanes left of the budget, capped at ``prefill_budget_frac`` of the
        whole — decode continuations are never starved by a prefill wave,
        and a wave can never inflate the iteration beyond the frac cap."""
        left = max(0, token_budget - decode_tokens)
        return min(left, int(token_budget * self.cfg.prefill_budget_frac))

    # --- retention ------------------------------------------------------------
    def retention_score(self, s: Session, now: float) -> float:
        """benefit - cost, in seconds of GPU work. Positive => keep pinned.

        benefit = prefix recompute time avoided on warm resume.
        cost    = prefill stall inflicted on waiting work while the blocks are
                  held: waiting builders are *rate-limited* (they can consume
                  at most prefill_rate tokens/s), so holding blocks only hurts
                  to the extent demand-within-the-tool-window exceeds what
                  stays free. shortfall_blocks * block_size / prefill_rate is
                  exactly the stall time those blocks' absence causes.
        """
        t = self.telem
        benefit = self.recompute_time(s.resident_len)
        est = t.tool_estimate(s.cur.tool_kind)
        elapsed = max(0.0, now - s.tool_started)
        # hazard-aware residual: agentic tool durations are heavy-tailed, so
        # once a tool has overrun its estimate, the expected residual grows
        # with elapsed time (lognormal hazard) rather than shrinking to zero.
        # This is what makes the per-tick re-evaluation meaningful: a pin made
        # expecting a short tool is revoked as the tool reveals itself long.
        remaining = (est - elapsed) if elapsed <= est else 0.6 * elapsed
        rate = max(1.0, self.prefill_rate())            # tokens / s
        consumable = remaining * rate / self.cfg.block_size
        demand = min(float(t.waiting_prefill_blocks), consumable)
        shortfall = max(0.0, demand - float(t.free_blocks))
        # Holding b blocks denies them to the blocked share of demand for the
        # whole residual tool duration: stall inflicted ~= remaining x
        # (blocks this pin withholds / rate-limited demand). Under slack
        # (shortfall 0) the cost vanishes; across a long tool it grows
        # linearly with the residual, which is what makes the per-tick
        # re-evaluation revoke pins on overrunning tools.
        inflicted = min(shortfall, float(s.kv_blocks))
        cost = self.cfg.pin_price_scale * remaining * inflicted \
            / max(demand, 1.0)
        return benefit - cost

    def should_pin(self, s: Session, now: float) -> bool:
        return self.retention_score(s, now) > 0.0

    # --- three-way retention --------------------------------------------------
    def offload_net(self, s: Session, now: float) -> float:
        """Net benefit (seconds) of parking this KV in host DRAM instead of
        dropping it: warm restore avoids the prefix recompute but pays one
        synchronous PCIe swap-in, plus a priced share of the (asynchronous)
        swap-out for DMA/PCIe occupancy. Residency cost in HBM is zero —
        that is the whole point of the tier."""
        if (not self.cfg.enable_offload or self.swap_seconds is None
                or s.resident_len < self.cfg.offload_min_tokens):
            return float("-inf")
        # the restore avoids recomputing the WHOLE prefix, but per-block
        # offload only pays PCIe for the private suffix — shared blocks
        # are re-referenced on device for free
        moved = (self.swap_tokens(s) if self.swap_tokens is not None
                 else s.resident_len)
        t_swap = self.swap_seconds(moved)
        # serialized swapper: the restore blocks a GPU tick for t_swap.
        # async stream: the H2D prefetch overlaps other sessions' compute,
        # so no GPU time is lost to the restore itself.
        serialized = 0.0 if self.swap_in_overlapped else t_swap
        # CPU contention: the restore's staging copy queues for a shared
        # host core — under a tool burst that wait delays the warm resume
        # whether or not the DMA itself is overlapped
        cpu_delay = self.cpu_wait(t_swap, now) if self.cpu_wait else 0.0
        benefit = self.recompute_time(s.resident_len) - serialized - cpu_delay
        return benefit - self.cfg.offload_price * t_swap

    def disk_net(self, s: Session, now: float) -> float:
        """Net benefit (seconds) of parking this KV on the NVMe cold tier:
        a warm (if slow) resume avoids the prefix recompute but pays the
        *staged* two-hop restore — the NVMe read gates readiness (the
        session waits it out, subtracted from the benefit) and the PCIe
        swap-in serializes a tick unless the async stream overlaps it —
        plus a priced share of the staged write path (D2H + NVMe write)
        for DMA/device occupancy. Residency cost in both HBM *and* DRAM is
        zero — that is what the cold tier buys."""
        if (not self.cfg.enable_disk or self.disk_read_seconds is None
                or self.swap_seconds is None
                or s.resident_len < self.cfg.disk_min_tokens):
            return float("-inf")
        moved = (self.swap_tokens(s) if self.swap_tokens is not None
                 else s.resident_len)
        t_up = self.swap_seconds(moved)          # hop 2: DRAM -> HBM
        t_read = self.disk_read_seconds(moved)   # hop 1: NVMe -> DRAM
        serialized = 0.0 if self.swap_in_overlapped else t_up
        # CPU contention: both staged hops (spool fill pump + H2D staging)
        # queue for shared host cores before the session can resume warm
        cpu_delay = (self.cpu_wait(t_read + t_up, now)
                     if self.cpu_wait else 0.0)
        benefit = (self.recompute_time(s.resident_len) - serialized - t_read
                   - cpu_delay)
        t_write = self.disk_write_seconds(moved) + t_up
        return benefit - self.cfg.disk_price * t_write

    def retention_decision(self, s: Session, now: float) -> KVAction:
        """PIN / OFFLOAD (host) / OFFLOAD_DISK / FREE by comparing
        recompute time, one-hop and staged two-hop restore time, and
        pressure-priced HBM residency (paper §4.3, extended). PIN wins
        ties: under slack its residency cost vanishes while any offload
        pays a transfer. Between the off-device tiers, host DRAM wins
        unless the expected idle window is long (``disk_idle_min_s`` of
        EMA-estimated tool time) — heavy-tailed agentic tools (CI runs,
        human-in-the-loop waits) are exactly where burning scarce DRAM on
        a multi-minute wait loses to the cold tier."""
        pin_net = self.retention_score(s, now)
        off_net = self.offload_net(s, now)
        dsk_net = self.disk_net(s, now)
        self.last_prices = {"pin_net": pin_net, "offload_net": off_net,
                            "disk_net": dsk_net}
        if pin_net > 0.0 and pin_net >= off_net and pin_net >= dsk_net:
            return KVAction.PIN
        if dsk_net > 0.0:
            long_idle = (self.telem is not None and
                         self.telem.tool_estimate(s.cur.tool_kind)
                         >= self.cfg.disk_idle_min_s)
            if long_idle or off_net <= 0.0:
                return KVAction.OFFLOAD_DISK
        if off_net > 0.0:
            return KVAction.OFFLOAD
        return KVAction.FREE

    def revoke_actions(self, pinned: Sequence[Session], now: float
                       ) -> List[Tuple[Session, KVAction]]:
        """Per-tick re-evaluation, four-way: pins whose retention score went
        negative are revoked — to host DRAM (or the NVMe cold tier, on long
        idle windows) while retention still nets positive, to a drop
        otherwise."""
        out: List[Tuple[Session, KVAction]] = []
        for s in pinned:
            d = self.retention_decision(s, now)
            if d != KVAction.PIN:
                out.append((s, d))
        return out

    def reclaim_order(self, pinned: Sequence[Session], now: float) -> List[Session]:
        """Pinned sessions in reclaim order (lowest retention score first)."""
        return sorted(pinned, key=lambda s: self.retention_score(s, now))
