"""Continuous-batching engine with MARS-style decoupled control.

One ``tick`` is one engine **iteration**. Under the default
``scheduler="mixed"`` (token-level continuous batching) a tick forms one
*mixed* batch: every in-flight decode session contributes exactly one
token and new sessions' chunked-prefill tokens ride along in the same
backend dispatch, so batch membership changes — sessions join, leave, are
preempted — at token granularity. ``scheduler="round"`` keeps the legacy
round-granular loop (``decode_granularity``-token decode quanta, prefills
fill whatever budget the decodes left) as the parity baseline.

    1. drain tool completions (unified info stream)      -> sessions resume
    2. O(1) block-pool + host-tier + backlog probe       -> telemetry
    3. external admission (policy.admit; MARS = Alg. 1);
       cold prefills attach to shared radix-indexed prefix blocks
    4. pin re-evaluation (adaptive four-way retention / TTL expiry):
       revoked pins drop, or demote to host DRAM or the NVMe cold tier;
       tiered-store upkeep demotes cold host entries to NVMe
    5. batch formation: decode continuations first (priority order, one
       token each in mixed mode), then chunked prefills under the
       policy's prefill/decode token-budget split (mixed mode caps the
       prefill share per iteration so a prefill wave can never inflate
       the inter-token latency of running decodes); chunk shrinking;
       pinned KV is reclaimed (drop or offload) before any running victim
       is preempted; completed host transfers drain back as swap-ins
       (NVMe entries promote back through host DRAM first — the staged
       restore)
    6. backend.run_batch — ONE dispatch for the whole mixed batch (sim:
       modeled seconds; jax: wall seconds, prefill packs + decode lanes
       fused into a single jitted call on the paged layout)
    7. bookkeeping: TTFT per round, per-iteration MLFQ service charging
       (quantum-by-token), tool yields + retention decisions, completion
       accounting

The same loop drives the discrete-event simulator and the live JAX engine —
only the backend, the tool executor, and the clock differ.

KV capacity is governed by the tiered subsystem (``repro.kvcache``): a
block-identity pool with refcounts/copy-on-write, a radix prefix index for
cross-session sharing, and a host-DRAM + NVMe offload hierarchy orchestrated
by ``TieredStore``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

from repro_torch.core import events as ev
from repro_torch.core.cpu_pool import CpuPool, CpuPoolConfig
from repro_torch.core.events import EventBus
from repro_torch.core.policies import (KVAction, MARSConfig, Policy, Services,
                                 make_policy)
from repro_torch.core.session import KVState, Phase, Round, Session
from repro_torch.core.telemetry import Telemetry, TelemetryConfig
from repro_torch.engine.backend import BatchWork
from repro_torch.engine.tools import SimToolExecutor, ToolExecutor
from repro_torch.kvcache import (BlockPool, DiskTier, DiskTierConfig, HostTier,
                           HostTierConfig, RadixIndex, TieredStore)


@dataclass
class EngineConfig:
    total_kv_blocks: int = 8192
    block_size: int = 32
    token_budget: int = 8192          # per-tick prefill+decode token budget
    max_decode_batch: int = 64
    decode_granularity: int = 8       # round mode only; mixed always uses 1
    # "mixed" = iteration-level continuous batching (default): one token
    # per decode lane per tick, prefill chunks ride along under the
    # policy's prefill/decode budget split, one fused backend dispatch.
    # "round" = legacy round-granular scheduling (parity baseline).
    scheduler: str = "mixed"
    cpu_slots: int = 16
    # shared host-CPU pool (core/cpu_pool): queueing + interference model
    # every CPU consumer (tools, swap staging, spool I/O) leases from.
    # None => derived from cpu_slots with the documented defaults.
    cpu_pool: CpuPoolConfig = None
    telem: TelemetryConfig = None     # derived from cpu_slots if None
    enable_prefix_sharing: bool = True  # radix index over prefix chunk hashes
    host_tier_blocks: int = -1        # host-DRAM tier capacity; -1 => 4x HBM
    host_pcie_bw: float = 24e9        # batched-DMA effective bytes/s
    # NVMe cold tier (kvcache.disk_tier): 0 => off (three-way retention),
    # -1 => 16x HBM. Requires a host tier (staged restores route through it).
    disk_tier_blocks: int = 0
    disk_read_bw: float = 3.5e9       # sequential read bytes/s
    disk_write_bw: float = 1.8e9      # sustained sequential write bytes/s
    disk_op_latency_s: float = 1e-4   # per-op NVMe latency
    disk_queue_depth: int = 16        # concurrent modeled device ops
    disk_demote_after_s: float = 30.0  # host entry idle time before demotable
    disk_demote_watermark: float = 0.5  # host occupancy that starts demotion

    def __post_init__(self):
        if self.telem is None:
            self.telem = TelemetryConfig(cpu_slots=self.cpu_slots)
        if self.cpu_pool is None:
            self.cpu_pool = CpuPoolConfig(cores=self.cpu_slots)
        if self.scheduler not in ("mixed", "round"):
            raise ValueError(
                f"scheduler must be 'mixed' or 'round', got "
                f"{self.scheduler!r}")


class Engine:
    def __init__(self, cfg: EngineConfig, policy_name: str, backend, *,
                 bus: Optional[EventBus] = None, tool_exec=None,
                 mars_cfg: Optional[MARSConfig] = None):
        self.cfg = cfg
        self.bus = bus or EventBus()
        self.backend = backend
        self.blocks = BlockPool(cfg.total_kv_blocks, cfg.block_size)
        # physical backends bind to the pool so block ids map onto device
        # pages (paged live runner); sim/slot-dense backends have no hook
        bind = getattr(backend, "bind_kv_pool", None)
        if bind is not None:
            bind(self.blocks)
        # prefix sharing swaps block references, never KV bytes, so it
        # requires a backend whose KV state lives in the block accounting
        # (sim) or whose physical placement follows the block ids (the
        # paged live runner); the slot-dense live layout is neither
        self.radix: Optional[RadixIndex] = (
            RadixIndex(self.blocks, chunk_tokens=cfg.block_size)
            if (cfg.enable_prefix_sharing
                and getattr(backend, "supports_prefix_sharing", False))
            else None)
        # shared CPU core pool: tools, swap staging, and spool I/O all
        # lease from it. An externally built executor brings its own pool
        # (the engine adopts it so the transfer paths contend with its
        # tools); otherwise one is built from the config.
        if tool_exec is not None and getattr(tool_exec, "pool", None) \
                is not None:
            self.cpu_pool: CpuPool = tool_exec.pool
        else:
            self.cpu_pool = CpuPool(cfg.cpu_pool)
        # live backends track swap-stream worker CPU against the same pool
        bind_cpu = getattr(backend, "bind_cpu_pool", None)
        if bind_cpu is not None:
            bind_cpu(self.cpu_pool)
        host_blocks = (4 * cfg.total_kv_blocks if cfg.host_tier_blocks < 0
                       else cfg.host_tier_blocks)
        bpt_fn = getattr(backend, "kv_bytes_per_token", None)
        bpt = bpt_fn() if bpt_fn else 64 * 1024
        self.host: Optional[HostTier] = (
            HostTier(HostTierConfig(capacity_blocks=host_blocks,
                                    pcie_bw=cfg.host_pcie_bw),
                     bytes_per_token=bpt, block_size=cfg.block_size)
            if host_blocks > 0 else None)
        # NVMe cold tier + the TieredStore orchestrator over host+disk.
        # The engine always talks to the store (it delegates transparently
        # when no disk tier is configured); `self.host`/`self.disk` stay
        # exposed for tests and telemetry.
        disk_blocks = (16 * cfg.total_kv_blocks if cfg.disk_tier_blocks < 0
                       else cfg.disk_tier_blocks)
        self.disk: Optional[DiskTier] = (
            DiskTier(DiskTierConfig(capacity_blocks=disk_blocks,
                                    read_bw=cfg.disk_read_bw,
                                    write_bw=cfg.disk_write_bw,
                                    op_latency_s=cfg.disk_op_latency_s,
                                    queue_depth=cfg.disk_queue_depth),
                     bytes_per_token=bpt, block_size=cfg.block_size)
            if disk_blocks > 0 and self.host is not None else None)
        self.tiers: Optional[TieredStore] = (
            TieredStore(self.host, self.disk,
                        recompute_time=backend.recompute_time,
                        demote_after_s=cfg.disk_demote_after_s,
                        demote_watermark=cfg.disk_demote_watermark,
                        bus=self.bus, cpu_pool=self.cpu_pool)
            if self.host is not None else None)
        if self.tiers is not None and self.disk is not None:
            spill = getattr(backend, "spill_host", None)
            unspill = getattr(backend, "fill_host", None)
            if spill is not None and unspill is not None:
                self.tiers.bind_backend(spill=spill, unspill=unspill)
        self.telem = Telemetry(cfg.telem, self.bus)
        # async swap stream: the backend drains swap-outs and prefetches
        # swap-ins on a background worker; the engine then gates restores
        # on real transfer futures and defers (never stalls on) sessions
        # whose swap-in is still in flight. Sim backends stay on the
        # modeled clock — their behaviour is bit-identical.
        self._async_swap = bool(getattr(backend, "supports_async_swap",
                                        False))
        self.policy: Policy = make_policy(policy_name, self.telem, self.bus,
                                          backend, mars_cfg)
        self.policy.bind(Services(
            host_tier=self.tiers,
            swap_size_fn=self._private_swap_size,
            async_swap=self._async_swap,
            prefix_lookup=(self._indexed_prefix_blocks
                           if self.radix is not None else None),
            disk_tier=self.disk,
            cpu_pool=self.cpu_pool))
        self.tools: ToolExecutor = (tool_exec
                                    or SimToolExecutor(self.cpu_pool,
                                                       self.bus))
        self.waiting: List[Session] = []
        self.active: List[Session] = []
        self.pinned: List[Session] = []
        self.finished: List[Session] = []
        self.rejected: List[Session] = []
        self._pending_swapouts: List[Tuple[Session, int]] = []
        # benchmark counters (kvcache_bench reads these)
        self.prefill_tokens_computed = 0
        self.prefix_hit_tokens = 0
        # observability (repro.obs.Tracer.install flips this): per-tick
        # phase wall timings + retention audit records are only worth their
        # perf_counter calls when something is listening
        self.trace_ticks = False
        # deterministic fault injection (engine.faults.FaultPlan.install):
        # None in production — every hook is a single identity check
        self.faults = None

    # ------------------------------------------------------------------
    def submit(self, s: Session) -> None:
        # admission-reject sessions that can never fit the KV pool (their
        # full context exceeds capacity): a 4xx in a real deployment. Without
        # this they would livelock in the stall hatch forever.
        total_tokens = sum(r.new_input_tokens + r.decode_tokens
                           for r in s.rounds)
        if self.blocks.blocks_for(total_tokens) > 0.98 * self.blocks.total:
            s.phase = Phase.FINISHED
            s.meta["rejected"] = True
            self.rejected.append(s)
            self.bus.emit(ev.REJECT, s.arrival_time, s.sid,
                          tokens=total_tokens)
            return
        self.bus.emit(ev.SUBMIT, s.arrival_time, s.sid, tokens=total_tokens,
                      rounds=len(s.rounds),
                      # SLO contract rides the stream so obs.slo can track
                      # against it live or from a replayed dump alike
                      slo_class=s.meta.get("slo_class"),
                      slo_alpha=s.slo_alpha, ideal_s=s.ideal_time)
        hashes = s.meta.get("prefix_hashes")
        if hashes is not None:
            # the radix assumes one chunk == one KV block; a workload
            # chunked at a different granularity must not attach (block
            # accounting would drift) — disable sharing for the session
            bs = self.cfg.block_size
            if (not hashes or any(n != bs for _, n in hashes[:-1])
                    or not 0 < hashes[-1][1] <= bs):
                s.meta.pop("prefix_hashes")
        s.phase = Phase.WAITING_ADMIT
        self.waiting.append(s)

    def done(self) -> bool:
        return not self.waiting and not self.active

    def next_timer_event(self, now: float = float("-inf")) -> Optional[float]:
        """Earliest pinned-KV TTL expiry (finite TTLs only) and earliest
        *future* host-tier transfer completion — the sim driver must not
        jump the clock past policy timers or in-flight DMA. Completed
        transfers are not timers: their sessions restore whenever the tool
        ends and blocks free up."""
        ts = [s.pinned_since + s.pin_ttl for s in self.pinned
              if s.pin_ttl != float("inf")]
        if self.tiers is not None:
            t_tier = self.tiers.next_event_time(now)
            if t_tier is not None:
                ts.append(t_tier)
        return min(ts) if ts else None

    def check_invariants(self) -> None:
        """Block-, refcount- and state-machine invariants (used by tests).

        With prefix sharing, per-session logical holdings (lease entries)
        can exceed physical occupancy; the exact identities are:
        ``free + physical_in_use == total`` and ``sum(refcounts) ==
        sum(session.kv_blocks)``."""
        held = sum(s.kv_blocks for s in self.active)
        p = self.blocks.probe()
        assert p.free + p.physical == p.total, \
            f"physical leak: free={p.free} physical={p.physical} " \
            f"total={p.total}"
        assert p.leased == held, \
            f"lease accounting: leased={p.leased} held={held}"
        assert held >= p.physical or held == 0, "refcount underflow"
        self.blocks.check_consistency()
        for s in self.active:
            assert s.kv_blocks == self.blocks.lease_len(s.sid), \
                f"sid {s.sid}: kv_blocks={s.kv_blocks} " \
                f"lease={self.blocks.lease_len(s.sid)}"
        pinned = sum(s.kv_blocks for s in self.pinned)
        assert self.blocks.pinned == pinned, \
            f"pin accounting: {self.blocks.pinned} != {pinned}"
        for s in self.pinned:
            assert s.kv_state == KVState.PINNED and s.phase == Phase.TOOL
        for s in self.active:
            assert s.kv_blocks >= 0
            assert s.resident_len <= s.kv_blocks * self.cfg.block_size
        for s in self.finished:
            assert s.kv_blocks == 0 and s.phase == Phase.FINISHED
        if self.tiers is not None:
            tiered = [s for s in self.active
                      if s.kv_state == KVState.SWAPPED
                      and s.meta.get("host_tier")]
            for s in tiered:
                assert self.tiers.holds(s.sid), f"lost tier entry {s.sid}"
            want = sum(            # per-block offload: only private blocks
                s.meta.get("host_blocks",      # occupy the tiers
                           self.blocks.blocks_for(s.meta.get("swapped_len", 0)))
                for s in tiered)
            used = self.host.used_blocks + \
                (self.disk.used_blocks if self.disk is not None else 0)
            assert used == want, \
                f"tier occupancy: host+disk {used} != {want}"
            assert self.host.used_blocks <= self.host.capacity_blocks, \
                "host tier over capacity"
            if self.disk is not None:
                assert self.disk.used_blocks <= self.disk.capacity_blocks, \
                    "disk tier over capacity"

    # ------------------------------------------------------------------
    def tick(self, now: float) -> Tuple[float, bool]:
        """Returns (elapsed_seconds, progressed)."""
        trace = self.trace_ticks
        t0 = time.perf_counter() if trace else 0.0
        progressed = False
        if self.faults is not None:
            self.faults.apply(self, now)
        # 1. tool completions
        for s in self.tools.poll(now):
            if s not in self.active:
                continue             # detached mid-tool: owned elsewhere now
            self._resume_from_tool(s, now)
            progressed = True
        # 2. telemetry probe; hysteresis/churn advance once per tick
        self._probe()
        self.telem.tick()
        t1 = time.perf_counter() if trace else 0.0
        # 3. admission
        if self.waiting and not (self.faults is not None and
                                 self.faults.active("frozen_admission", now)):
            admitted = self.policy.admit(self.waiting, now)
            for s in admitted:
                self.waiting.remove(s)
                self.active.append(s)
                s.phase = Phase.READY_PREFILL
                s.admitted_at = s.last_service = now
                s.round_submit = now
                self.bus.emit(ev.GPU_SUBMIT, now, s.sid, round=s.cur_round,
                              tokens=s.pending_prefill)
                progressed = True
            if admitted:
                self._probe()
        # 3.5 cross-session prefix sharing: round-0 prefills (cold, or mid-
        # build at a block-aligned boundary) attach to radix-indexed blocks
        # of sessions that already built the shared context
        if self.radix is not None:
            for s in self.active:
                if (s.phase == Phase.READY_PREFILL and s.cur_round == 0
                        and s.decoded == 0
                        and s.kv_state in (KVState.NONE, KVState.RESIDENT)
                        and s.resident_len % self.cfg.block_size == 0
                        and self._attach_prefix(s, now)):
                    progressed = True
        # 4. pin re-evaluation (four-way: keep / offload / demote / drop)
        for s, action in list(self.policy.revoke_actions(self.pinned, now)):
            self._revoke_pin(s, now, action, reason="pin_revoked")
            progressed = True
        # 4.5 tiered-store upkeep: demote cold host entries to NVMe by the
        # net-benefit score; sessions already back from their tool are
        # vetoed (demoting an entry about to restore would ping-pong)
        if self.tiers is not None and self.disk is not None:
            idle = {s.sid for s in self.active
                    if s.phase == Phase.TOOL
                    and s.kv_state == KVState.SWAPPED}
            self.tiers.maintain(now, demotable=idle.__contains__)
        t2 = time.perf_counter() if trace else 0.0
        # 5-6. batch formation + execution
        work = self._form_batch(now)
        t3 = time.perf_counter() if trace else 0.0
        elapsed = self.backend.run_batch(work, now)
        t4 = time.perf_counter() if trace else 0.0
        # swap-completion handshake: bind the D2H drains the backend just
        # launched to their tier entries — from here on, ready() answers
        # from the real transfer, not the modeled completion time (a
        # direct-to-disk entry chains its spool write behind the drain)
        if self.tiers is not None and work.swap_futures:
            for sid, fut in work.swap_futures.items():
                self.tiers.attach_future(sid, fut)
        # 7. bookkeeping
        if not work.empty:
            self._apply(work, now, now + elapsed, elapsed)
            progressed = True
        if trace:
            t5 = time.perf_counter()
            extra = {}
            # live-backend prefill HBM traffic counters (gather-free win):
            # cumulative, so the Perfetto counter track shows the spread
            dst = getattr(self.backend, "dispatch_stats", None)
            if dst is not None and "prefill_gather_bytes" in dst:
                extra["prefill_gather_bytes"] = dst["prefill_gather_bytes"]
                extra["prefill_inplace_bytes"] = dst["prefill_inplace_bytes"]
            self.bus.emit(
                ev.TICK, now, -1,
                elapsed=elapsed, wall_s=t5 - t0,
                phases={"tools_control": t1 - t0, "upkeep": t2 - t1,
                        "form_batch": t3 - t2, "run_batch": t4 - t3,
                        "bookkeep": t5 - t4},
                n_decodes=len(work.decodes), n_prefills=len(work.prefills),
                n_swapins=len(work.swapins), n_swapouts=len(work.swapouts),
                # MIXED_BATCH fields: scheduler mode + token composition of
                # this iteration's dispatch (decode lanes vs prefill chunks)
                mixed=work.mixed,
                decode_tokens=sum(g for _, g in work.decodes),
                prefill_tokens=sum(cch for _, cch in work.prefills),
                active=len(self.active), waiting=len(self.waiting),
                free_blocks=self.blocks.free,
                total_blocks=self.blocks.total,
                active_tools=self.telem.active_tools,
                cpu_busy=self.cpu_pool.busy_cores(now),
                cpu_backlog=self.cpu_pool.backlog(now),
                host_used=self.host.used_blocks if self.host else 0,
                disk_used=self.disk.used_blocks if self.disk else 0,
                **extra)
        return elapsed, progressed

    # ------------------------------------------------------------------
    def _probe(self) -> None:
        p = self.blocks.probe()
        waiting_blocks = sum(
            self.blocks.blocks_for(s.pending_prefill)
            for s in self.waiting)
        waiting_blocks += sum(
            self.blocks.blocks_for(s.pending_prefill) - s.kv_blocks
            for s in self.active if s.phase == Phase.READY_PREFILL)
        n_dec = sum(1 for s in self.active if s.phase == Phase.DECODING)
        self.telem.probe_gpu(p.total, p.free, p.pinned, len(self.active),
                             n_dec, max(0, waiting_blocks))
        if self.host is not None:
            self.telem.probe_host(self.host.used_blocks,
                                  self.host.capacity_blocks,
                                  self.host.stores, self.host.hits)
        if self.tiers is not None:
            self.telem.probe_tiers(self.tiers.stats())
        if self.radix is not None:
            self.telem.probe_prefix(self.radix.queries, self.radix.hits,
                                    self.radix.hit_tokens)
            self.telem.probe_digest(self.radix.digest())

    # --- cross-replica prefix reuse ------------------------------------
    def radix_digest(self, top_k: int = 16) -> Optional[dict]:
        """Compact radix-root digest for the cluster router's heartbeat
        (None when prefix sharing is off — a digest-blind replica). Cached
        per index version, so per-tick callers pay a dict lookup."""
        return self.radix.digest(top_k) if self.radix is not None else None

    def _indexed_prefix_blocks(self, s: Session) -> int:
        """Blocks of ``s``'s round-0 chunk-key prefix already indexed on
        this replica (exact ``RadixIndex.match``) — admission sizes family
        members net of the shared context they will attach to, not build.
        The match is cached against the index *structure* (insert count +
        node count, which eviction shrinks): pack_queue re-estimates every
        queued session several times per admission cycle, every tick —
        without the stamp that is O(queue x prefix) tree walks of pure
        recomputation (same trouble the attach path's radix_stale_at
        stamp exists for)."""
        if self.radix is None or s.cur_round != 0 or s.decoded:
            return 0
        hashes = s.meta.get("prefix_hashes")
        if not hashes:
            return 0
        key = (self.radix.inserted_blocks, len(self.radix))
        cached = s.meta.get("radix_admission_est")
        if cached is not None and cached[0] == key:
            return cached[1]
        n = len(self.radix.match(hashes))
        s.meta["radix_admission_est"] = (key, n)
        return n

    # --- tiered KV helpers ---------------------------------------------
    def _swap_record(self, s: Session):
        """Per-block offload plan for ``s``'s current lease: the full
        (bid, gen, private) record plus the private block/token counts —
        only private blocks (content lost at release) cross PCIe."""
        bs = self.cfg.block_size
        rec = []
        host_blocks = host_tokens = 0
        for i, bid in enumerate(self.blocks.lease(s.sid)):
            private = not self.blocks.survives_release(bid)
            rec.append((bid, self.blocks.gen(bid), private))
            if private:
                host_blocks += 1
                host_tokens += min(bs, s.resident_len - i * bs)
        return rec, host_blocks, host_tokens

    def _private_swap_size(self, s: Session):
        """(tokens, blocks) that would actually move if ``s`` offloaded now
        — the policy prices retention with this, so radix-shared contexts
        (cheap to park per-block) are not charged the full-context PCIe
        cost the pre-paged swapper would have paid."""
        _rec, blocks, tokens = self._swap_record(s)
        return tokens, blocks

    def _attach_prefix(self, s: Session, now: float) -> bool:
        """Attach to the longest indexed prefix of this session's chunk
        hashes beyond what it already built (shared physical blocks, no
        recompute). Works cold *and* mid-prefill at block-aligned
        boundaries, so a family member that started before the canonical
        builder finished still catches up to freshly indexed blocks.
        Reviving cached blocks consumes free capacity, so the match is
        trimmed to what fits above the decode watermark."""
        hashes = s.meta.get("prefix_hashes")
        if not hashes:
            return False
        # skip the O(context/block) root re-match unless the index grew
        # since the last fully-consumed lookup (inserted_blocks is monotone;
        # capacity-trimmed matches don't stamp, so they retry as space frees)
        if s.meta.get("radix_stale_at") == self.radix.inserted_blocks:
            return False
        held = s.kv_blocks
        if held * self.cfg.block_size != s.resident_len:
            return False          # partial tail block: not chunk-aligned
        if not s.meta.get("radix_queried"):
            s.meta["radix_queried"] = True
            self.radix.record_query(anchor=hashes[0][0])
        matched = self.radix.match(hashes)
        if len(matched) <= held:
            s.meta["radix_stale_at"] = self.radix.inserted_blocks
            return False
        matched = matched[held:]  # the already-built prefix stays private
        avail = max(0, self.blocks.free - self._watermark())
        n_revive = sum(1 for bid, _ in matched if self.blocks.is_cached(bid))
        while matched and n_revive > avail:
            bid, _ = matched.pop()
            if self.blocks.is_cached(bid):
                n_revive -= 1
        # a backend that really decodes needs the last prompt token's
        # logits to seed decoding (vLLM semantics: a full prefix hit still
        # computes >= 1 token), so never let the match cover the entire
        # pending prefill — the tail chunk is recomputed privately
        if getattr(self.backend, "requires_last_token_compute", False):
            while matched and s.resident_len + sum(
                    n for _, n in matched) >= s.prefill_target:
                matched.pop()
        if not matched:
            return False
        bids = [b for b, _ in matched]
        toks = sum(n for _, n in matched)
        self.blocks.acquire(s.sid, bids)
        s.kv_blocks += len(bids)
        s.resident_len += toks
        s.context_len = max(s.context_len, s.resident_len)
        s.kv_state = KVState.RESIDENT
        self.prefix_hit_tokens += toks
        self.radix.record_hit(toks, first=not s.meta.get("radix_hit"),
                              anchor=hashes[0][0])
        s.meta["radix_hit"] = True
        self.bus.emit(ev.PREFIX_HIT, now, s.sid, tokens=toks,
                      blocks=len(bids))
        if s.pending_prefill <= 0:       # full duplicate: nothing to build
            s.phase = Phase.DECODING
        return True

    def _insert_prefix_progress(self, s: Session) -> None:
        """Index every fully-built round-0 chunk so far (vLLM/sglang style
        incremental prefix caching): later family members attach to the
        shared context *while* the first builder is still prefilling. The
        partial tail chunk is indexed only once round 0 completes."""
        hashes = s.meta.get("prefix_hashes")
        if not hashes:
            return
        done = s.meta.get("prefix_chunks_indexed", 0)
        if s.pending_prefill <= 0:
            m = len(hashes)          # completion: partial tail included
        else:
            m, cum = 0, 0
            for _, n_tok in hashes:
                if cum + n_tok > s.resident_len or n_tok < self.cfg.block_size:
                    break
                cum += n_tok
                m += 1
        if m <= done:
            return
        lease = self.blocks.lease(s.sid)
        if len(lease) < m:
            return
        self.radix.insert(hashes[:m], lease[:m])
        s.meta["prefix_chunks_indexed"] = m
        if m == len(hashes):
            s.meta["radix_inserted"] = True

    def _offload_kv(self, s: Session, now: float,
                    target: str = "host") -> bool:
        """Demote resident KV to the tiered store, *per block*: only
        private blocks (content lost at release) cross PCIe and occupy the
        target tier; shared/indexed prefix blocks stay physically on device
        and are re-referenced at restore by their (bid, gen) certificate.
        Device blocks free immediately; the (asynchronous) transfer of the
        private suffix gates restorability. ``target="disk"`` routes the
        entry straight to the NVMe cold tier (staged write: the D2H leg
        stages through the stream's bounded buffers, then the spool write
        lands — restores promote back through host DRAM)."""
        if self.tiers is None or s.kv_blocks <= 0:
            return False
        if target == "disk" and self.disk is None:
            target = "host"
        rec, host_blocks, host_tokens = self._swap_record(s)
        can = (self.tiers.can_store_disk(host_blocks) if target == "disk"
               else self.tiers.can_store(host_blocks))
        if not can:
            return False
        self.tiers.store(s.sid, host_tokens, host_blocks, now,
                         target=target, context_tokens=s.resident_len)
        if self._async_swap:
            # the D2H drain is launched by run_batch next tick; until its
            # future is attached the entry must not look restorable (the
            # modeled ready_at may pass while nothing has been copied)
            self.tiers.mark_in_flight(s.sid)
        s.meta["swapped_len"] = s.resident_len
        s.meta["host_tier"] = True
        s.meta["kv_tier"] = target
        s.meta["swap_pages"] = rec
        s.meta["host_blocks"] = host_blocks
        s.meta["host_tokens"] = host_tokens
        self._pending_swapouts.append((s, host_tokens))
        freed = self.blocks.release_all(s.sid)
        assert freed == s.kv_blocks
        self.bus.emit(ev.SWAP_OUT, now, s.sid, blocks=s.kv_blocks,
                      copied=host_blocks, tier=target)
        s.kv_blocks = 0
        s.resident_len = 0
        s.kv_state = KVState.SWAPPED
        return True

    def _revoke_pin(self, s: Session, now: float, action: KVAction,
                    reason: str) -> None:
        self.blocks.unpin(s.kv_blocks)
        if s in self.pinned:
            self.pinned.remove(s)
        s.kv_state = KVState.RESIDENT
        if action in (KVAction.OFFLOAD, KVAction.OFFLOAD_DISK):
            target = "disk" if action == KVAction.OFFLOAD_DISK else "host"
            if self._offload_kv(s, now, target=target):
                self.bus.emit(ev.UNPIN, now, s.sid, warm=False, to=target)
                return
        self._release_kv(s, now, reason=reason)

    def _drop_host_copy(self, s: Session) -> None:
        """Abandon host-side KV (recompute fallback / release): the tier
        entry if present, and the live backend's copy unconditionally —
        legacy-SWAP sessions also park K/V host-side via _swap_out and
        would otherwise leak it for the life of the server."""
        if s.meta.pop("host_tier", None) and self.tiers is not None:
            self.tiers.drop(s.sid)
        for k in ("swap_pages", "restore_positions", "host_blocks",
                  "host_tokens", "kv_tier", "swap_in_future", "swap_cost_s",
                  "swap_cpu_wait_s"):
            s.meta.pop(k, None)
        drop = getattr(self.backend, "drop_host", None)
        if drop is not None:
            drop(s.sid)

    def _resume_from_tool(self, s: Session, now: float) -> None:
        if s in self.pinned:
            self.pinned.remove(s)
            self.blocks.unpin(s.kv_blocks)
            s.kv_state = KVState.RESIDENT
            self.bus.emit(ev.UNPIN, now, s.sid, warm=True)
        s.cur_round += 1
        s.decoded = 0
        s.first_token_seen = False
        s.phase = Phase.READY_PREFILL
        s.round_submit = now
        self.bus.emit(ev.GPU_SUBMIT, now, s.sid, round=s.cur_round,
                      tokens=s.pending_prefill)

    def detach_session(self, s: Session, now: float) -> None:
        """Hand a session off this replica (router drain / failover):
        release its device lease, pin accounting, host-side copies, and any
        in-flight tool, and forget it. The engine stays reusable —
        ``check_invariants`` holds after detach, so a recovered replica can
        keep ticking without resuming a session it no longer owns."""
        if s.phase == Phase.TOOL:
            # protocol-guaranteed: both executors release the session's
            # pool lease (queued or running) on cancel
            self.tools.cancel(s.sid, now)
        self._release_kv(s, now, reason="detach")
        for lst in (self.waiting, self.active, self.pinned):
            if s in lst:
                lst.remove(s)

    def _release_kv(self, s: Session, now: float, reason: str) -> None:
        if s.kv_state == KVState.PINNED:
            self.blocks.unpin(s.kv_blocks)
            if s in self.pinned:
                self.pinned.remove(s)
        if s.kv_state == KVState.SWAPPED:
            self._drop_host_copy(s)
            s.meta["swapped_len"] = 0
        if s.kv_blocks:
            freed = self.blocks.release_all(s.sid)
            assert freed == s.kv_blocks, \
                f"lease mismatch on release: {freed} != {s.kv_blocks}"
            self.bus.emit(ev.EVICT, now, s.sid, blocks=s.kv_blocks,
                          reason=reason)
        s.kv_blocks = 0
        s.resident_len = 0
        s.kv_state = KVState.NONE
        # the attach-skip stamp is only valid while the attached state is
        # intact: a released (preempted/reclaimed) round-0 session must be
        # free to re-attach even if the index hasn't grown since
        s.meta.pop("radix_stale_at", None)
        release = getattr(self.backend, "release_session", None)
        if release is not None:
            release(s.sid)

    def _preempt(self, s: Session, now: float) -> None:
        s.preemptions += 1
        s.recomputed_tokens += s.resident_len
        if s.phase == Phase.DECODING:
            s.phase = Phase.READY_PREFILL
        self.bus.emit(ev.PREEMPT, now, s.sid, tokens=s.resident_len,
                      blocks=s.kv_blocks)
        self._release_kv(s, now, reason="preempt")

    def _ensure_blocks(self, n: int, now: float, in_batch: Set[int],
                       requester: Session, allow_preempt: bool) -> bool:
        """Free >= n blocks: reclaim pinned contexts first (policy order);
        preempt running/resident victims only if ``allow_preempt`` (decode
        extensions and the stall escape hatch — waiting prefills otherwise
        never preempt, matching vLLM semantics)."""
        if self.blocks.free >= n:
            return True
        for s in self.policy.reclaim_order(list(self.pinned), now):
            self._revoke_pin(s, now, self.policy.reclaim_action(s, now),
                             reason="reclaim")
            if self.blocks.free >= n:
                return True
        if not allow_preempt:
            return False
        victims = [v for v in self.active
                   if v.kv_blocks > 0 and v.sid != requester.sid
                   and v.sid not in in_batch and v.phase != Phase.TOOL]
        for v in self.policy.eviction_order(victims, now, requester):
            self._preempt(v, now)
            if self.blocks.free >= n:
                return True
        return self.blocks.free >= n

    def _restore_lease(self, s: Session) -> bool:
        """Rebuild a swapped-out session's lease in recorded order: shared
        blocks are re-referenced on device iff their (bid, gen) certificate
        still holds; private blocks get fresh pages (the backend fills them
        from the host copy at the positions in ``meta["restore_positions"]``).
        Returns False — with the partial lease rolled back — when any shared
        block's content is gone; the caller falls back to recompute.
        Capacity for ``blocks_for(swapped_len)`` must already be ensured
        (reacquire consumes at most one free block per entry, via revive)."""
        rec = s.meta.get("swap_pages")
        if rec is None:        # no placement record (externally built meta)
            need = self.blocks.blocks_for(s.meta.get("swapped_len", 0))
            ok = self.blocks.alloc(s.sid, need)
            assert ok, "restore alloc failed despite ensured capacity"
            s.kv_blocks += need
            s.meta["restore_positions"] = list(range(need))
            return True
        restore: List[int] = []
        for i, (bid, gen, private) in enumerate(rec):
            if private:
                ok = self.blocks.alloc(s.sid, 1)
                assert ok, "restore alloc failed despite ensured capacity"
                restore.append(i)
            elif not self.blocks.reacquire(s.sid, bid, gen):
                self.blocks.release_all(s.sid)       # roll back partial lease
                s.meta.pop("restore_positions", None)
                return False
        s.kv_blocks += len(rec)
        s.meta["restore_positions"] = restore
        return True

    def _write_need(self, s: Session, new_tokens: int) -> Tuple[int, int]:
        """(new blocks, CoW blocks) to extend ``s`` by ``new_tokens``:
        writing into a shared/indexed partial tail block requires a private
        copy first (one extra physical block while the original keeps its
        content for the other referents / future prefix matchers)."""
        need = self.blocks.blocks_for(s.resident_len + new_tokens) \
            - s.kv_blocks
        cow = 1 if (s.resident_len % self.cfg.block_size != 0
                    and self.blocks.tail_needs_cow(s.sid)) else 0
        return need, cow

    def _grow_lease(self, s: Session, need: int, cow: int) -> None:
        """Commit a write reservation (capacity for need + cow must already
        be ensured). CoW runs while the shared block is still the lease
        tail — alloc() appends private blocks, after which copy_on_write
        would re-check the wrong block and silently no-op."""
        if cow:
            assert self.blocks.copy_on_write(s.sid), \
                "copy-on-write failed despite ensured capacity"
        if need > 0:
            self.blocks.alloc(s.sid, need)
            s.kv_blocks += need

    # ------------------------------------------------------------------
    def _form_batch(self, now: float) -> BatchWork:
        c = self.cfg
        mixed = c.scheduler == "mixed"
        ready = [s for s in self.active
                 if s.phase in (Phase.READY_PREFILL, Phase.DECODING)]
        order = self.policy.order(ready, now)
        if self.faults is not None:
            # freeze_decode: the targeted session silently never makes the
            # batch — DECODING phase, no more DECODE_STEPs (the livelock
            # signature the obs detectors must catch). Only sessions that
            # have already stepped qualify for the untargeted latch: a
            # frozen lane is "stopped decoding", not "never started".
            order = [s for s in order
                     if not (s.phase == Phase.DECODING and s.decoded > 0
                             and self.faults.freezes(s.sid, now))]
        decodes: List[Tuple[Session, int]] = []
        prefills: List[Tuple[Session, int]] = []
        swapins: List[Tuple[Session, int]] = []
        in_batch: Set[int] = set()
        budget = c.token_budget
        # mixed mode: every decode lane advances exactly one token per
        # iteration, so batch membership (join/leave/preempt) is decided
        # at token granularity; round mode bursts decode_granularity-token
        # quanta (the parity baseline).
        quantum = 1 if mixed else c.decode_granularity

        # decodes first: latency-sensitive continuations. Decode extensions
        # may preempt (they must make progress to ever release memory).
        for s in order:
            if s.phase != Phase.DECODING or len(decodes) >= c.max_decode_batch:
                continue
            g = min(quantum, s.cur.decode_tokens - s.decoded, budget)
            if g <= 0:
                continue
            need, cow = self._write_need(s, g)
            if need + cow > 0:
                if not self._ensure_blocks(need + cow, now, in_batch, s,
                                           allow_preempt=True):
                    continue
                self._grow_lease(s, need, cow)
            decodes.append((s, g))
            in_batch.add(s.sid)
            budget -= g

        # prefills / swap-ins fill the remaining budget from free blocks and
        # reclaimable pins only (no preemption). Mixed mode additionally
        # caps the prefill share of this iteration via the policy's
        # prefill/decode budget split, so a prefill-heavy arrival wave can
        # never inflate the inter-token latency of the decode lanes riding
        # in the same dispatch.
        if mixed:
            decode_toks = sum(g for _, g in decodes)
            budget = min(budget,
                         self.policy.prefill_budget(c.token_budget,
                                                    decode_toks))
        for s in order:
            if s.phase != Phase.READY_PREFILL or budget <= 0:
                continue
            before = len(prefills)
            self._try_prefill(s, now, in_batch, budget, prefills, swapins,
                              allow_preempt=False)
            if len(prefills) > before:
                budget -= prefills[-1][1]
        # stall escape hatch: pool exhausted by partial holders and nothing
        # scheduled -> serve the single top-priority ready session, allowing
        # preemption of strictly junior work (deadlock freedom). Uses the
        # full token budget: with an empty batch there are no decode lanes
        # to protect, so the split does not apply.
        if not decodes and not prefills and not swapins:
            for s in order:
                if s.phase != Phase.READY_PREFILL:
                    continue
                if self._try_prefill(s, now, in_batch, c.token_budget,
                                     prefills, swapins, allow_preempt=True):
                    break
        swapouts, self._pending_swapouts = self._pending_swapouts, []
        work = BatchWork(decodes, prefills, swapins, swapouts, mixed=mixed)
        # placement snapshot: the backend executes from these tables (and
        # the tick's CoW copy list), never from live pool state — swapped-
        # out leases are already released, and a bid freed here may be
        # re-leased to another batch member within this very tick
        for s, _ in decodes:
            work.leases[s.sid] = tuple(self.blocks.lease(s.sid))
        for s, _ in prefills:
            work.leases[s.sid] = tuple(self.blocks.lease(s.sid))
        for s, _ in swapins:
            work.leases[s.sid] = tuple(self.blocks.lease(s.sid))
        work.cow_copies = self.blocks.drain_cow_log()
        return work

    def _watermark(self) -> int:
        """Block reserve prefills may not dip into: active decodes extend by
        ~1 block each within a few ticks; without this reserve, greedy chunked
        prefills starve decode extensions into preemption storms (vLLM keeps
        the same kind of allocation watermark)."""
        n_dec = sum(1 for s in self.active if s.phase == Phase.DECODING)
        return max(self.blocks.total // 100, 2 * n_dec)

    def _stamp_swap_cost(self, s: Session, toks: int, now: float) -> None:
        """``meta["swap_cost_s"]`` accounting, future-aware: the engineered-
        DMA restore time covers the private suffix only (shared prefix
        blocks were re-referenced on device, no PCIe traffic). When the
        async stream already crossed that suffix in the background (the
        swap-in future resolved before the session was batched, or there
        was nothing private to move), the restore serializes *nothing* —
        the stamp is 0.0. Sim path: no futures, modeled cost, plus any
        CPU-side delay of the H2D staging copy — the restore's bounce
        buffers lease from the shared core pool, so a tool burst pushes
        the restore out (``swap_cpu_wait_s``, surfaced on SWAP_IN for the
        tracer's ``cpu_queue_wait`` attribution)."""
        fut = s.meta.pop("swap_in_future", None)
        if self._async_swap and (fut is None or fut.done()):
            s.meta["swap_cost_s"] = 0.0
        else:
            swap_s = self.tiers.swap_seconds(s.meta.get("host_tokens", toks))
            cpu_extra = 0.0
            frac = self.cpu_pool.cfg.transfer_cpu_frac
            if frac > 0.0 and swap_s > 0.0:
                lease = self.cpu_pool.submit(now, frac * swap_s, sid=s.sid,
                                             kind="swap", tag="h2d",
                                             priority=0)
                cpu_extra = max(0.0, lease.end - now - swap_s)
            s.meta["swap_cost_s"] = swap_s + cpu_extra
            s.meta["swap_cpu_wait_s"] = cpu_extra

    def _abandon_swap(self, s: Session, now: float) -> None:
        """Give up on a swapped-out session's host copy (stale certificate
        or capacity deadlock): rebuild by recompute."""
        self.bus.emit(ev.SWAP_ABANDON, now, s.sid,
                      tokens=s.meta.get("swapped_len", 0))
        self._drop_host_copy(s)
        s.kv_state = KVState.NONE
        s.meta["swapped_len"] = 0

    def _swap_in_blocked(self, s: Session, now: float) -> bool:
        """Async swap stream: is this tiered session's restore still gated?
        Issues the H2D prefetch on first call (the crossing then overlaps
        this tick's other sessions' compute) and answers True while the
        prefetch future is unresolved — the engine *defers* the session,
        it never stalls the batch on the transfer. Applies the (bid, gen)
        certificate check first: a record that went stale while in flight
        falls back to recompute immediately (not blocked, not restorable —
        the caller re-checks ``kv_state``)."""
        rec = s.meta.get("swap_pages") or []
        if not self.blocks.certify(
                [(bid, gen) for bid, gen, private in rec if not private]):
            # a shared block was CoW'd / evicted / re-leased while the
            # transfer was in flight: the certificate is void before any
            # pages were touched — discard the prefetch with the host copy
            self._abandon_swap(s, now)
            return False
        if "swap_in_future" not in s.meta:
            fut = self.backend.prefetch_swap_in(s.sid)
            s.meta["swap_in_future"] = fut
            if fut is not None:
                return True            # H2D launched: deferred, not stalled
        fut = s.meta["swap_in_future"]
        return fut is not None and not fut.done()

    def _try_prefill(self, s: Session, now: float, in_batch: Set[int],
                     budget: int, prefills, swapins, allow_preempt: bool) -> bool:
        c = self.cfg
        reserve = 0 if allow_preempt else self._watermark()
        avail = max(0, self.blocks.free - reserve)
        if s.kv_state == KVState.SWAPPED:
            tiered = bool(s.meta.get("host_tier")) and self.tiers is not None
            if tiered:
                # tier access: promotes a disk-resident entry back through
                # host DRAM (staged first hop) on first request. False =>
                # a transfer gates the restore: a modeled entry completes
                # at a known future time (exported via next_timer_event),
                # a future-gated one resolves on the background stream —
                # waiting is strictly cheaper than abandoning to recompute.
                # None => the restore can never proceed (entry lost, or a
                # promotion starved of host capacity under the stall
                # hatch): abandon to recompute.
                r = self.tiers.request(s.sid, now, urgent=allow_preempt)
                if r is None:
                    self._abandon_swap(s, now)
                elif not r:
                    return False
            if (s.kv_state == KVState.SWAPPED and tiered
                    and self._async_swap and self._swap_in_blocked(s, now)):
                return False
        if s.kv_state == KVState.SWAPPED:   # may have fallen to recompute
            toks = s.meta.get("swapped_len", 0)
            tiered = bool(s.meta.get("host_tier")) and self.tiers is not None
            need = self.blocks.blocks_for(toks)
            if need <= avail or self._ensure_blocks(
                    need + reserve, now, in_batch, s, allow_preempt):
                if self._restore_lease(s):
                    if tiered:
                        self._stamp_swap_cost(s, toks, now)
                    swapins.append((s, toks))
                    in_batch.add(s.sid)
                    return True
                # a shared block recorded at swap-out lost its content
                # (cache-evicted / rewritten): the restore certificate is
                # void — abandon the host copy and rebuild by recompute
                self._abandon_swap(s, now)
            elif not allow_preempt:
                return False
            else:
                # stall escape hatch: restore blocked on *capacity* with
                # nothing else schedulable — no timer will fix that, so
                # abandon the host copy and rebuild by recompute (deadlock
                # freedom).
                self._abandon_swap(s, now)
        want = min(s.pending_prefill, budget)
        if want <= 0:
            return False
        chunk = self.policy.prefill_chunk(want, avail, c.block_size)
        if chunk <= 0:
            need = self.blocks.blocks_for(want)
            if not self._ensure_blocks(need + reserve, now, in_batch, s,
                                       allow_preempt):
                return False
            avail = max(0, self.blocks.free - reserve)
            chunk = self.policy.prefill_chunk(want, avail, c.block_size)
            if chunk <= 0:
                return False
        need, cow = self._write_need(s, chunk)
        if need + cow > self.blocks.free:
            return False
        self._grow_lease(s, need, cow)
        s.kv_state = KVState.RESIDENT
        prefills.append((s, chunk))
        in_batch.add(s.sid)
        return True

    # ------------------------------------------------------------------
    def _apply(self, work: BatchWork, start: float, end: float,
               elapsed: float) -> None:
        total_tokens = max(1, sum(g for _, g in work.decodes)
                           + sum(cch for _, cch in work.prefills))
        for s, toks in work.swapins:
            s.resident_len = toks
            s.kv_state = KVState.RESIDENT
            s.meta["swapped_len"] = 0
            origin = s.meta.pop("kv_tier", "host")
            cpu_wait = s.meta.pop("swap_cpu_wait_s", 0.0)
            for k in ("swap_pages", "restore_positions", "host_blocks",
                      "host_tokens", "swap_in_future",
                      "swap_cost_s"):        # consumed by run_batch above
                s.meta.pop(k, None)
            if s.meta.pop("host_tier", None) and self.tiers is not None:
                # tier hit: occupancy freed. None (hardened sentinel) means
                # the entry vanished between batch formation and commit
                # (detach race) — the restore already executed from the
                # snapshot, so only the hit accounting is skipped.
                loaded = self.tiers.load(s.sid, end)
                self.bus.emit(ev.SWAP_IN, end, s.sid, tokens=toks,
                              tier=origin, start=start,
                              cpu_wait_s=cpu_wait,
                              accounted=loaded is not None)
            else:
                self.bus.emit(ev.SWAP_IN, end, s.sid, tokens=toks,
                              start=start)
            if s.pending_prefill <= 0:
                s.phase = Phase.DECODING
        for s, chunk in work.prefills:
            s.resident_len += chunk
            s.context_len = max(s.context_len, s.resident_len)
            self.prefill_tokens_computed += chunk
            self._account(s, chunk, elapsed, total_tokens, end)
            self.bus.emit(ev.PREFILL_CHUNK, end, s.sid, start=start,
                          tokens=chunk, round=s.cur_round,
                          resident=s.resident_len)
            if (self.radix is not None and s.cur_round == 0
                    and not s.meta.get("radix_inserted")):
                self._insert_prefix_progress(s)
            if s.pending_prefill <= 0:
                s.phase = Phase.DECODING
        for s, g in work.decodes:
            s.decoded += g
            s.resident_len += g
            s.context_len = max(s.context_len, s.resident_len)
            self._account(s, g, elapsed, total_tokens, end)
            self.bus.emit(ev.DECODE_STEP, end, s.sid, start=start,
                          tokens=g, round=s.cur_round, decoded=s.decoded)
            if not s.first_token_seen:
                s.first_token_seen = True
                s.ttfts.append(end - s.round_submit)
                self.bus.emit(ev.GPU_FIRST_TOKEN, end, s.sid,
                              round=s.cur_round,
                              ttft=end - s.round_submit)
            if s.decoded >= s.cur.decode_tokens:
                self._finish_round(s, end)

    def _account(self, s: Session, tokens: int, elapsed: float,
                 total_tokens: int, end: float) -> None:
        # service charging goes through the policy so the MLFQ sees the
        # actual tokens dispatched this iteration (quantum-by-token) the
        # moment they land, not a round-granular aggregate
        self.policy.charge_service(s, tokens, end)
        s.service_seconds += elapsed * tokens / total_tokens
        s.last_service = end

    def _finish_round(self, s: Session, now: float) -> None:
        self.bus.emit(ev.GPU_END, now, s.sid, round=s.cur_round,
                      blocks=s.kv_blocks)
        if s.cur_round == len(s.rounds) - 1:
            s.phase = Phase.FINISHED
            s.finish_time = now
            self._release_kv(s, now, reason="finished")
            self.active.remove(s)
            self.finished.append(s)
            self.bus.emit(ev.FINISH, now, s.sid, latency=s.e2e_latency)
            return
        # yield to tool; retention decision (four-way under MARS: PIN keeps
        # HBM, OFFLOAD parks in host DRAM, OFFLOAD_DISK parks on NVMe with
        # a staged two-hop restore, FREE recomputes)
        r = s.cur
        action, ttl = self.policy.on_tool_yield(s, now)
        if self.trace_ticks:
            # audit record: the chosen retention action next to the priced
            # alternatives it beat (None fields for policies that don't
            # price) — trace_report surfaces near-miss decisions from these
            audit = getattr(self.policy, "retention_audit", None)
            prices = audit(s, now) if audit is not None else {}
            self.bus.emit(ev.RETENTION, now, s.sid, action=action.name,
                          ttl=ttl, blocks=s.kv_blocks,
                          tokens=s.resident_len, **prices)
        if action == KVAction.PIN and s.kv_blocks > 0:
            s.kv_state = KVState.PINNED
            s.pinned_since = now
            s.pin_ttl = ttl
            self.blocks.pin(s.kv_blocks)
            self.pinned.append(s)
            self.bus.emit(ev.PIN, now, s.sid, blocks=s.kv_blocks, ttl=ttl)
        elif action == KVAction.SWAP and s.kv_blocks > 0:
            # legacy path (InferCept baseline): stock-swapper timing, no
            # tier accounting — the backend charges swap_time() per side.
            # Every block is flagged private (whole-context copy): the
            # stock swapper is blind to sharing.
            s.meta["swapped_len"] = s.resident_len
            s.meta["swap_pages"] = [(bid, self.blocks.gen(bid), True)
                                    for bid in self.blocks.lease(s.sid)]
            freed = self.blocks.release_all(s.sid)
            assert freed == s.kv_blocks
            self.bus.emit(ev.SWAP_OUT, now, s.sid, blocks=s.kv_blocks)
            self._pending_swapouts.append((s, s.resident_len))
            s.kv_blocks = 0
            s.resident_len = 0
            s.kv_state = KVState.SWAPPED
        elif (action in (KVAction.OFFLOAD, KVAction.OFFLOAD_DISK)
              and s.kv_blocks > 0
              and self._offload_kv(s, now,
                                   target=("disk"
                                           if action == KVAction.OFFLOAD_DISK
                                           else "host"))):
            pass
        else:
            self._release_kv(s, now, reason="tool_free")
        s.phase = Phase.TOOL
        s.tool_started = now
        self.tools.start(s, r.tool_kind or "default", r.tool_seconds, now)


# ---------------------------------------------------------------------------
# simulation driver
# ---------------------------------------------------------------------------

def run_sim(engine: Engine, sessions: List[Session], *, max_time: float = 1e7,
            max_ticks: int = 2_000_000, idle_step: float = 0.5
            ) -> Tuple[List[Session], float]:
    """Discrete-event run: injects arrivals, jumps the clock over idle gaps.

    Returns (finished sessions, horizon = last finish or final clock)."""
    arrivals = sorted(sessions, key=lambda s: s.arrival_time)
    i = 0
    now = 0.0
    ticks = 0
    while ticks < max_ticks and now < max_time:
        ticks += 1
        while i < len(arrivals) and arrivals[i].arrival_time <= now:
            engine.submit(arrivals[i])
            i += 1
        elapsed, progressed = engine.tick(now)
        if elapsed > 0:
            now += elapsed
            continue
        if progressed:
            continue
        if engine.done() and i >= len(arrivals):
            break
        # idle: jump to the next event
        candidates = []
        t_tool = engine.tools.next_event_time()
        if t_tool is not None:
            candidates.append(t_tool)
        t_timer = engine.next_timer_event(now)
        if t_timer is not None:
            candidates.append(t_timer)
        if i < len(arrivals):
            candidates.append(arrivals[i].arrival_time)
        if engine.waiting:
            candidates.append(now + idle_step)   # let AIMD window recover
        if not candidates:
            break
        now = max(now + 1e-9, min(candidates))
    horizon = max((s.finish_time for s in engine.finished), default=now)
    return engine.finished, horizon


def run_live(engine: Engine, sessions: List[Session], *, timeout: float = 300.0,
             idle_sleep: float = 0.005) -> Tuple[List[Session], float]:
    """Wall-clock run with the live backend + RealToolExecutor.

    ``Session.arrival_time`` is interpreted as seconds from start."""
    import time as _time
    t0 = _time.monotonic()
    arrivals = sorted(sessions, key=lambda s: s.arrival_time)
    i = 0
    while _time.monotonic() - t0 < timeout:
        now = _time.monotonic() - t0
        while i < len(arrivals) and arrivals[i].arrival_time <= now:
            engine.submit(arrivals[i])
            i += 1
        elapsed, progressed = engine.tick(now)
        if engine.done() and i >= len(arrivals):
            break
        if not progressed and elapsed == 0.0:
            _time.sleep(idle_sleep)
    horizon = max((s.finish_time for s in engine.finished),
                  default=_time.monotonic() - t0)
    return engine.finished, horizon
