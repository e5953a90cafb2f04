"""Scheduling policies: MARS + the paper's baselines (§6.2), all pluggable
into the same engine (identical tool stacks, batching, KV accounting — the
paper's fairness requirement).

    FCFS          vLLM default: arrival order, no admission, KV freed at tool
    Autellix      PLAS: program-level accumulated-service priority; resource-
                  agnostic (no admission control, no KV management)
    InferCept     one-shot min-cost {preserve | swap | discard} at tool time,
                  from per-tool-type EMA duration estimates
    Continuum     pin with fixed TTL at tool start
    Continuum-Dy  pin with TTL = EMA(tool kind) * factor
    MARS          external control plane (AIMD admission + queue packing) +
                  MLFQ coordinator + opportunistic co-scheduler (adaptive,
                  re-evaluated retention; priority-aligned eviction)
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Protocol, Sequence, Tuple

from repro_torch.core.admission import ControlPlaneConfig, ExternalControlPlane
from repro_torch.core.coscheduler import CoSchedulerConfig, OpportunisticCoScheduler
from repro_torch.core.events import EventBus
from repro_torch.core.mlfq import MLFQConfig, PriorityCoordinator
from repro_torch.core.session import KVAction, KVState, Session  # noqa: F401
from repro_torch.core.telemetry import Telemetry


class PerfOracle(Protocol):
    def recompute_time(self, n_tokens: int) -> float: ...
    def swap_time(self, n_tokens: int) -> float: ...
    def prefill_rate(self) -> float: ...   # sustainable prefill tokens/s


@dataclass
class Services:
    """Engine-owned services handed to the policy once, after construction
    (the policy-binding API — replaces the ``bind_services`` kwarg sprawl).

    * ``host_tier`` — the engine's ``TieredStore`` (host DRAM + NVMe
      orchestration; wears the same capacity/cost surface as a bare tier).
    * ``swap_size_fn`` — session -> (tokens, blocks) that would *actually*
      cross PCIe on offload (radix-shared blocks stay on device).
    * ``async_swap`` — the backend runs a background swap stream, so
      swap-in prefetches overlap other sessions' compute.
    * ``prefix_lookup`` — session -> blocks of its chunk-key prefix already
      indexed here (radix-aware admission sizing).
    * ``disk_tier`` — NVMe cold tier (None => three-way retention).
    * ``cpu_pool`` — the shared host-CPU core pool tools/swap/spool lease
      from: admission prices projected core-queueing delay, retention
      prices the CPU-side transfer delay into PIN/OFFLOAD/OFFLOAD_DISK.

    Baselines ignore what they don't price."""
    host_tier: Optional[object] = None
    swap_size_fn: Optional[Callable[[Session], Tuple[int, int]]] = None
    async_swap: bool = False
    prefix_lookup: Optional[Callable[[Session], int]] = None
    disk_tier: Optional[object] = None
    cpu_pool: Optional[object] = None


class Policy:
    """Engine hook points. The base class is the FCFS/throughput-centric
    engine: admit everything, serve in arrival order, drop KV at tool
    boundaries, preempt most-recent-first."""

    name = "fcfs"

    def __init__(self, telem: Telemetry, bus: EventBus, oracle: PerfOracle):
        self.telem = telem
        self.bus = bus
        self.oracle = oracle
        self.host_tier = None          # bound by the engine when tiered
        self.disk_tier = None          # NVMe cold tier (four-way retention)
        self.swap_size_fn = None       # session -> (tokens, blocks) moved
        self.async_swap = False        # backend runs a background swap stream
        self.prefix_lookup = None      # session -> indexed prefix blocks
        self.cpu_pool = None           # shared host-CPU core pool

    def bind(self, services: Services) -> None:
        """Bind the engine-owned ``Services`` bundle (see its docstring).
        Subclasses extend this — not ``bind_services``, which is only a
        deprecation shim around it."""
        self.host_tier = services.host_tier
        self.disk_tier = services.disk_tier
        self.swap_size_fn = services.swap_size_fn
        self.async_swap = services.async_swap
        self.prefix_lookup = services.prefix_lookup
        self.cpu_pool = services.cpu_pool

    def bind_services(self, host_tier=None, swap_size_fn=None,
                      async_swap=False, prefix_lookup=None,
                      disk_tier=None, cpu_pool=None) -> None:
        """Deprecated kwarg form of :meth:`bind` — kept one release for
        out-of-tree callers; routes through ``bind(Services(...))`` so
        subclass extensions of ``bind`` still run."""
        warnings.warn(
            "Policy.bind_services(**kwargs) is deprecated; pass a single "
            "Services dataclass to Policy.bind() instead",
            DeprecationWarning, stacklevel=2)
        self.bind(Services(host_tier=host_tier, swap_size_fn=swap_size_fn,
                           async_swap=async_swap, prefix_lookup=prefix_lookup,
                           disk_tier=disk_tier, cpu_pool=cpu_pool))

    # --- admission (external) ----------------------------------------------
    def admit(self, queue: List[Session], now: float) -> List[Session]:
        return list(queue)

    # --- intra-engine ordering ----------------------------------------------
    def order(self, ready: Sequence[Session], now: float) -> List[Session]:
        return sorted(ready, key=lambda s: s.arrival_time)

    # --- iteration-level batching hooks -------------------------------------
    def prefill_budget(self, token_budget: int, decode_tokens: int) -> int:
        """Prefill token budget for one mixed iteration, given the tokens
        the decode lanes already claimed. Baselines: whatever the decodes
        left (no split — prefill waves may inflate the iteration)."""
        return max(0, token_budget - decode_tokens)

    def charge_service(self, s: Session, tokens: int, now: float) -> None:
        """Charge ``tokens`` of GPU service dispatched this iteration.
        Baselines: plain accumulation. MARS routes this through the MLFQ's
        quantum-by-token accounting."""
        s.service_tokens += tokens

    # --- tool boundary --------------------------------------------------------
    def on_tool_yield(self, s: Session, now: float) -> Tuple[KVAction, float]:
        return KVAction.FREE, 0.0

    def tick_pinned(self, pinned: Sequence[Session], now: float) -> List[Session]:
        """Pins to revoke this tick (TTL expiry / re-evaluation)."""
        return []

    def revoke_actions(self, pinned: Sequence[Session], now: float
                       ) -> List[Tuple[Session, KVAction]]:
        """Three-way revocation: (session, FREE | OFFLOAD) per revoked pin.
        Baselines drop; MARS may demote to the host tier instead."""
        return [(s, KVAction.FREE) for s in self.tick_pinned(pinned, now)]

    def reclaim_order(self, pinned: Sequence[Session], now: float) -> List[Session]:
        return sorted(pinned, key=lambda s: s.pinned_since)

    def reclaim_action(self, s: Session, now: float) -> KVAction:
        """What to do with a pin reclaimed under allocation pressure."""
        return KVAction.FREE

    # --- eviction/preemption ---------------------------------------------------
    def eviction_order(self, victims: Sequence[Session], now: float,
                       requester: Optional[Session] = None) -> List[Session]:
        """Victims the ``requester`` may preempt, best-first. vLLM default:
        LIFO by arrival, and a requester never preempts sessions that arrived
        before it (stability: the eviction order is the reverse of the
        service order, so mutual-eviction livelock is impossible)."""
        if requester is not None:
            victims = [v for v in victims
                       if v.arrival_time > requester.arrival_time]
        return sorted(victims, key=lambda s: -s.arrival_time)

    # --- prefill chunking --------------------------------------------------------
    def prefill_chunk(self, want_tokens: int, free_blocks: int,
                      block_size: int) -> int:
        """Baselines: fixed-granularity chunked prefill, no shrinking."""
        if free_blocks <= 0:
            return 0
        grantable = free_blocks * block_size
        return want_tokens if want_tokens <= grantable else 0


class AutellixPolicy(Policy):
    """Program-Level Aware Scheduling: cumulative *program* service-time
    priority, snapshotted at call submission (non-preemptive at the call
    level — a call's priority does not decay while it runs)."""

    name = "autellix"

    def order(self, ready, now):
        for s in ready:
            if "plas_key" not in s.meta or s.meta.get("plas_round") != s.cur_round:
                s.meta["plas_key"] = s.service_seconds
                s.meta["plas_round"] = s.cur_round
        return sorted(ready, key=lambda s: (s.meta["plas_key"], s.arrival_time))


class InferCeptPolicy(Policy):
    """Min-cost one-shot {preserve, swap, discard} at the tool boundary.

    Costs in byte-seconds (memory waste x duration), following InferCept's
    formulation, with EMA tool-duration estimates."""

    name = "infercept"

    def on_tool_yield(self, s, now):
        est = self.telem.tool_estimate(s.cur.tool_kind)
        kv = max(1, s.kv_blocks)
        preserve = kv * est
        swap = kv * 2.0 * self.oracle.swap_time(s.resident_len)
        discard = 0.5 * kv * self.oracle.recompute_time(s.resident_len)
        best = min((preserve, KVAction.PIN), (swap, KVAction.SWAP),
                   (discard, KVAction.FREE), key=lambda x: x[0])
        return best[1], float("inf")   # one-shot: no TTL re-evaluation


class ContinuumPolicy(Policy):
    """Fixed KV time-to-live at tool start."""

    name = "continuum"
    fixed_ttl = 30.0

    def on_tool_yield(self, s, now):
        return KVAction.PIN, self.fixed_ttl

    def tick_pinned(self, pinned, now):
        return [s for s in pinned if now - s.pinned_since > s.pin_ttl]

    def reclaim_order(self, pinned, now):
        # closest-to-expiry first
        return sorted(pinned, key=lambda s: s.pinned_since + s.pin_ttl - now)


class ContinuumDynPolicy(ContinuumPolicy):
    """TTL = per-tool-kind EMA estimate x factor (official dynamic heuristic)."""

    name = "continuum-dy"
    ttl_factor = 1.25

    def on_tool_yield(self, s, now):
        est = self.telem.tool_estimate(s.cur.tool_kind)
        return KVAction.PIN, max(1.0, self.ttl_factor * est)


@dataclass
class MARSConfig:
    control: ControlPlaneConfig = field(default_factory=ControlPlaneConfig)
    mlfq: MLFQConfig = field(default_factory=MLFQConfig)
    cosched: CoSchedulerConfig = field(default_factory=CoSchedulerConfig)
    # ablations (paper Fig. 13)
    disable_control_plane: bool = False
    disable_coordinator: bool = False
    disable_coscheduler: bool = False


class MARSPolicy(Policy):
    name = "mars"

    def __init__(self, telem, bus, oracle, cfg: Optional[MARSConfig] = None):
        super().__init__(telem, bus, oracle)
        self.cfg = cfg or MARSConfig()
        self.control = ExternalControlPlane(self.cfg.control, telem, bus)
        self.coord = PriorityCoordinator(self.cfg.mlfq)
        self.cosched = OpportunisticCoScheduler(
            self.cfg.cosched, telem, oracle.recompute_time,
            getattr(oracle, "prefill_rate", None))
        if self.cfg.disable_control_plane:
            self.name = "mars-no-ctrl"
        if self.cfg.disable_coordinator:
            self.name = "mars-no-coord"
        if self.cfg.disable_coscheduler:
            self.name = "mars-no-cosched"

    def bind(self, services: Services) -> None:
        super().bind(services)
        host_tier, disk_tier = services.host_tier, services.disk_tier
        swap_size_fn = services.swap_size_fn
        # radix-aware admission (Alg. 1 ext.): queue packing estimates
        # footprint net of the already-indexed shared prefix
        self.control.prefix_lookup = services.prefix_lookup
        # CPU-oversubscription admission term: the control plane defers
        # admits whose tool profile would push core-queueing delay past
        # its bound, the way it already prices HBM blocks
        self.control.cpu_pool = services.cpu_pool
        self.cosched.swap_seconds = \
            host_tier.swap_seconds if host_tier is not None else None
        # price the PCIe leg by what per-block offload actually moves
        self.cosched.swap_tokens = \
            (lambda s: swap_size_fn(s)[0]) if swap_size_fn else None
        # async stream: prefetched swap-ins overlap other sessions'
        # compute, so the restore no longer serializes a GPU tick
        self.cosched.swap_in_overlapped = bool(services.async_swap)
        # NVMe cold tier: staged-restore pricing for the fourth outcome
        self.cosched.disk_read_seconds = \
            disk_tier.read_seconds if disk_tier is not None else None
        self.cosched.disk_write_seconds = \
            disk_tier.write_seconds if disk_tier is not None else None
        # CPU-side transfer delay: staging copies lease from the shared
        # core pool, so a warm resume is only worth choosing when the CPU
        # side can deliver it — retention subtracts the projected core
        # wait from the offload/disk nets
        pool = services.cpu_pool
        if pool is not None and pool.cfg.transfer_cpu_frac > 0.0:
            frac = pool.cfg.transfer_cpu_frac
            self.cosched.cpu_wait = (
                lambda cost_s, now: pool.queue_wait_estimate(
                    now, frac * cost_s))
        else:
            self.cosched.cpu_wait = None

    def _sized_blocks(self, s: Session) -> int:
        if self.swap_size_fn is not None:
            # per-block offload: only private (non-shared) blocks occupy
            # the tier — same sizing _offload_kv's can_store will apply
            return self.swap_size_fn(s)[1]
        # size with the tier's own block size (= engine block size), not
        # cosched.block_size — they are configured independently and a
        # drifted precheck would disagree with _offload_kv's can_store
        return -(-s.resident_len // self.host_tier.block_size)

    def _host_can_take(self, s: Session) -> bool:
        if self.host_tier is None:
            return False
        return self.host_tier.can_store(self._sized_blocks(s))

    def _disk_can_take(self, s: Session) -> bool:
        if self.host_tier is None or self.disk_tier is None:
            return False
        return self.disk_tier.can_store(self._sized_blocks(s))

    def _offload_fallback(self, s: Session, now: float,
                          action: KVAction) -> KVAction:
        """Capacity-checked tier choice: the preferred off-device tier
        falls back to the other when full — but only if the other tier's
        own net benefit is positive — and to FREE when neither works."""
        if action == KVAction.OFFLOAD_DISK:
            if self._disk_can_take(s):
                return KVAction.OFFLOAD_DISK
            if self.cosched.offload_net(s, now) > 0.0 \
                    and self._host_can_take(s):
                return KVAction.OFFLOAD        # warm tier as second choice
        elif action == KVAction.OFFLOAD:
            if self._host_can_take(s):
                return KVAction.OFFLOAD
            if self.cosched.disk_net(s, now) > 0.0 \
                    and self._disk_can_take(s):
                return KVAction.OFFLOAD_DISK   # DRAM full: cold tier still
        return KVAction.FREE                   # beats recompute

    # external control plane
    def admit(self, queue, now):
        if self.cfg.disable_control_plane:
            return list(queue)
        return self.control.balance_and_admit(queue, now)

    # priority-aware coordinator
    def order(self, ready, now):
        if self.cfg.disable_coordinator:
            return sorted(ready, key=lambda s: s.arrival_time)
        return self.coord.order(ready, now)

    def charge_service(self, s, tokens, now):
        if self.cfg.disable_coordinator:
            super().charge_service(s, tokens, now)
            return
        self.coord.charge(s, tokens)

    # opportunistic co-scheduler: prefill/decode budget split per iteration
    def prefill_budget(self, token_budget, decode_tokens):
        if self.cfg.disable_coscheduler:
            return super().prefill_budget(token_budget, decode_tokens)
        return self.cosched.split_budget(token_budget, decode_tokens)

    def eviction_order(self, victims, now, requester=None):
        if self.cfg.disable_coordinator:
            return super().eviction_order(victims, now, requester)
        if requester is not None:
            # preemption authority is arrival-stable (no cycles, FCFS-grade
            # churn bounds); *among* the allowed victims the choice is
            # priority-aligned (lowest MLFQ priority first, largest KV first)
            # as per §4.3.
            victims = [v for v in victims
                       if v.arrival_time > requester.arrival_time]
        return self.coord.eviction_order(victims, now)

    # opportunistic co-scheduler (four-way adaptive retention, §4.3 ext.)
    def retention_audit(self, s, now):
        """Priced alternatives behind the retention decision, for the
        observability layer's audit records (repro.obs): the three net
        benefits ``retention_decision`` compared (read from its stash —
        re-pricing would double the swap-sizing cost on every tool yield),
        plus the recompute cost a FREE would re-pay. Infinite sentinels
        (disabled tiers) are reported as None so the record stays
        JSON-serializable."""
        if self.cfg.disable_coscheduler:
            return {}

        def _fin(x):
            if x is None or x in (float("inf"), float("-inf")):
                return None
            return round(x, 6)

        p = self.cosched.last_prices
        return {
            "pin_net": _fin(p.get("pin_net")),
            "offload_net": _fin(p.get("offload_net")),
            "disk_net": _fin(p.get("disk_net")),
            "recompute_s": round(self.cosched.recompute_time(s.resident_len),
                                 6),
        }

    def on_tool_yield(self, s, now):
        if self.cfg.disable_coscheduler:
            return KVAction.FREE, 0.0
        action = self.cosched.retention_decision(s, now)
        if action == KVAction.PIN:
            return KVAction.PIN, float("inf")   # adaptive: revoked by ticks
        if action in (KVAction.OFFLOAD, KVAction.OFFLOAD_DISK):
            return self._offload_fallback(s, now, action), 0.0
        return KVAction.FREE, 0.0

    def revoke_actions(self, pinned, now):
        if self.cfg.disable_coscheduler:
            return [(s, KVAction.FREE) for s in pinned]
        out = []
        for s, action in self.cosched.revoke_actions(pinned, now):
            if action in (KVAction.OFFLOAD, KVAction.OFFLOAD_DISK):
                action = self._offload_fallback(s, now, action)
            out.append((s, action))
        return out

    def reclaim_order(self, pinned, now):
        if self.cfg.disable_coscheduler:
            return super().reclaim_order(pinned, now)
        return self.cosched.reclaim_order(pinned, now)

    def reclaim_action(self, s, now):
        """A pin reclaimed under pressure demotes to host DRAM (or the
        NVMe cold tier when DRAM is full or the idle window is long) when
        the restore still beats the recompute it would otherwise cause."""
        if self.cfg.disable_coscheduler:
            return KVAction.FREE
        action = self.cosched.retention_decision(s, now)
        if action in (KVAction.OFFLOAD, KVAction.OFFLOAD_DISK):
            return self._offload_fallback(s, now, action)
        if self.cosched.offload_net(s, now) > 0.0 and self._host_can_take(s):
            return KVAction.OFFLOAD
        return KVAction.FREE

    def prefill_chunk(self, want_tokens, free_blocks, block_size):
        if self.cfg.disable_coscheduler:
            return super().prefill_chunk(want_tokens, free_blocks, block_size)
        return self.cosched.shrink_chunk(want_tokens, free_blocks)


POLICY_CLASSES = {
    "fcfs": Policy,
    "autellix": AutellixPolicy,
    "infercept": InferCeptPolicy,
    "continuum": ContinuumPolicy,
    "continuum-dy": ContinuumDynPolicy,
    "mars": MARSPolicy,
}


def make_policy(name: str, telem: Telemetry, bus: EventBus, oracle: PerfOracle,
                mars_cfg: Optional[MARSConfig] = None) -> Policy:
    if name.startswith("mars"):
        cfg = mars_cfg or MARSConfig(
            disable_control_plane=(name == "mars-no-ctrl"),
            disable_coordinator=(name == "mars-no-coord"),
            disable_coscheduler=(name == "mars-no-cosched"))
        return MARSPolicy(telem, bus, oracle, cfg)
    return POLICY_CLASSES[name](telem, bus, oracle)
