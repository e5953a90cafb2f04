"""Host-DRAM offload tier: the third retention outcome.

Capacity-accounted KV residency in host memory with a PCIe-bandwidth cost
model. Unlike the legacy swap path (InferCept's stock-vLLM swapper: per-
layer-per-block scattered DMAs, ~3 GB/s effective, serialized with the
engine step), this tier models an engineered batched-DMA path:

* swap-OUT is asynchronous — the copy overlaps tool execution (and, on the
  live path, the other sessions' compute via the background swap stream);
  the entry only becomes *restorable* once the transfer completes. How
  completion is observed depends on the path: the sim keeps the cost model
  as its "future" (``ready_at`` on the sim clock), while the live runner
  attaches the real :class:`~repro.kvcache.swap_stream.TransferFuture` of
  the D2H drain and ``ready`` gates on that instead of the modeled time;
* swap-IN serializes only when it must: the sim charges the engineered
  restore time via ``meta["swap_cost_s"]``, and the live paged runner
  *prefetches* the H2D crossing on the swap stream so a restore whose
  future already resolved charges nothing (the engine stamps
  ``meta["swap_cost_s"] = 0.0`` for it).

On the live ``jax_runner`` path the same BatchWork swap entries are executed
with real ``jax.device_get`` / ``jax.device_put`` of the per-block page
regions, on the background stream when the backend runs one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass
class HostTierConfig:
    capacity_blocks: int = 32_768
    pcie_bw: float = 24e9          # bytes/s, batched contiguous DMA
    base_latency_s: float = 5e-4   # per-transfer setup


class _InFlight:
    """Sentinel "future" for a swap-out whose real transfer future has not
    been attached yet (the backend creates it inside ``run_batch``, one
    tick after the engine registers the entry): never done, so ``ready``
    cannot fall back to the modeled clock and restore pages that were
    never drained."""

    @staticmethod
    def done() -> bool:
        return False


IN_FLIGHT = _InFlight()


@dataclass
class _Entry:
    tokens: int
    blocks: int
    ready_at: float                # modeled completion (the sim's "future")
    future: Optional[object] = None  # real transfer future (live path)


class HostTier:
    def __init__(self, cfg: HostTierConfig, bytes_per_token: float,
                 block_size: int):
        self.cfg = cfg
        self.bytes_per_token = max(1.0, float(bytes_per_token))
        self.block_size = block_size
        self._entries: Dict[int, _Entry] = {}
        self._used = 0          # running sum(e.blocks) — keeps probes O(1)
        # stats
        self.stores = 0
        self.hits = 0           # completed swap-ins (offload paid off)
        self.drops = 0          # entries abandoned (recompute fallback / free)
        self.bytes_moved = 0.0

    # --- cost model ----------------------------------------------------
    def swap_seconds(self, n_tokens: int) -> float:
        if n_tokens <= 0:
            return 0.0
        return self.cfg.base_latency_s + \
            n_tokens * self.bytes_per_token / self.cfg.pcie_bw

    # --- occupancy -----------------------------------------------------
    @property
    def capacity_blocks(self) -> int:
        return self.cfg.capacity_blocks

    @property
    def used_blocks(self) -> int:
        return self._used

    def can_store(self, blocks: int) -> bool:
        return self._used + blocks <= self.cfg.capacity_blocks

    def holds(self, sid: int) -> bool:
        return sid in self._entries

    # --- lifecycle -----------------------------------------------------
    def store(self, sid: int, tokens: int, blocks: int, now: float, *,
              extra_delay_s: float = 0.0) -> float:
        """Register an offload; returns modeled transfer seconds. The entry
        starts on the modeled "future" (restorable from ``now + seconds``
        on the sim clock); a live backend replaces that with the real
        transfer future via ``mark_in_flight``/``attach_future``.
        ``extra_delay_s`` pushes restorability out beyond the DMA itself —
        the TieredStore charges the D2H staging copy's CPU-pool queueing
        delay through it."""
        assert sid not in self._entries, f"double offload of sid {sid}"
        sec = self.swap_seconds(tokens) + max(0.0, extra_delay_s)
        self._entries[sid] = _Entry(tokens, blocks, now + sec)
        self._used += blocks
        self.stores += 1
        self.bytes_moved += tokens * self.bytes_per_token
        return sec

    def mark_in_flight(self, sid: int) -> None:
        """Async backends: gate ``ready`` on a real transfer future from
        the moment of registration. Until ``attach_future`` delivers one,
        the entry is never ready (the D2H drain has not even started)."""
        e = self._entries.get(sid)
        if e is not None:
            e.future = IN_FLIGHT

    def attach_future(self, sid: int, future) -> None:
        """Swap-completion handshake: bind the backend's real transfer
        future (created inside ``run_batch``) to the entry. Tolerates a
        missing entry — the session may have been detached or dropped to
        recompute between batch formation and execution."""
        e = self._entries.get(sid)
        if e is not None and future is not None:
            e.future = future

    def ready(self, sid: int, now: float) -> bool:
        """Restorable? Future-gated entries answer from the *real* transfer
        (done == the bytes are in host memory); modeled entries answer from
        the sim clock (``now >= ready_at``) — the cost model is the sim
        path's future, bit-identical to the pre-stream behaviour."""
        e = self._entries.get(sid)
        if e is None:
            return False
        if e.future is not None:
            return e.future.done()
        return now >= e.ready_at

    def time_to_ready(self, sid: int, now: float) -> Optional[float]:
        """Seconds until the swap-out transfer makes ``sid`` restorable.
        Modeled entries answer exactly ``max(0, ready_at - now)``; future-
        gated entries answer 0.0 once the transfer resolved and None while
        it is in flight (the wall clock, not the model, decides). None for
        unknown sids."""
        e = self._entries.get(sid)
        if e is None:
            return None
        if e.future is not None:
            return 0.0 if e.future.done() else None
        return max(0.0, e.ready_at - now)

    def load(self, sid: int, now: float) -> Optional[int]:
        """Swap-in completed: release host capacity, count the hit.

        Hardened to match ``drop``'s tolerance: an unknown sid (entry
        already dropped/detached between batch formation and commit) or a
        still-in-flight one (future-gated transfer unresolved — the bytes
        are not in host memory) returns the None sentinel for the caller
        to handle instead of KeyError-ing the engine; the in-flight entry
        is retained so the transfer can still land."""
        e = self._entries.get(sid)
        if e is None:
            return None
        if e.future is not None and not e.future.done():
            return None
        del self._entries[sid]
        self._used -= e.blocks
        self.hits += 1
        self.bytes_moved += e.tokens * self.bytes_per_token
        return e.tokens

    def drop(self, sid: int) -> None:
        """Abandon an entry (session fell back to recompute or finished)."""
        e = self._entries.pop(sid, None)
        if e is not None:
            self._used -= e.blocks
            self.drops += 1

    # --- tier migration (TieredStore) -----------------------------------
    def peek(self, sid: int) -> Optional[Tuple[int, int]]:
        """(tokens, blocks) of an entry without consuming it; None when
        unknown."""
        e = self._entries.get(sid)
        return None if e is None else (e.tokens, e.blocks)

    def evacuate(self, sid: int) -> Optional[Tuple[int, int]]:
        """Remove an entry for tier migration *without* counting a drop or
        a hit (the bytes move tiers, the retention outcome is still open);
        returns (tokens, blocks) or None for unknown sids."""
        e = self._entries.pop(sid, None)
        if e is None:
            return None
        self._used -= e.blocks
        return e.tokens, e.blocks

    def admit_staged(self, sid: int, tokens: int, blocks: int, now: float,
                     *, transfer_s: float, future=None) -> None:
        """Register an entry arriving from another tier (NVMe promotion):
        restorable after ``transfer_s`` on the sim clock, or — live path —
        when ``future`` (the file-read job) resolves. Counts a store, so
        ``hit_rate`` stays entries-restored / entries-registered."""
        assert sid not in self._entries, f"double admit of sid {sid}"
        self._entries[sid] = _Entry(tokens, blocks, now + transfer_s, future)
        self._used += blocks
        self.stores += 1
        self.bytes_moved += tokens * self.bytes_per_token

    def next_event_time(self, now: float) -> Optional[float]:
        """Earliest in-flight *modeled* transfer completion after ``now`` —
        the sim driver must not jump the clock past it while a restore is
        gated. Future-gated entries resolve on the wall clock, not the sim
        clock, so they are not timer events."""
        ts = [e.ready_at for e in self._entries.values()
              if e.future is None and e.ready_at > now]
        return min(ts) if ts else None

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.stores)
