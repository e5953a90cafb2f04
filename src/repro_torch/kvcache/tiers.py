"""TieredStore: host-DRAM + NVMe orchestration for offloaded KV state.

One object owns the two off-device tiers and every move between them, so
the engine talks to a single surface (``store`` / ``request`` / ``load`` /
``drop``) and capacity accounting can never double-count an entry: a sid
lives in **exactly one** tier at any instant.

Decision model
--------------

All placement follows the same net-benefit currency MARS retention uses —
seconds of GPU work saved vs. seconds of restore paid:

* **direct offload** (tool yield): the co-scheduler's four-way
  ``retention_decision`` picks PIN / OFFLOAD (host) / OFFLOAD_DISK / FREE.
  Disk wins when retention still nets positive under the *staged* restore
  cost but the expected idle window is long enough (or host DRAM full
  enough) that parking the bytes in DRAM wastes the warmer tier.

* **demotion** (``maintain``, every engine tick): a host entry is demoted
  to NVMe when it is *cold* (idle past ``demote_after_s`` while its
  session still sits in a tool), host occupancy is past
  ``demote_watermark``, the NVMe tier has room, and retention on disk
  still beats recompute::

      recompute_time(context_tokens)  >  staged_restore_seconds(tokens)

  Entries whose staged restore would cost more than rebuilding are *not*
  demoted (they stay in DRAM where the restore is still a win); the store
  never unilaterally drops an entry — only the engine decides to abandon.

* **promotion** (``request``, on access): when a session wants its KV back
  and the entry sits on NVMe, the store issues the staged first hop
  (NVMe -> DRAM read through the device's bounded queue) and re-registers
  the entry in the host tier gated on that read; the engine's normal
  swap-in path then pays only the second hop (DRAM -> device over PCIe),
  gen-certified against the block pool exactly like a host-only restore.

Staged-restore cost formula (what both the co-scheduler's ``disk_net`` and
the demotion gate price)::

    staged_restore_s(tokens) = disk.read_seconds(tokens)   # NVMe -> DRAM
                             + host.swap_seconds(tokens)   # DRAM -> HBM

The first hop gates *readiness* (the session waits, the GPU does not); the
second hop is the familiar PCIe swap-in, overlapped by the async swap
stream when the backend runs one.

Data plane
----------

The sim keeps the cost models as its futures (modeled ``ready_at`` on the
sim clock). A live backend binds ``spill``/``unspill`` callbacks
(:meth:`bind_backend`): demotion then submits a file write of the host KV
copy on the background swap stream (FIFO-ordered behind the D2H drain that
produces the bytes) and promotion submits the file read back; the returned
transfer futures gate the owning tier's ``ready`` instead of the model.
Transient staging during a direct device->NVMe offload is bounded by the
stream's double-buffered slots and is not charged to host-tier capacity.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.events import DEMOTE, PROMOTE
from repro_torch.kvcache.disk_tier import DiskTier
from repro_torch.kvcache.host_tier import HostTier


class _EntryMeta:
    __slots__ = ("context_tokens", "stored_at", "target")

    def __init__(self, context_tokens: int, stored_at: float, target: str):
        self.context_tokens = context_tokens   # full resident_len at offload
        self.stored_at = stored_at             # last placement change
        self.target = target                   # tier the entry was aimed at


class TieredStore:
    def __init__(self, host: HostTier, disk: Optional[DiskTier] = None, *,
                 recompute_time: Optional[Callable[[int], float]] = None,
                 demote_after_s: float = 30.0,
                 demote_watermark: float = 0.5,
                 bus=None, cpu_pool=None):
        self.host = host
        self.disk = disk
        self.recompute_time = recompute_time
        self.demote_after_s = demote_after_s
        self.demote_watermark = demote_watermark
        self.bus = bus
        # shared host-CPU core pool: every tier move stages through host
        # cores (D2H/H2D memcpy pumps, spool read/write syscalls), so each
        # transfer leases ``transfer_cpu_frac`` of its wire time from the
        # pool at transfer priority; the lease's queueing delay pushes the
        # entry's readiness out (a tool burst visibly delays swap drains
        # and staged NVMe restores). None => transfers are CPU-free.
        self.cpu_pool = cpu_pool
        self._meta: Dict[int, _EntryMeta] = {}
        # live data-plane callbacks (sid -> Optional[TransferFuture])
        self._spill = None
        self._unspill = None
        # per-tick demotability predicate (engine: session still in tool)
        self._demotable: Optional[Callable[[int], bool]] = None
        # stats
        self.demotions = 0
        self.staged_restores = 0       # promotions issued (disk -> host)
        self.direct_to_disk = 0
        self.cpu_wait_s = 0.0          # readiness delay added by core waits

    def _stage_cpu(self, now: float, sid: int, wire_s: float, kind: str,
                   tag: str) -> float:
        """Lease the staging-copy CPU for a ``wire_s``-second transfer from
        the shared pool; returns the extra seconds (queueing + interference
        beyond the wire time) the caller must add to the entry's readiness.
        0.0 when no pool is bound or the transfer is free."""
        if self.cpu_pool is None or wire_s <= 0.0:
            return 0.0
        frac = self.cpu_pool.cfg.transfer_cpu_frac
        if frac <= 0.0:
            return 0.0
        lease = self.cpu_pool.submit(now, frac * wire_s, sid=sid,
                                     kind=kind, tag=tag, priority=0)
        extra = max(0.0, lease.end - (now + wire_s))
        self.cpu_wait_s += extra
        return extra

    def bind_backend(self, spill=None, unspill=None) -> None:
        """Live path: ``spill(sid)`` writes the backend's host KV copy of
        ``sid`` to the NVMe spool (freeing the DRAM copy) and returns the
        transfer future; ``unspill(sid)`` reads it back ahead of a
        promotion. Either may return None (synchronous completion)."""
        self._spill = spill
        self._unspill = unspill

    # --- delegated surface (HostTier-compatible) ------------------------
    @property
    def block_size(self) -> int:
        return self.host.block_size

    def swap_seconds(self, n_tokens: int) -> float:
        """PCIe hop (DRAM <-> HBM) — the engine's swap-in stamp and the
        policies' offload pricing, unchanged from the host-only tier."""
        return self.host.swap_seconds(n_tokens)

    def staged_restore_seconds(self, n_tokens: int) -> float:
        """Both hops of a cold restore: NVMe read + PCIe up."""
        if self.disk is None:
            return self.host.swap_seconds(n_tokens)
        return self.disk.read_seconds(n_tokens) + \
            self.host.swap_seconds(n_tokens)

    def can_store(self, blocks: int) -> bool:
        return self.host.can_store(blocks)

    def can_store_disk(self, blocks: int) -> bool:
        return self.disk is not None and self.disk.can_store(blocks)

    def holds(self, sid: int) -> bool:
        return self.host.holds(sid) or \
            (self.disk is not None and self.disk.holds(sid))

    def tier_of(self, sid: int) -> Optional[str]:
        if self.host.holds(sid):
            return "host"
        if self.disk is not None and self.disk.holds(sid):
            return "disk"
        return None

    # --- lifecycle ------------------------------------------------------
    def store(self, sid: int, tokens: int, blocks: int, now: float, *,
              target: str = "host", context_tokens: Optional[int] = None
              ) -> float:
        """Register an offload into ``target``; returns modeled seconds to
        durability. ``target="disk"`` without a disk tier falls back to
        host (the policy's capacity precheck should prevent it)."""
        if target == "disk" and self.disk is None:
            target = "host"
        self._meta[sid] = _EntryMeta(
            context_tokens if context_tokens is not None else tokens,
            now, target)
        if target == "disk":
            self.direct_to_disk += 1
            # staged write: the D2H leg stages through bounded stream
            # buffers (not host-tier capacity), then the NVMe write lands;
            # the D2H pump's core wait stretches the staging leg
            d2h = self.host.swap_seconds(tokens)
            extra = self._stage_cpu(now, sid, d2h, "swap", "d2h")
            return self.disk.store(
                sid, tokens, blocks, now,
                extra_delay_s=d2h + extra)
        sec = self.host.swap_seconds(tokens)
        extra = self._stage_cpu(now, sid, sec, "swap", "d2h")
        return self.host.store(sid, tokens, blocks, now,
                               extra_delay_s=extra)

    def mark_in_flight(self, sid: int) -> None:
        if self.host.holds(sid):
            self.host.mark_in_flight(sid)
        elif self.disk is not None and self.disk.holds(sid):
            self.disk.mark_in_flight(sid)

    def attach_future(self, sid: int, future) -> None:
        """Swap-completion handshake, tier-routed. For a direct-to-disk
        entry the D2H drain only produces the DRAM staging copy — when a
        spill callback is bound, the file write is chained on the same
        FIFO stream (so it runs after the drain) and *its* future gates
        the disk entry instead."""
        if self.host.holds(sid):
            self.host.attach_future(sid, future)
            return
        if self.disk is None or not self.disk.holds(sid):
            return
        if self._spill is not None:
            chained = self._spill(sid)
            if chained is not None:
                self.disk.attach_future(sid, chained)
                return
        self.disk.attach_future(sid, future)

    def ready(self, sid: int, now: float) -> bool:
        """Pure probe: restorable over one PCIe hop right now? Disk-tier
        entries are never directly ready — ``request`` must promote."""
        return self.host.ready(sid, now)

    def time_to_ready(self, sid: int, now: float) -> Optional[float]:
        if self.host.holds(sid):
            return self.host.time_to_ready(sid, now)
        if self.disk is not None and self.disk.holds(sid):
            t = self.disk.time_to_ready(sid, now)
            if t is None:
                return None
            # durable + unqueued read estimate (queueing applies at issue)
            tokens, _blocks = self.disk.peek(sid)
            return t + self.disk.read_seconds(tokens)
        return None

    def request(self, sid: int, now: float, *,
                urgent: bool = False) -> Optional[bool]:
        """The session wants its KV back. Returns True when the entry is
        host-resident and ready (the engine may form the swap-in), False
        while a transfer gates it, and None when restore can never proceed
        (unknown sid, or — only when ``urgent`` — a promotion blocked on
        host capacity that displacement could not fix): the caller should
        abandon to recompute."""
        if self.host.holds(sid):
            return self.host.ready(sid, now)
        if self.disk is None or not self.disk.holds(sid):
            return None
        if not self.disk.ready(sid, now):
            return False               # demotion/offload write still landing
        _tokens, blocks = self.disk.peek(sid)
        if not self.host.can_store(blocks):
            self._make_room(blocks, now)
        if not self.host.can_store(blocks):
            return None if urgent else False
        self._promote(sid, now)
        return self.host.ready(sid, now)

    def _promote(self, sid: int, now: float) -> None:
        _tokens, blocks = self.disk.peek(sid)
        tokens = self.disk.load(sid, now)
        assert tokens is not None      # caller checked disk.ready
        read_done = self.disk.issue_read(now, tokens)
        # the fill pump (file read -> DRAM staging buffer) runs on shared
        # cores: its queueing delay extends the first hop
        extra = self._stage_cpu(now, sid, read_done - now, "spool", "fill")
        done = read_done + extra
        fut = self._unspill(sid) if self._unspill is not None else None
        self.host.admit_staged(sid, tokens, blocks, now,
                               transfer_s=done - now, future=fut)
        m = self._meta.get(sid)
        if m is not None:
            m.stored_at = now          # promoted == hot: reset cold clock
            m.target = "host"
        self.staged_restores += 1
        if self.bus is not None:
            # read_s: the NVMe read (plus any fill-pump core wait) gating
            # the staged restore's first hop — the tracer turns
            # [t, t + read_s] into an I/O span
            self.bus.emit(PROMOTE, now, sid, blocks=blocks, tokens=tokens,
                          read_s=done - now)

    def load(self, sid: int, now: float) -> Optional[int]:
        """Swap-in committed: consume the (host-resident) entry. Returns
        the restored token count, or None for unknown/in-flight sids (the
        hardened sentinel — never a KeyError into the engine)."""
        self._meta.pop(sid, None)
        return self.host.load(sid, now)

    def drop(self, sid: int) -> None:
        self._meta.pop(sid, None)
        if self.host.holds(sid):
            self.host.drop(sid)
        elif self.disk is not None:
            self.disk.drop(sid)

    def next_event_time(self, now: float) -> Optional[float]:
        ts = []
        t = self.host.next_event_time(now)
        if t is not None:
            ts.append(t)
        if self.disk is not None:
            t = self.disk.next_event_time(now)
            if t is not None:
                ts.append(t)
        return min(ts) if ts else None

    # --- demotion -------------------------------------------------------
    def maintain(self, now: float,
                 demotable: Optional[Callable[[int], bool]] = None) -> int:
        """Per-tick upkeep: demote cold host entries to NVMe (see module
        docstring for the gate). ``demotable(sid)`` lets the engine veto
        entries whose session is no longer idle (back from its tool and
        about to restore — demoting those would ping-pong). Returns the
        number of demotions issued this call."""
        self._demotable = demotable
        if self.disk is None:
            return 0
        cap = max(1, self.host.capacity_blocks)
        if self.host.used_blocks <= self.demote_watermark * cap:
            return 0               # below watermark: skip the cold scan
        n = 0
        for sid in self._cold_first():
            if self.host.used_blocks <= self.demote_watermark * cap:
                break
            m = self._meta.get(sid)
            if m is None or now - m.stored_at < self.demote_after_s:
                break                  # cold-first order: the rest are newer
            if self._demote_one(sid, now, m):
                n += 1
        return n

    def _cold_first(self):
        """Host-tier sids, oldest placement first."""
        sids = [sid for sid in self._meta if self.host.holds(sid)]
        sids.sort(key=lambda sid: self._meta[sid].stored_at)
        return sids

    def _demote_one(self, sid: int, now: float, m: _EntryMeta) -> bool:
        if self._demotable is not None and not self._demotable(sid):
            return False
        if not self.host.ready(sid, now):
            return False               # D2H still in flight: bytes not in DRAM
        tokens, blocks = self.host.peek(sid)
        if not self.disk.can_store(blocks):
            return False
        if self.recompute_time is not None and \
                self.recompute_time(m.context_tokens) <= \
                self.staged_restore_seconds(tokens):
            return False               # disk would not beat recompute: stay
        idle_s = now - m.stored_at
        tokens, blocks = self.host.evacuate(sid)
        # the spool-write pump leases cores too: its wait delays durability
        extra = self._stage_cpu(now, sid, self.disk.write_seconds(tokens),
                                "spool", "write")
        self.disk.store(sid, tokens, blocks, now, extra_delay_s=extra)
        if self._spill is not None:
            fut = self._spill(sid)
            if fut is not None:
                self.disk.attach_future(sid, fut)
        m.stored_at = now
        m.target = "disk"
        self.demotions += 1
        if self.bus is not None:
            # write_s: the modeled spool write behind this demotion (the
            # entry is unreadable until it lands) — an I/O span for tracing
            self.bus.emit(DEMOTE, now, sid, blocks=blocks, tokens=tokens,
                          write_s=self.disk.write_seconds(tokens),
                          idle_s=idle_s)
        return True

    def _make_room(self, blocks: int, now: float) -> None:
        """Promotion displacement: demote cold-est ready host entries (age
        gate waived — the promoting session is *hot* and outranks anything
        idle) until ``blocks`` fit or nothing more can move."""
        if self.disk is None:
            return
        for sid in self._cold_first():
            if self.host.can_store(blocks):
                return
            m = self._meta.get(sid)
            if m is not None:
                self._demote_one(sid, now, m)

    # --- telemetry ------------------------------------------------------
    def stats(self) -> Dict:
        """Per-tier occupancy / hit-rate / traffic breakdown (exported via
        ``Telemetry.kv_tier_stats``)."""
        def _tier(t):
            return {
                "used_blocks": t.used_blocks,
                "capacity_blocks": t.capacity_blocks,
                "occupancy": t.used_blocks / max(1, t.capacity_blocks),
                "stores": t.stores,
                "hits": t.hits,
                "hit_rate": round(t.hit_rate, 4),
                "drops": t.drops,
            }
        return {
            "host": _tier(self.host),
            "disk": _tier(self.disk) if self.disk is not None else None,
            "demotions": self.demotions,
            "staged_restores": self.staged_restores,
            "direct_to_disk": self.direct_to_disk,
            "cpu_wait_s": round(self.cpu_wait_s, 6),
        }
