"""NVMe disk tier: the cold third layer of the KV-state hierarchy.

Where :mod:`repro.kvcache.host_tier` models an engineered batched-DMA PCIe
path, this tier models a local NVMe device the way serving systems actually
see one:

* **per-op latency** — every read/write pays a fixed device latency before
  any bytes move (NVMe ~100 us class, orders of magnitude above DRAM);
* **bandwidth asymmetry** — sequential read and write bandwidths are
  configured separately (consumer/datacenter NVMe writes meaningfully
  slower than it reads, and sustained writes slower still);
* **bounded queue depth** — the device serves at most ``queue_depth``
  modeled operations concurrently; further ops queue behind the earliest
  slot to free. A burst of demotions therefore *back-pressures itself*
  instead of completing at infinite aggregate bandwidth.

Entries are block-granular, like the host tier: only a session's private
blocks occupy capacity (the radix-shared prefix never leaves the device
pool). Readiness is future-aware with the same discipline as ``HostTier``:
the sim's "future" is the modeled completion time on the sim clock, a live
backend attaches the real :class:`~repro.kvcache.swap_stream.TransferFuture`
of the file write and ``ready`` gates on that instead.

Two backends share this accounting:

* **modeled** (default) — pure cost model, used by the discrete-event sim;
* **real-file** — :class:`DiskFileStore`, a spool directory of one
  ``.npz``-style file per session that the live runner's spill/fill jobs
  write and read through the background swap stream. The file store is the
  data plane only; capacity and readiness always live in :class:`DiskTier`.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.kvcache.host_tier import IN_FLIGHT


@dataclass
class DiskTierConfig:
    capacity_blocks: int = 262_144
    read_bw: float = 3.5e9         # bytes/s, sequential read
    write_bw: float = 1.8e9        # bytes/s, sustained sequential write
    op_latency_s: float = 1e-4     # per-op device latency (NVMe ~100 us)
    queue_depth: int = 16          # concurrent modeled ops; more ops queue


@dataclass
class _Entry:
    tokens: int
    blocks: int
    ready_at: float                # modeled completion (the sim's "future")
    future: Optional[object] = None  # real transfer future (live path)


class DiskTier:
    """Capacity accounting + NVMe cost model for the cold tier.

    The API mirrors ``HostTier`` (store / load / drop / ready /
    time_to_ready / next_event_time / mark_in_flight / attach_future) so
    :class:`~repro.kvcache.tiers.TieredStore` can move entries between the
    two with symmetric bookkeeping.
    """

    def __init__(self, cfg: DiskTierConfig, bytes_per_token: float,
                 block_size: int):
        self.cfg = cfg
        self.bytes_per_token = max(1.0, float(bytes_per_token))
        self.block_size = block_size
        self._entries: Dict[int, _Entry] = {}
        self._used = 0          # running sum(e.blocks) — keeps probes O(1)
        # bounded queue depth: completion time of each modeled in-flight op
        # slot; a new op starts at the earliest slot to free (or now).
        self._q_free = [0.0] * max(1, cfg.queue_depth)
        # stats
        self.stores = 0
        self.hits = 0           # entries promoted/restored (cold tier paid off)
        self.drops = 0          # entries abandoned (recompute fallback / free)
        self.bytes_moved = 0.0

    # --- cost model ----------------------------------------------------
    def _service_seconds(self, n_tokens: int, bw: float) -> float:
        if n_tokens <= 0:
            return 0.0
        return self.cfg.op_latency_s + \
            n_tokens * self.bytes_per_token / bw

    def read_seconds(self, n_tokens: int) -> float:
        """Unqueued NVMe -> DRAM service time (the first hop of a staged
        restore); policy-facing — queueing is applied when an op is issued."""
        return self._service_seconds(n_tokens, self.cfg.read_bw)

    def write_seconds(self, n_tokens: int) -> float:
        """Unqueued DRAM -> NVMe service time (demotion / direct offload)."""
        return self._service_seconds(n_tokens, self.cfg.write_bw)

    def _issue(self, now: float, service_s: float) -> float:
        """Admit one modeled op through the bounded queue: it starts at the
        earliest free slot (>= now) and occupies it for ``service_s``.
        Returns the completion time."""
        if service_s <= 0.0:
            return now
        i = min(range(len(self._q_free)), key=self._q_free.__getitem__)
        start = max(now, self._q_free[i])
        done = start + service_s
        self._q_free[i] = done
        return done

    def issue_read(self, now: float, n_tokens: int) -> float:
        """Issue one modeled promotion read through the bounded queue;
        returns its completion time (>= now + read_seconds when the queue
        is backed up)."""
        return self._issue(now, self.read_seconds(n_tokens))

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
        """Register a write into the cold tier; returns modeled seconds
        until the entry is durable (queue wait + op latency + bytes/bw).
        ``extra_delay_s`` front-loads an upstream staging leg (the PCIe D2H
        of a direct device->disk offload) before the NVMe op is issued."""
        assert sid not in self._entries, f"double disk store of sid {sid}"
        done = self._issue(now + extra_delay_s, self.write_seconds(tokens))
        self._entries[sid] = _Entry(tokens, blocks, done)
        self._used += blocks
        self.stores += 1
        self.bytes_moved += tokens * self.bytes_per_token
        return max(0.0, done - now)

    def mark_in_flight(self, sid: int) -> None:
        """Async backends: gate ``ready`` on a real transfer future from
        registration (same sentinel discipline as the host tier)."""
        e = self._entries.get(sid)
        if e is not None:
            e.future = IN_FLIGHT

    def attach_future(self, sid: int, future) -> None:
        e = self._entries.get(sid)
        if e is not None and future is not None:
            e.future = future

    def ready(self, sid: int, now: float) -> bool:
        """Durable on NVMe (promotable)? Future-gated entries answer from
        the real transfer; modeled entries from the sim clock."""
        e = self._entries.get(sid)
        if e is None:
            return False
        if e.future is not None:
            return e.future.done()
        return now >= e.ready_at

    def time_to_ready(self, sid: int, now: float) -> Optional[float]:
        e = self._entries.get(sid)
        if e is None:
            return None
        if e.future is not None:
            return 0.0 if e.future.done() else None
        return max(0.0, e.ready_at - now)

    def load(self, sid: int, now: float) -> Optional[int]:
        """Promotion consumed the entry: release capacity, count the hit.
        Unknown or still-in-flight sids return None (sentinel) — the entry
        is retained in flight, and never KeyErrors the caller."""
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
        """Abandon an entry (recompute fallback / session finished)."""
        e = self._entries.pop(sid, None)
        if e is not None:
            self._used -= e.blocks
            self.drops += 1

    def peek(self, sid: int) -> Optional[Tuple[int, int]]:
        """(tokens, blocks) of an entry without consuming it; None when
        unknown."""
        e = self._entries.get(sid)
        return None if e is None else (e.tokens, e.blocks)

    def evacuate(self, sid: int) -> Optional[Tuple[int, int]]:
        """Remove an entry for tier migration *without* counting a drop;
        returns (tokens, blocks) or None for unknown sids."""
        e = self._entries.pop(sid, None)
        if e is None:
            return None
        self._used -= e.blocks
        return e.tokens, e.blocks

    def next_event_time(self, now: float) -> Optional[float]:
        """Earliest modeled in-flight completion after ``now`` (sim timer);
        future-gated entries resolve on the wall clock, not the sim clock."""
        ts = [e.ready_at for e in self._entries.values()
              if e.future is None and e.ready_at > now]
        return min(ts) if ts else None

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.stores)


class DiskFileStore:
    """Real-file backend: one spool file per session under a directory.

    This is the live runner's data plane for the cold tier — spill jobs
    write a session's private host KV blocks here (freeing the DRAM copy),
    fill jobs read them back ahead of promotion. Uses ``numpy.savez`` so a
    (k, v) pair round-trips bit-exact; all I/O is expected to run on the
    background swap stream, never the engine thread.
    """

    def __init__(self, root: Optional[str] = None):
        self._own = root is None
        self.root = root or tempfile.mkdtemp(prefix="mars_kv_spool_")
        os.makedirs(self.root, exist_ok=True)
        self.files_written = 0
        self.files_read = 0
        self.bytes_written = 0

    def _path(self, sid: int) -> str:
        return os.path.join(self.root, f"kv_{sid}.npz")

    def write(self, sid: int, k: np.ndarray, v: np.ndarray) -> str:
        path = self._path(sid)
        with open(path, "wb") as f:
            np.savez(f, k=k, v=v)
        self.files_written += 1
        self.bytes_written += k.nbytes + v.nbytes
        return path

    def read(self, sid: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        path = self._path(sid)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            out = (z["k"], z["v"])
        self.files_read += 1
        return out

    def delete(self, sid: int) -> None:
        try:
            os.unlink(self._path(sid))
        except FileNotFoundError:
            pass

    def close(self) -> None:
        if not self._own:
            return
        try:
            for name in os.listdir(self.root):
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass
            os.rmdir(self.root)
        except OSError:
            pass
