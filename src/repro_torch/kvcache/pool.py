"""Block-identity KV pool: refcounts, copy-on-write, cached (evictable) blocks.

Supersedes the counter-only ``engine.block_manager.BlockManager`` behind the
same ``probe()`` surface (``total`` / ``free`` / ``pinned``), adding:

* **identity** — physical blocks have ids; sessions hold ordered *leases*
  (one logical block reference per lease entry), so two sessions prefix-
  sharing a repository context reference the *same* physical blocks;
* **refcounts** — a physical block is freed only when its last reference
  drops; a block registered in the radix index instead parks on an evictable
  LRU ("cached": content retained, capacity counted as free, reclaimed on
  allocation pressure with a callback into the index);
* **copy-on-write** — writing into a partially-filled tail block that is
  shared (refcount > 1) or index-registered first copies it to a private
  block, so cached prefix content stays pristine for future matchers;
* **device placement** — every block id doubles as a *device page id*
  through a :class:`DeviceBindingMap`; ``block_table(sid)`` exports the
  session's lease as an int32 page table (lease order == token order) that
  the live paged runner feeds straight to the Pallas ``paged_attention``
  kernel. Content *generations* (bumped whenever a page may be rewritten)
  let a swapped-out session ``reacquire`` still-live shared blocks on
  restore instead of copying them back over PCIe, and the ``cow_log``
  records (sid, src, dst) pairs so a physical backend can mirror each
  copy-on-write as a device page copy.

Capacity semantics the engine relies on: ``free`` counts allocatable blocks
*including* cached ones; ``free + physical_in_use == total`` always holds.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.engine.block_manager import BlockPoolProbe


class DeviceBindingMap:
    """Block id -> device page id for a physical page pool.

    The live runner allocates ``n_device_pages`` KV pages plus one scratch
    page; the binding is identity (bid ``i`` lives in page ``i``), which this
    class makes explicit so a future remapping (e.g. per-device sub-pools
    under tensor parallelism) only touches this map. ``scratch_page`` is the
    parking target for padded/idle lanes and is never handed to a session.
    """

    def __init__(self, n_device_pages: int):
        assert n_device_pages > 0
        self.n_device_pages = n_device_pages

    @property
    def scratch_page(self) -> int:
        return self.n_device_pages

    def page_of(self, bid: int) -> int:
        assert 0 <= bid < self.n_device_pages, f"unbound block {bid}"
        return bid

    def table(self, bids: Sequence[int], width: Optional[int] = None
              ) -> np.ndarray:
        """int32 page table for ``bids`` in order, padded with the scratch
        page to ``width`` (>= len(bids)) when given."""
        n = len(bids) if width is None else width
        assert n >= len(bids)
        out = np.full((n,), self.scratch_page, np.int32)
        for i, bid in enumerate(bids):
            out[i] = self.page_of(bid)
        return out


class TieredPoolProbe(BlockPoolProbe):
    """O(1) probe extended with sharing/caching counters."""

    def __init__(self, total: int, free: int, pinned: int, *,
                 cached: int, leased: int, physical: int, cow_count: int):
        super().__init__(total, free, pinned)
        self.cached = cached          # evictable blocks retaining content
        self.leased = leased          # logical refs held by sessions
        self.physical = physical      # blocks with refcount >= 1
        self.cow_count = cow_count


class BlockPool:
    def __init__(self, total_blocks: int, block_size: int = 32):
        assert total_blocks > 0
        self.total = total_blocks
        self.block_size = block_size
        self.pinned = 0
        self.cow_count = 0
        self._free_ids: List[int] = list(range(total_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}                 # bid -> refcount
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, ref==0
        self._in_index: set = set()                    # bids the radix owns
        self._leases: Dict[int, List[int]] = {}        # sid -> ordered bids
        self._leased = 0                   # running sum(len(lease)) — keeps
        self._evict_cb: Optional[Callable[[int], None]] = None  # probe O(1)
        # content generation per block: bumped whenever the page may be
        # rewritten (fresh take, or unindexed while still referenced so its
        # sole owner can write in place). A (bid, gen) pair therefore
        # certifies page content across a swap-out/swap-in gap.
        self._gen: List[int] = [0] * total_blocks
        # (sid, src_bid, dst_bid) per copy_on_write, in order — a physical
        # backend drains this each tick and mirrors the copies on device
        # before any page writes.
        self.cow_log: List[Tuple[int, int, int]] = []

    # --- capacity ------------------------------------------------------
    @property
    def free(self) -> int:
        return len(self._free_ids) + len(self._cached)

    @property
    def physical_in_use(self) -> int:
        return len(self._ref)

    @property
    def leased_total(self) -> int:
        return self._leased

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size) if n_tokens > 0 else 0

    def can_alloc(self, n: int) -> bool:
        return n <= self.free

    def lease_len(self, sid: int) -> int:
        return len(self._leases.get(sid, ()))

    def lease(self, sid: int) -> List[int]:
        return list(self._leases.get(sid, ()))

    def is_cached(self, bid: int) -> bool:
        return bid in self._cached

    def gen(self, bid: int) -> int:
        """Content generation of ``bid`` (see class docstring)."""
        return self._gen[bid]

    def certify(self, pairs: Sequence[Tuple[int, int]]) -> bool:
        """True iff every (bid, gen) certificate still holds — i.e. no
        certified page was CoW-replaced, cache-evicted, re-leased, or
        unindexed since the certificate was recorded (each of those bumps
        the block's generation). The async swap stream checks this before
        committing a prefetched restore: a record that went stale while the
        transfer was in flight must fall back to recompute *before* any
        pages are touched."""
        return all(self._gen[bid] == gen for bid, gen in pairs)

    def survives_release(self, bid: int) -> bool:
        """True if the block's content outlives one reference drop: another
        session still references it, or the radix index parks it cached.
        Such blocks need no host copy on swap-out — they stay on device."""
        return self._ref.get(bid, 0) > 1 or bid in self._in_index

    def block_table(self, sid: int, binding: Optional[DeviceBindingMap] = None,
                    width: Optional[int] = None) -> np.ndarray:
        """The session's lease as an int32 device page table (lease order ==
        token order). With no binding the block ids *are* the page ids and
        no padding is possible — only a binding knows a safe (scratch) pad
        page, so ``width`` requires one."""
        lease = self._leases.get(sid, [])
        if binding is not None:
            return binding.table(lease, width)
        assert width is None, "padded tables need a DeviceBindingMap"
        return np.asarray(lease, np.int32)

    def drain_cow_log(self) -> List[Tuple[int, int, int]]:
        log, self.cow_log = self.cow_log, []
        return log

    # --- index hooks (radix) -------------------------------------------
    def set_evict_callback(self, cb: Callable[[int], None]) -> None:
        """Called with a bid when allocation pressure reclaims a cached
        block — the index must unlink the node mapped to it."""
        self._evict_cb = cb

    def index_blocks(self, bids: Sequence[int]) -> None:
        self._in_index.update(bids)

    def unindex_block(self, bid: int) -> None:
        """Index dropped its mapping: if the block was parked cached, its
        content is no longer reachable — return it to the free list. Either
        way the content is no longer certified (a still-referenced block's
        sole owner may now write it in place without CoW), so bump gen."""
        self._in_index.discard(bid)
        self._gen[bid] += 1
        if bid in self._cached:
            del self._cached[bid]
            self._free_ids.append(bid)

    # --- allocation ----------------------------------------------------
    def _take_physical(self) -> int:
        if self._free_ids:
            bid = self._free_ids.pop()
        else:
            bid, _ = self._cached.popitem(last=False)  # evict LRU cached
            self._in_index.discard(bid)
            if self._evict_cb is not None:
                self._evict_cb(bid)
        self._gen[bid] += 1                # fresh owner will overwrite
        return bid

    def alloc(self, sid: int, n: int) -> bool:
        """Lease ``n`` fresh private blocks (ref = 1) to ``sid``."""
        if n > self.free:
            return False
        lease = self._leases.setdefault(sid, [])
        for _ in range(n):
            bid = self._take_physical()
            self._ref[bid] = 1
            lease.append(bid)
        self._leased += n
        return True

    def acquire(self, sid: int, bids: Sequence[int]) -> None:
        """Add shared references: incref each block (reviving cached ones)
        and append to ``sid``'s lease in order."""
        lease = self._leases.setdefault(sid, [])
        for bid in bids:
            if bid in self._cached:
                del self._cached[bid]
                self._ref[bid] = 1
            else:
                assert bid in self._ref, f"acquire of dead block {bid}"
                self._ref[bid] += 1
            lease.append(bid)
            self._leased += 1

    def reacquire(self, sid: int, bid: int, gen: int) -> bool:
        """Re-reference a block recorded at swap-out time *iff* its content
        is certifiably unchanged (same generation) and still resident
        (referenced by another session or parked cached). Appends to
        ``sid``'s lease like acquire(); returns False when the content is
        gone and the caller must fall back to restore/recompute."""
        if self._gen[bid] != gen:
            return False
        if bid in self._ref:
            self._ref[bid] += 1
        elif bid in self._cached:
            del self._cached[bid]
            self._ref[bid] = 1
        else:
            return False                   # free-listed: content not certified
        self._leases.setdefault(sid, []).append(bid)
        self._leased += 1
        return True

    def _drop_ref(self, bid: int) -> None:
        r = self._ref[bid] - 1
        if r > 0:
            self._ref[bid] = r
            return
        del self._ref[bid]
        if bid in self._in_index:
            self._cached[bid] = None                   # park MRU, evictable
        else:
            self._free_ids.append(bid)

    def release_all(self, sid: int) -> int:
        """Drop every reference ``sid`` holds; returns the lease length."""
        lease = self._leases.pop(sid, [])
        for bid in lease:
            self._drop_ref(bid)
        self._leased -= len(lease)
        return len(lease)

    # --- copy-on-write -------------------------------------------------
    def tail_needs_cow(self, sid: int) -> bool:
        lease = self._leases.get(sid)
        if not lease:
            return False
        bid = lease[-1]
        return self._ref.get(bid, 0) > 1 or bid in self._in_index

    def copy_on_write(self, sid: int) -> bool:
        """Replace ``sid``'s tail block with a private copy (needs one free
        physical block). The shared/indexed original keeps its content for
        the other referents / future prefix matchers."""
        lease = self._leases.get(sid)
        if not lease or not self.tail_needs_cow(sid):
            return True
        if self.free < 1:
            return False
        old = lease[-1]
        new = self._take_physical()
        self._ref[new] = 1
        lease[-1] = new
        self._drop_ref(old)
        self.cow_count += 1
        self.cow_log.append((sid, old, new))
        return True

    # --- pinning (counts, as before) -----------------------------------
    def pin(self, n: int) -> None:
        self.pinned += n

    def unpin(self, n: int) -> None:
        self.pinned -= n
        assert self.pinned >= 0

    # --- probe / invariants --------------------------------------------
    def probe(self) -> TieredPoolProbe:
        return TieredPoolProbe(
            self.total, self.free, self.pinned, cached=len(self._cached),
            leased=self.leased_total, physical=len(self._ref),
            cow_count=self.cow_count)

    def check_consistency(self) -> None:
        """Refcount accounting: every reference is a lease entry, every
        physical block is in exactly one of {free, cached, referenced}."""
        refs: Dict[int, int] = {}
        for lease in self._leases.values():
            for bid in lease:
                refs[bid] = refs.get(bid, 0) + 1
        assert refs == self._ref, \
            f"refcount drift: leases={refs} pool={self._ref}"
        assert self._leased == sum(len(v) for v in self._leases.values()), \
            "leased counter drift"
        free_set = set(self._free_ids)
        cached_set = set(self._cached)
        ref_set = set(self._ref)
        assert len(free_set) == len(self._free_ids), "duplicate free id"
        assert not (free_set & cached_set), "block both free and cached"
        assert not (free_set & ref_set), "block both free and referenced"
        assert not (cached_set & ref_set), "block both cached and referenced"
        assert len(free_set) + len(cached_set) + len(ref_set) == self.total, \
            "physical block lost"
        assert cached_set <= self._in_index, "cached block not index-owned"
