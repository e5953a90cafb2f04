"""Paged-KV block pool (capacity plane) — counter-only legacy manager.

The engine now runs on ``repro.kvcache.pool.BlockPool`` (block identity,
refcounts, copy-on-write, radix-cached blocks) behind the same ``probe()``
surface defined here. ``BlockManager`` remains as the minimal count-based
reference implementation (unit tests pin its arithmetic).

``probe()`` is the O(1) read the unified info stream exports — free-list and
usage counters only, no byte math, no device sync (paper §4.1).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BlockPoolProbe:
    total: int
    free: int
    pinned: int

    @property
    def used(self) -> int:
        return self.total - self.free


class BlockManager:
    def __init__(self, total_blocks: int, block_size: int = 32):
        assert total_blocks > 0
        self.total = total_blocks
        self.block_size = block_size
        self.free = total_blocks
        self.pinned = 0

    # ------------------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size) if n_tokens > 0 else 0

    def can_alloc(self, n: int) -> bool:
        return n <= self.free

    def alloc(self, n: int) -> bool:
        if n > self.free:
            return False
        self.free -= n
        return True

    def release(self, n: int) -> None:
        self.free += n
        assert self.free <= self.total, "double free"

    def pin(self, n: int) -> None:
        """Mark n held blocks as pinned (retained across a tool phase)."""
        self.pinned += n

    def unpin(self, n: int) -> None:
        self.pinned -= n
        assert self.pinned >= 0

    def probe(self) -> BlockPoolProbe:
        return BlockPoolProbe(self.total, self.free, self.pinned)
