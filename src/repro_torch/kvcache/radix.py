"""Prefix index over hashed token chunks (sglang-style radix tree, chunk
granularity = one KV block).

Sessions carry ``meta["prefix_hashes"]``: an ordered list of ``(key,
n_tokens)`` chunks covering their round-0 context, where ``key`` is any
hashable digest of the chunk's tokens (the workload generator uses stable
tuples; a live tokenizer front-end would use a rolling content hash). Two
sessions whose round-0 streams share a prefix produce identical leading
keys, so the second session's cold prefill *matches* the first's inserted
blocks and attaches to them instead of recomputing.

Lifecycle is owned jointly with the pool: inserted blocks are marked
index-owned; when their last session reference drops they park on the
pool's evictable LRU (content retained, capacity still "free"); allocation
pressure evicts them LRU-first, and the pool calls back here so the mapped
node — and any now-unreachable descendants — unlink.

**Radix-root digest** (cluster-level prefix reuse): the index additionally
maintains O(#anchors) per-*anchor* statistics, where an anchor is a direct
child of the root — i.e. the first chunk key of an indexed prefix stream,
which identifies a session family / repository context. ``digest(top_k)``
exports the top-k anchors (by indexed-block count) as a compact,
JSON-serializable summary that the cluster router carries in heartbeats and
scores placement with; it is O(k), never O(tree), and is refreshed
incrementally on insert/evict via a monotone ``version`` counter (the
actual dict is rebuilt lazily and cached per version). See
``distributed/router.py`` for the wire format.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


def chunk_key_digest(key: Hashable) -> str:
    """Deterministic, process-independent digest of a chunk key (64-bit hex).

    Chunk keys are arbitrary hashable values (the workload generator uses
    tuples of primitives); ``repr`` of those is stable across processes,
    unlike ``hash()`` which is salted per interpreter for strings. Replicas
    and the router must agree on anchor identity without sharing a process,
    so this is the on-the-wire form of a chunk key."""
    return hashlib.blake2b(repr(key).encode(), digest_size=8).hexdigest()


class _AnchorStat:
    """Per-root-child accounting behind the digest (all O(1) to maintain)."""
    __slots__ = ("blocks", "depth", "hits", "queries")

    def __init__(self):
        self.blocks = 0    # indexed blocks in this anchor's subtree
        self.depth = 0     # longest chunk chain inserted under the anchor
        self.hits = 0      # sessions that attached under this anchor
        self.queries = 0   # sessions that consulted the index for this anchor


def estimate_digest_match(digest: Optional[dict],
                          prefix_hashes: Sequence[Tuple[Hashable, int]],
                          anchor_digest: Optional[str] = None) -> int:
    """Estimated longest-indexed-prefix match (in blocks) of a session's
    chunk-key stream against a replica's exported digest.

    The digest is top-k anchors only, so this is an upper-bound estimate:
    if the session's anchor (first chunk key) is present, the match is
    ``min(len(prefix), anchor depth)``; absent anchors estimate 0. The
    local (in-process) path should prefer the exact ``RadixIndex.match``."""
    if not digest or not prefix_hashes:
        return 0
    anchors = digest.get("anchors") or {}
    if anchor_digest is None:
        anchor_digest = chunk_key_digest(prefix_hashes[0][0])
    ent = anchors.get(anchor_digest)
    if not ent:
        return 0
    return min(len(prefix_hashes), int(ent.get("depth", 0)))


class RadixNode:
    __slots__ = ("key", "bid", "n_tokens", "children", "parent", "anchor")

    def __init__(self, key: Hashable, bid: int, n_tokens: int, parent,
                 anchor: Hashable = None):
        self.key = key
        self.bid = bid
        self.n_tokens = n_tokens
        self.children: Dict[Hashable, "RadixNode"] = {}
        self.parent = parent
        self.anchor = anchor          # root-child key this node sits under


class RadixIndex:
    def __init__(self, pool, chunk_tokens: int):
        assert chunk_tokens == pool.block_size, \
            "chunk granularity must equal the block size (one node per block)"
        self.pool = pool
        self.chunk_tokens = chunk_tokens
        self._root = RadixNode(None, -1, 0, None)
        self._by_bid: Dict[int, RadixNode] = {}
        pool.set_evict_callback(self._on_evict)
        # stats (exported into the unified info stream via telemetry)
        self.queries = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        # digest state: per-anchor stats + a monotone version bumped on any
        # insert/evict, so the O(k) export can be cached between changes
        self._anchors: Dict[Hashable, _AnchorStat] = {}
        self.version = 0
        self._digest_cache: Optional[Tuple[Tuple[int, int], dict]] = None

    def __len__(self) -> int:
        return len(self._by_bid)

    # --- match ---------------------------------------------------------
    def match(self, hashes: Sequence[Tuple[Hashable, int]]
              ) -> List[Tuple[int, int]]:
        """Longest indexed prefix of ``hashes``: list of (bid, n_tokens).
        A node only matches if its chunk is fully covered (same key implies
        same token count, but guard against malformed inputs).

        Pure lookup — the engine polls this per tick for every waiting
        round-0 session, so stats are recorded via record_query /
        record_hit only when the caller actually attaches."""
        out: List[Tuple[int, int]] = []
        node = self._root
        for key, n_tok in hashes:
            child = node.children.get(key)
            if child is None or child.n_tokens != n_tok:
                break
            out.append((child.bid, child.n_tokens))
            node = child
        return out

    # --- stats (driven by the engine) ----------------------------------
    def record_query(self, anchor: Hashable = None) -> None:
        """One per session that consults the index (not per poll).
        ``anchor`` (the session's first chunk key) attributes the query to
        its family in the digest. Always bumps ``version``: the digest
        exports the index-wide counters too, so a stats-only change must
        still invalidate the cached export."""
        self.queries += 1
        if anchor is not None:
            stat = self._anchors.get(anchor)
            if stat is not None:
                stat.queries += 1
        self.version += 1

    def record_hit(self, tokens: int, *, first: bool,
                   anchor: Hashable = None) -> None:
        """Tokens actually attached; ``first`` marks the session's first
        attach so hits counts sharing sessions, keeping hit_rate ≤ 1."""
        if first:
            self.hits += 1
            if anchor is not None:
                stat = self._anchors.get(anchor)
                if stat is not None:
                    stat.hits += 1
                    # a sibling may have consulted the index before the
                    # builder's first insert created this anchor (its query
                    # was unattributable then): count the implied query so
                    # the exported per-anchor hit_rate stays <= 1
                    stat.queries = max(stat.queries, stat.hits)
        self.hit_tokens += tokens
        self.version += 1

    # --- insert --------------------------------------------------------
    def insert(self, hashes: Sequence[Tuple[Hashable, int]],
               bids: Sequence[int]) -> int:
        """Register ``bids[i]`` as the physical block holding chunk ``i``.
        Existing nodes keep their original block (first insert wins); newly
        created nodes take ownership of the caller's blocks. Returns the
        number of new nodes."""
        assert len(bids) >= len(hashes), "lease shorter than chunk cover"
        node = self._root
        created = 0
        anchor = hashes[0][0] if hashes else None
        depth = 0
        for (key, n_tok), bid in zip(hashes, bids):
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, bid, n_tok, node, anchor=anchor)
                node.children[key] = child
                self._by_bid[bid] = child
                self.pool.index_blocks([bid])
                created += 1
            node = child
            depth += 1
        self.inserted_blocks += created
        if created and anchor is not None:
            stat = self._anchors.setdefault(anchor, _AnchorStat())
            stat.blocks += created
            stat.depth = max(stat.depth, depth)
            self.version += 1
        return created

    # --- eviction ------------------------------------------------------
    def _on_evict(self, bid: int) -> None:
        """Pool reclaimed a cached block: unlink its node. Descendants are
        unreachable for future matches, so un-index their blocks too (the
        pool moves any cached ones back to the raw free list)."""
        node = self._by_bid.pop(bid, None)
        if node is None:
            return
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        removed = 1
        stack = list(node.children.values())
        node.children.clear()
        while stack:
            n = stack.pop()
            self._by_bid.pop(n.bid, None)
            self.pool.unindex_block(n.bid)
            removed += 1
            stack.extend(n.children.values())
            n.children.clear()
        # digest upkeep: the whole unlinked subtree shares one anchor
        stat = self._anchors.get(node.anchor)
        if stat is not None:
            stat.blocks -= removed
            if stat.blocks <= 0:
                del self._anchors[node.anchor]
            else:
                # depth is maintained as a monotone max on insert; eviction
                # can only shrink the chain, so clamp it to what can remain
                stat.depth = min(stat.depth, stat.blocks)
        self.version += 1

    # --- digest --------------------------------------------------------
    def digest(self, top_k: int = 16) -> dict:
        """Compact radix-root digest for cluster-level placement: the top-k
        anchors by indexed-block count, each as
        ``{anchor_hex: {"blocks", "depth", "hits", "queries"}}`` plus the
        index-wide totals. O(#anchors log k) to build, cached per
        ``version`` so steady-state heartbeats pay a dict lookup. The
        anchor keys are ``chunk_key_digest`` values — process-independent,
        so the dict is wire-ready (JSON-serializable) as exported."""
        if self._digest_cache is not None \
                and self._digest_cache[0] == (self.version, top_k):
            return self._digest_cache[1]
        top = sorted(self._anchors.items(),
                     key=lambda kv: kv[1].blocks, reverse=True)[:top_k]
        d = {
            "v": self.version,
            "indexed_blocks": len(self._by_bid),
            "queries": self.queries,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "anchors": {
                chunk_key_digest(key): {
                    "blocks": st.blocks, "depth": st.depth,
                    "hits": st.hits, "queries": st.queries,
                    "hit_rate": round(st.hits / max(1, st.queries), 4),
                } for key, st in top},
        }
        self._digest_cache = ((self.version, top_k), d)
        return d
