"""Priority-Aware Coordinator (paper §4.3): windowed Multi-Level Feedback
Queue whose priority is a compact summary of three factors —

    (1) initial KV footprint  -> base level (smaller context = higher prio)
    (2) accumulated GPU service -> demotion through level quanta
    (3) waiting time           -> bounded promotion (liveness)

The same structure governs eviction: lowest-priority calls are the primary
eviction candidates; among equals, larger KV footprints are preferred
(release more memory immediately).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from repro_torch.core.session import Session


@dataclass
class MLFQConfig:
    n_levels: int = 6
    # base-level thresholds on the pending-work footprint (tokens):
    # decodes/warm continuations -> 0-1, chat-scale cold builds -> 2,
    # repository-scale cold builds -> 3.
    footprint_thresholds: Tuple[int, ...] = (1_024, 24_576, 98_304)
    # geometric service quanta (Autellix-style): demotion level =
    # floor(log2(1 + service_tokens / quantum)), bounded by max_demotion.
    level_quantum_tokens: int = 49_152
    max_demotion: int = 2
    # bounded promotion: one level per `promote_after` seconds of starvation,
    # at most `max_promotion` levels
    promote_after: float = 30.0
    max_promotion: int = 2


class PriorityCoordinator:
    def __init__(self, cfg: MLFQConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------
    def base_level(self, s: Session) -> int:
        """Base level from the *pending* work footprint: a warm continuation
        (KV resident, only the new round's tokens to prefill) is
        latency-sensitive and lands in a high-priority level; a cold
        repository-scale (re)build lands low. Decode-phase sessions have zero
        pending prefill -> top priority (the paper's 'latency-sensitive
        continuations')."""
        fp = s.pending_prefill
        for lvl, thr in enumerate(self.cfg.footprint_thresholds):
            if fp < thr:
                return min(lvl, self.cfg.n_levels - 1)
        return self.cfg.n_levels - 1

    def level(self, s: Session, now: float) -> int:
        """Effective MLFQ level (lower = higher priority): base footprint
        level + bounded geometric service demotion - bounded wait promotion."""
        c = self.cfg
        lvl = self.base_level(s)
        lvl += self._demotion(s.service_tokens)
        waited = max(0.0, now - max(s.last_service, s.admitted_at))
        promo = min(c.max_promotion, int(waited / c.promote_after))
        return max(0, min(c.n_levels - 1, lvl - promo))

    def _demotion(self, service_tokens: float) -> int:
        """Bounded geometric demotion for an accumulated service total."""
        c = self.cfg
        demote = int(math.log2(1.0 + service_tokens / c.level_quantum_tokens))
        return min(c.max_demotion, demote)

    def charge(self, s: Session, tokens: int) -> int:
        """Quantum-by-token accounting: charge the *actual* tokens
        dispatched this iteration against the session's service quanta and
        return the bounded demotion level after the charge. Under
        iteration-level batching this runs once per token per lane, so a
        session demotes at the exact iteration its cumulative service
        crosses a quantum boundary — round-granular charging (one lump of
        ``decode_granularity`` tokens) could overshoot the boundary by up
        to g-1 tokens before the demotion lands."""
        s.service_tokens += tokens
        return self._demotion(s.service_tokens)

    def priority_key(self, s: Session, now: float):
        """Sort key: (level, FIFO-within-level). Short or lightly-served
        continuations first; historically expensive calls don't leapfrog
        interactive work. The within-level order is STABLE (round submission
        time) — starvation relief comes from bounded level promotion, never
        from reshuffling within a level (a time-varying tiebreak would
        round-robin cold builds and fill the pool with partial prefixes)."""
        return (self.level(s, now), s.round_submit, s.sid)

    def order(self, ready: Sequence[Session], now: float) -> List[Session]:
        return sorted(ready, key=lambda s: self.priority_key(s, now))

    # ------------------------------------------------------------------
    def eviction_order(self, candidates: Sequence[Session], now: float
                       ) -> List[Session]:
        """First to evict = lowest priority (highest level); ties broken by
        largest resident KV. Aligned with queue priority by construction —
        no separate, potentially conflicting eviction rules."""
        return sorted(candidates,
                      key=lambda s: (-self.level(s, now), -s.kv_blocks))
