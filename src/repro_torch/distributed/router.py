"""Cluster-level control plane (paper §7 "Scalability to Multi-GPU Systems").

The external control plane generalizes to a fleet gateway: engine replicas
register, export their dual-pressure telemetry (KV pool, tool backlog, AIMD
window, EMA step latency), and the router

  * places sessions on the replica with the best (pressure, affinity) score —
    KV locality first: a session returns to the replica that served it last
    (warm state), unless that replica is overloaded or degraded;
  * accumulates session *families* (shared repository contexts) on the
    replica whose radix index already holds their prefix, instead of every
    replica paying the same cold prefill (cross-replica prefix reuse);
  * detects failures by heartbeat timeout and re-queues the victim's sessions
    (they resume by prefix recompute — see checkpoint.snapshot_engine);
  * mitigates stragglers: replicas whose EMA step latency exceeds
    ``straggler_factor`` x fleet median get drained (no new placements);
  * supports elastic join/leave at any time.

**Radix-digest wire format.** Family placement is driven by a compact
radix-root digest each replica exports in its heartbeat
(``RadixIndex.digest(top_k)``, O(k) not O(tree)) — a JSON-serializable dict:

    {"v": <monotone version, bumped on insert/evict>,
     "indexed_blocks": <total blocks in the index>,
     "queries"/"hits"/"hit_tokens": <index-wide prefix stats>,
     "anchors": {<anchor hex>: {"blocks":  # indexed blocks in the subtree
                                "depth":   # longest indexed chunk chain
                                "hits"/"queries"/"hit_rate"}, ...}}

An *anchor* is a direct child of the radix root — the first chunk key of an
indexed prefix stream, identifying one session family / repository context.
Anchor hex keys are ``chunk_key_digest`` values (blake2b of the chunk key's
repr, process-independent), so the incoming session's own chunk-key prefix
(``meta["prefix_hashes"]`` from workloads.generator) can be matched against
any replica's digest without sharing a process. ``_score`` turns the match
into a longest-indexed-prefix bonus with a load-spill guard (a hot family
still overflows to other replicas instead of melting its home); digests are
heartbeat-carried soft state — cleared on failure, gone with the replica on
``leave``, and absent on a re-registered replica until its first beat.

This layer is transport-agnostic: replicas here are in-process Engine objects
(tests/examples drive thousands of simulated nodes); a deployment would put
the same logic behind an RPC server.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.session import KVState, Phase, Session
from repro_torch.kvcache.radix import chunk_key_digest, estimate_digest_match


def _reset_kv_accounting(s: Session, engine=None, now: float = 0.0) -> None:
    """A session leaving a replica loses its device-resident state; it will
    resume elsewhere by prefix recompute. Without this reset the next
    placement inherits phantom block accounting from the old replica.

    When the old replica's engine is handed in, the session is detached
    engine-side too (device lease, pin counters, host-tier entry, live
    backend host copy, membership lists) — a reused or heartbeat-recovered
    engine would otherwise trip its invariants and leak capacity."""
    detach = getattr(engine, "detach_session", None)
    if detach is not None:
        detach(s, now)
    if s.phase == Phase.TOOL:
        # evacuated mid-tool: the in-flight tool was cancelled with the old
        # replica, so the new home re-decodes this round and re-runs the
        # tool at the usual boundary. Without the reset, a session whose
        # decode quantum had completed carries decoded == decode_tokens
        # into DECODING on the new replica — a 0-token quantum that no
        # batch ever picks up and no timer ever finishes (livelock).
        s.decoded = 0
        s.first_token_seen = False
        # the re-decoded round re-records its TTFT on the new home; keep
        # the per-round list aligned (one entry per round) by dropping the
        # stale entry measured on the dead replica
        del s.ttfts[s.cur_round:]
        for k in ("tool_kind_running", "tool_duration"):
            s.meta.pop(k, None)
    s.kv_blocks = 0
    s.resident_len = 0
    s.kv_state = KVState.NONE
    s.meta.pop("swapped_len", None)
    s.meta.pop("host_tier", None)
    s.meta.pop("kv_tier", None)
    # radix bookkeeping is per-replica: the new home's index knows nothing
    # of the chunks this session indexed (or attached to) on the old one
    # (prefix_anchor survives — it is workload identity, not replica state)
    for k in ("prefix_chunks_indexed", "radix_inserted", "radix_hit",
              "radix_queried", "radix_stale_at", "radix_admission_est"):
        s.meta.pop(k, None)


@dataclass
class ReplicaState:
    rid: str
    engine: object = None
    last_heartbeat: float = 0.0
    kv_utilization: float = 0.0
    tool_backlog: int = 0
    active_sessions: int = 0
    step_latency_ema: float = 0.0
    alive: bool = True
    draining: bool = False
    placed: Dict[int, float] = field(default_factory=dict)   # sid -> t
    radix_digest: Optional[dict] = None     # heartbeat-carried soft state


@dataclass
class RouterConfig:
    heartbeat_timeout: float = 10.0
    straggler_factor: float = 2.5
    ema_alpha: float = 0.2
    overload_kv: float = 0.95
    affinity_bonus: float = 0.35
    # cross-replica prefix reuse: score bonus scale for a full-prefix digest
    # match (scaled by matched fraction), and the load-spill guard — above
    # this KV utilization a replica stops *attracting* its family (members
    # overflow by plain pressure score) though per-session affinity stands
    prefix_bonus: float = 0.5
    prefix_spill_kv: float = 0.85
    # bound on the straggler score penalty: an unbounded ema/median ratio
    # lets one slow-tick heartbeat (a big prefill batch, a GC pause) drown
    # every affinity term; sustained stragglers are drained by
    # update_stragglers anyway, so the *score* penalty only needs to break
    # ties away from slow replicas, not to dominate
    straggler_penalty_cap: float = 2.0


class ClusterRouter:
    def __init__(self, cfg: RouterConfig = None):
        self.cfg = cfg or RouterConfig()
        self.replicas: Dict[str, ReplicaState] = {}
        self.session_home: Dict[int, str] = {}     # sid -> last replica
        self.requeued: List[Session] = []
        self.events: List[dict] = []

    # --- membership -----------------------------------------------------
    def register(self, rid: str, engine=None, now: float = None) -> None:
        now = time.monotonic() if now is None else now
        self.replicas[rid] = ReplicaState(rid, engine, last_heartbeat=now)
        self.events.append({"t": now, "ev": "join", "rid": rid})

    def leave(self, rid: str, now: float = None) -> List[Session]:
        """Graceful drain: returns sessions to re-place elsewhere."""
        now = time.monotonic() if now is None else now
        r = self.replicas.pop(rid, None)
        out: List[Session] = []
        if r is not None and r.engine is not None:
            out = list(r.engine.waiting) + list(r.engine.active)
            for s in out:
                _reset_kv_accounting(s, r.engine, now)
        self.events.append({"t": now, "ev": "leave", "rid": rid})
        return out

    # --- telemetry -----------------------------------------------------------
    def heartbeat(self, rid: str, *, kv_utilization: float, tool_backlog: int,
                  active_sessions: int, step_latency: float,
                  radix_digest: Optional[dict] = None,
                  now: float = None) -> None:
        """``radix_digest`` is the replica's radix-root export (see module
        docstring); it is refreshed wholesale each beat — a digest-blind
        replica (no radix index, or an older heartbeat sender) simply never
        attracts family placements."""
        r = self.replicas.get(rid)
        if r is None:
            return
        now = time.monotonic() if now is None else now
        r.last_heartbeat = now
        r.kv_utilization = kv_utilization
        r.tool_backlog = tool_backlog
        r.active_sessions = active_sessions
        r.radix_digest = radix_digest
        a = self.cfg.ema_alpha
        r.step_latency_ema = step_latency if r.step_latency_ema == 0 else \
            (1 - a) * r.step_latency_ema + a * step_latency
        if not r.alive:
            r.alive = True
            self.events.append({"t": now, "ev": "recovered", "rid": rid})

    def check_failures(self, now: float = None) -> List[str]:
        """Heartbeat-timeout detection; re-queues victims' sessions."""
        now = time.monotonic() if now is None else now
        failed = []
        for r in self.replicas.values():
            if r.alive and now - r.last_heartbeat > self.cfg.heartbeat_timeout:
                r.alive = False
                # the advertised prefix state died with the replica's pool;
                # a recovered replica re-advertises on its next heartbeat
                r.radix_digest = None
                failed.append(r.rid)
                self.events.append({"t": now, "ev": "failed", "rid": r.rid})
                if r.engine is not None:
                    victims = list(r.engine.waiting) + list(r.engine.active)
                    for s in victims:
                        _reset_kv_accounting(s, r.engine, now)
                        self.requeued.append(s)
        return failed

    # --- straggler mitigation ---------------------------------------------------
    def _median_latency(self) -> float:
        xs = [r.step_latency_ema for r in self.replicas.values()
              if r.alive and r.step_latency_ema > 0]
        return float(np.median(xs)) if xs else 0.0

    def update_stragglers(self, now: float = None) -> List[str]:
        med = self._median_latency()
        out = []
        for r in self.replicas.values():
            was = r.draining
            r.draining = bool(
                med > 0 and r.step_latency_ema > self.cfg.straggler_factor * med)
            if r.draining and not was:
                out.append(r.rid)
                self.events.append({"t": now or time.monotonic(),
                                    "ev": "straggler_drain", "rid": r.rid})
        return out

    # --- placement -----------------------------------------------------------
    def _prefix_match_frac(self, r: ReplicaState, s: Session) -> float:
        """Fraction of the session's chunk-key prefix already indexed on
        ``r``, estimated from its heartbeat digest (0.0 when either side is
        digest-blind — an empty digest scores exactly neutrally)."""
        hashes = s.meta.get("prefix_hashes")
        if not hashes or not r.radix_digest:
            return 0.0
        anchor = s.meta.get("prefix_anchor")
        if anchor is None:
            anchor = chunk_key_digest(hashes[0][0])
            s.meta["prefix_anchor"] = anchor     # hash once per session
        matched = estimate_digest_match(r.radix_digest, hashes, anchor)
        return matched / len(hashes)

    def _score(self, r: ReplicaState, s: Session) -> float:
        """Lower is better: dual-pressure load + straggler penalty -
        KV-locality affinity - family (longest-indexed-prefix) affinity."""
        load = r.kv_utilization + 0.05 * r.tool_backlog \
            + 0.02 * r.active_sessions
        med = self._median_latency()
        if med > 0 and r.step_latency_ema > 0:
            load += min(self.cfg.straggler_penalty_cap,
                        max(0.0, r.step_latency_ema / med - 1.0))
        if self.session_home.get(s.sid) == r.rid:
            load -= self.cfg.affinity_bonus      # warm KV / state locality
        if r.kv_utilization < self.cfg.prefix_spill_kv:
            # family locality: pull the session toward the replica whose
            # radix index holds the longest slice of its prefix, so one
            # replica accumulates each repository context. The spill guard
            # lets a hot family overflow instead of stacking onto an
            # already-pressured home.
            load -= self.cfg.prefix_bonus * self._prefix_match_frac(r, s)
        return load

    def place(self, s: Session, now: float = None) -> Optional[str]:
        now = time.monotonic() if now is None else now
        cands = [r for r in self.replicas.values()
                 if r.alive and not r.draining
                 and r.kv_utilization < self.cfg.overload_kv]
        if not cands:
            cands = [r for r in self.replicas.values() if r.alive]
        if not cands:
            return None
        best = min(cands, key=lambda r: self._score(r, s))
        best.placed[s.sid] = now
        self.session_home[s.sid] = best.rid
        if best.engine is not None:
            best.engine.submit(s)
        return best.rid

    def dispatch_requeued(self, now: float = None) -> int:
        n = 0
        while self.requeued:
            s = self.requeued.pop(0)
            if self.place(s, now) is None:
                self.requeued.insert(0, s)
                break
            n += 1
        return n

    # --- cluster telemetry ----------------------------------------------------
    def cluster_prefix_stats(self) -> dict:
        """Fleet-wide prefix-reuse view from the heartbeat digests (alive
        replicas only): per-replica digest stats plus the cluster hit rate —
        the fraction of index-consulting sessions, anywhere, that attached
        to an already-built prefix. This is the number family-aware
        placement moves: co-locating a family turns its N-1 cold prefills
        into hits on one replica instead of N-1 misses on N-1 replicas."""
        per_replica = {}
        queries = hits = hit_tokens = blocks = 0
        for r in self.replicas.values():
            if not r.alive or not r.radix_digest:
                continue
            d = r.radix_digest
            per_replica[r.rid] = {
                "anchors": len(d.get("anchors") or {}),
                "indexed_blocks": d.get("indexed_blocks", 0),
                "queries": d.get("queries", 0),
                "hits": d.get("hits", 0),
                "hit_tokens": d.get("hit_tokens", 0),
            }
            queries += d.get("queries", 0)
            hits += d.get("hits", 0)
            hit_tokens += d.get("hit_tokens", 0)
            blocks += d.get("indexed_blocks", 0)
        return {"replicas": per_replica,
                "cluster_prefix_queries": queries,
                "cluster_prefix_hits": hits,
                "cluster_prefix_hit_tokens": hit_tokens,
                "cluster_indexed_blocks": blocks,
                "cluster_prefix_hit_rate": hits / max(1, queries)}

    def stats(self) -> dict:
        """Control-plane counter snapshot for the metrics registry: fleet
        membership, placement totals, the requeue backlog, and the event
        tally (join/leave/failed/recovered/straggler_drain)."""
        by_kind: Dict[str, int] = {}
        for e in self.events:
            by_kind[e["ev"]] = by_kind.get(e["ev"], 0) + 1
        return {
            "replicas": len(self.replicas),
            "alive": sum(1 for r in self.replicas.values() if r.alive),
            "draining": sum(1 for r in self.replicas.values() if r.draining),
            "placements": sum(len(r.placed) for r in self.replicas.values()),
            "sessions_homed": len(self.session_home),
            "requeue_depth": len(self.requeued),
            "events": by_kind,
        }
