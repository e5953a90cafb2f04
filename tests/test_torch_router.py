"""The port's copy of the cluster router (``repro_torch.distributed.
router``): the router half of tests/test_distributed.py, pointed at the
port's router and engine over ``SimBackend`` (failover requeues,
stragglers, KV accounting reset on leave and failure, mid-tool victims,
elastic join and leave, radix digests in heartbeats). Then one live test:
two ``TorchBackend(device="cpu")`` replicas of ``llama3.2-1b``
``.reduced()`` in float32 behind the router, one of which leaves mid-run
with a session in a tool; every session finishes, with the greedy tokens
of the same sessions on one backend.
"""
import pytest
import torch

from repro_torch.distributed.router import ClusterRouter, RouterConfig


# ---------------------------------------------------------------------------
# cluster router
# ---------------------------------------------------------------------------

def _mini_engine():
    from repro_torch.configs.qwen3_coder_30b import CONFIG as QWEN3
    from repro_torch.engine.backend import SimBackend
    from repro_torch.engine.engine import Engine, EngineConfig
    from repro_torch.models.perf_model import H100
    return Engine(EngineConfig(total_kv_blocks=9000), "mars",
                  SimBackend(QWEN3, H100))


def test_router_failover_requeues_sessions():
    from repro_torch.core.session import Round, make_session
    r = ClusterRouter(RouterConfig(heartbeat_timeout=5.0))
    e1, e2 = _mini_engine(), _mini_engine()
    r.register("a", e1, now=0.0)
    r.register("b", e2, now=0.0)
    ss = [make_session(0.0, [Round(1000, 8, None, 0.0)], ideal_time=1.0)
          for _ in range(6)]
    for s in ss:
        r.heartbeat("a", kv_utilization=0.1, tool_backlog=0,
                     active_sessions=len(e1.waiting), step_latency=0.1, now=0.0)
        r.heartbeat("b", kv_utilization=0.1, tool_backlog=0,
                     active_sessions=len(e2.waiting), step_latency=0.1, now=0.0)
        r.place(s, now=0.0)
    placed_a = len(e1.waiting)
    assert placed_a + len(e2.waiting) == 6
    # replica a dies: heartbeat only from b
    r.heartbeat("b", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=10.0)
    failed = r.check_failures(now=10.0)
    assert failed == ["a"]
    assert len(r.requeued) == placed_a
    n = r.dispatch_requeued(now=10.0)
    assert n == placed_a
    assert len(e2.waiting) + len(e2.active) + len(e2.rejected) == 6


def test_router_straggler_drain_and_affinity():
    from repro_torch.core.session import Round, make_session
    r = ClusterRouter(RouterConfig(straggler_factor=2.0))
    e1, e2, e3 = _mini_engine(), _mini_engine(), _mini_engine()
    for rid, e in (("a", e1), ("b", e2), ("c", e3)):
        r.register(rid, e, now=0.0)
        r.heartbeat(rid, kv_utilization=0.2, tool_backlog=0, active_sessions=0,
                    step_latency=0.1, now=0.0)
    # c becomes 5x slower than the median
    for _ in range(20):
        r.heartbeat("c", kv_utilization=0.2, tool_backlog=0, active_sessions=0,
                    step_latency=0.5, now=1.0)
    drained = r.update_stragglers(now=1.0)
    assert drained == ["c"]
    s = make_session(0.0, [Round(1000, 8, None, 0.0)], ideal_time=1.0)
    rid = r.place(s, now=1.0)
    assert rid in ("a", "b")
    # affinity: same session returns to its home replica
    rid2 = r.place(s, now=2.0)
    assert rid2 == rid


@pytest.mark.parametrize("path", ["drain", "failure"])
def test_router_resets_kv_accounting_on_leave_and_failure(path):
    """Sessions handed back by a dying/draining replica must not carry
    phantom block accounting into their next placement — the new engine's
    refcount invariants would trip on the stale kv_blocks."""
    from repro_torch.core.session import KVState, Round, make_session
    r = ClusterRouter(RouterConfig(heartbeat_timeout=5.0))
    e1 = _mini_engine()
    r.register("a", e1, now=0.0)
    r.heartbeat("a", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=0.0)
    s = make_session(0.0, [Round(200_000, 16, None, 0.0)], ideal_time=1.0)
    assert r.place(s, now=0.0) == "a"
    # run a few ticks so the session holds blocks mid-prefill
    now = 0.0
    for _ in range(3):
        el, _ = e1.tick(now)
        now += max(el, 0.05)
    assert s.kv_blocks > 0 and s.resident_len > 0
    if path == "drain":
        moved = r.leave("a", now=1.0)
        assert s in moved
    else:
        failed = r.check_failures(now=100.0)
        assert failed == ["a"]
        assert s in r.requeued
        moved = r.requeued
    for m in moved:
        assert m.kv_blocks == 0 and m.resident_len == 0
        assert m.kv_state == KVState.NONE
    # the old engine is detached too: no stale membership or leases, so a
    # heartbeat-recovered replica can keep ticking without tripping
    assert s not in e1.active and s not in e1.waiting
    assert e1.blocks.free == e1.blocks.total
    e1.check_invariants()
    e1.tick(2.0)
    # re-placement on a fresh replica keeps the new invariants intact
    e2 = _mini_engine()
    r.register("b", e2, now=101.0)
    r.heartbeat("b", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=101.0)
    assert r.place(s, now=101.0) == "b"
    e2.tick(0.0)
    e2.check_invariants()


def test_router_leave_drops_host_tier_entries():
    """Draining a replica must clear engine-side host-tier occupancy for the
    sessions handed back — a reused engine would otherwise carry orphaned
    host entries and trip its host-occupancy invariant."""
    from repro_torch.core.session import KVState, Round, make_session
    r = ClusterRouter()
    e1 = _mini_engine()
    r.register("a", e1, now=0.0)
    r.heartbeat("a", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=0.0)
    s = make_session(0.0, [Round(20_000, 16, None, 0.0)], ideal_time=1.0)
    assert r.place(s, now=0.0) == "a"
    now = 0.0
    for _ in range(3):
        el, _ = e1.tick(now)
        now += max(el, 0.05)
    assert s.kv_blocks > 0
    # demote to the host tier, as pin revocation under pressure would
    assert e1._offload_kv(s, now)
    assert e1.host.holds(s.sid) and s.meta.get("host_tier")
    moved = r.leave("a", now=now + 1.0)
    assert s in moved
    assert s.kv_state == KVState.NONE and "host_tier" not in s.meta
    assert not e1.host.holds(s.sid)
    assert e1.host.used_blocks == 0
    e1.check_invariants()


def test_router_failover_cancels_inflight_tools():
    """A session detached mid-tool must not be resumed by the old
    (heartbeat-recovered) replica: its queued/running tool is cancelled,
    so the replica ticking past the tool's end leaves the session — now
    owned by another replica — untouched."""
    from repro_torch.core.session import Phase, Round, make_session
    r = ClusterRouter(RouterConfig(heartbeat_timeout=5.0))
    e1 = _mini_engine()
    r.register("a", e1, now=0.0)
    r.heartbeat("a", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=0.0)
    s = make_session(0.0, [Round(2_000, 8, "t", 50.0),
                           Round(1_000, 8, None, 0.0)], ideal_time=1.0)
    assert r.place(s, now=0.0) == "a"
    now = 0.0
    while s.phase != Phase.TOOL and now < 100.0:
        el, _ = e1.tick(now)
        now += max(el, 0.05)
    assert s.phase == Phase.TOOL
    round_before = s.cur_round
    assert r.check_failures(now=100.0) == ["a"]
    assert s in r.requeued
    # recovered replica ticks past the tool's completion time
    for t in (101.0, 160.0, 200.0):
        e1.tick(t)
    assert s.cur_round == round_before and s.phase == Phase.TOOL
    assert e1.tools.active == 0
    e1.check_invariants()


def test_router_midtool_victim_completes_on_new_replica():
    """A session evacuated mid-tool has already finished its round's decode
    quantum; re-placement must reset the round progress so the new replica
    re-decodes and re-runs the cancelled tool — without the reset the
    session lands in DECODING with decoded == decode_tokens, a 0-token
    quantum no batch picks up and no timer finishes (livelock)."""
    from repro_torch.core.session import Phase, Round, make_session
    r = ClusterRouter(RouterConfig(heartbeat_timeout=5.0))
    e1 = _mini_engine()
    r.register("a", e1, now=0.0)
    r.heartbeat("a", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=0.0)
    s = make_session(0.0, [Round(2_000, 16, "t", 50.0),
                           Round(1_000, 8, None, 0.0)], ideal_time=1.0)
    assert r.place(s, now=0.0) == "a"
    now = 0.0
    while s.phase != Phase.TOOL and now < 100.0:
        el, _ = e1.tick(now)
        now += max(el, 0.05)
    assert s.phase == Phase.TOOL
    assert s.decoded == s.rounds[0].decode_tokens   # quantum complete
    assert r.check_failures(now=100.0) == ["a"]
    assert s in r.requeued
    assert s.decoded == 0 and not s.first_token_seen
    e2 = _mini_engine()
    r.register("b", e2, now=100.0)
    r.heartbeat("b", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=100.0)
    assert r.dispatch_requeued(now=100.0) == 1
    assert r.session_home[s.sid] == "b"
    from repro_torch.engine.engine import run_sim
    finished, _ = run_sim(e2, [], max_time=1e4)
    assert s in finished                            # re-decode + re-run tool
    # per-round TTFT stays one entry per round: the stale entry measured on
    # the dead replica was dropped with the round-progress reset
    assert len(s.ttfts) == len(s.rounds)
    e2.check_invariants()


def test_router_elastic_join_leave():
    r = ClusterRouter()
    e1 = _mini_engine()
    r.register("a", e1, now=0.0)
    r.heartbeat("a", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=0.0)
    from repro_torch.core.session import Round, make_session
    s = make_session(0.0, [Round(1000, 8, None, 0.0)], ideal_time=1.0)
    assert r.place(s, now=0.0) == "a"
    moved = r.leave("a", now=1.0)
    assert s in moved
    assert r.place(s, now=1.0) is None       # no replicas left
    e2 = _mini_engine()
    r.register("b", e2, now=2.0)
    r.heartbeat("b", kv_utilization=0.1, tool_backlog=0, active_sessions=0,
                step_latency=0.1, now=2.0)
    assert r.place(s, now=2.0) == "b"


# ---------------------------------------------------------------------------
# cross-replica prefix reuse (radix digests in heartbeats)
# ---------------------------------------------------------------------------

def _family_session(n_shared=8, n_tail=0, fam="fam", tag=None):
    from repro_torch.core.session import Round, make_session
    s = make_session(0.0, [Round(32 * (n_shared + n_tail), 8, None, 0.0)],
                     ideal_time=1.0)
    s.meta["prefix_hashes"] = [((fam, i), 32) for i in range(n_shared)] + \
        [((tag, i), 32) for i in range(n_tail)]
    return s


def _digest_for(fam="fam", blocks=8, depth=8, hits=0, queries=0):
    from repro_torch.kvcache.radix import chunk_key_digest
    return {"v": 1, "indexed_blocks": blocks, "queries": queries,
            "hits": hits, "hit_tokens": 0,
            "anchors": {chunk_key_digest((fam, 0)): {
                "blocks": blocks, "depth": depth,
                "hits": hits, "queries": queries,
                "hit_rate": hits / max(1, queries)}}}


def _beat(r, rid, *, util=0.1, digest=None, now=0.0):
    r.heartbeat(rid, kv_utilization=util, tool_backlog=0, active_sessions=0,
                step_latency=0.1, radix_digest=digest, now=now)


def test_router_prefix_match_pulls_family_spill_guard_overrides():
    """A replica advertising the session's anchor wins placement despite a
    mild load disadvantage; past the spill threshold the pull is off and
    the family overflows by plain pressure score."""
    r = ClusterRouter(RouterConfig())
    for rid in ("a", "b"):
        r.register(rid, None, now=0.0)
    _beat(r, "a", util=0.05)
    _beat(r, "b", util=0.25, digest=_digest_for())   # warmer but has the prefix
    s = _family_session()
    assert r.place(s, now=0.0) == "b"
    # hot home: same digest, utilization past prefix_spill_kv -> overflow
    s2 = _family_session()
    _beat(r, "b", util=r.cfg.prefix_spill_kv + 0.02, digest=_digest_for())
    assert r.place(s2, now=1.0) == "a"


def test_router_empty_digest_scores_neutrally():
    """No digest, an empty-anchor digest, and a non-matching digest must
    all produce the identical score — digest-blind replicas are never
    penalized (or favored) for what they don't advertise."""
    r = ClusterRouter(RouterConfig())
    r.register("a", None, now=0.0)
    _beat(r, "a", util=0.2)
    s = _family_session()
    ra = r.replicas["a"]
    base = r._score(ra, s)
    _beat(r, "a", util=0.2, digest={"v": 0, "anchors": {}})
    assert r._score(ra, s) == base
    _beat(r, "a", util=0.2, digest=_digest_for(fam="other"))
    assert r._score(ra, s) == base
    # and a session with no prefix metadata is unaffected by a rich digest
    from repro_torch.core.session import Round, make_session
    plain = make_session(0.0, [Round(256, 8, None, 0.0)], ideal_time=1.0)
    _beat(r, "a", util=0.2)
    base_plain = r._score(ra, plain)
    _beat(r, "a", util=0.2, digest=_digest_for())
    assert r._score(ra, plain) == base_plain


def test_router_failure_clears_stale_digest():
    """A failed replica's advertised prefix state died with its pool: the
    digest is invalidated with the failure, so requeued sessions are
    re-placed by load, not by a ghost index."""
    r = ClusterRouter(RouterConfig(heartbeat_timeout=5.0))
    e1, e2 = _mini_engine(), _mini_engine()
    r.register("a", e1, now=0.0)
    r.register("b", e2, now=0.0)
    _beat(r, "a", util=0.1, digest=_digest_for())
    _beat(r, "b", util=0.1)
    s = _family_session()
    assert r.place(s, now=0.0) == "a"
    _beat(r, "b", util=0.1, now=10.0)            # only b stays alive
    assert r.check_failures(now=10.0) == ["a"]
    assert r.replicas["a"].radix_digest is None
    assert s in r.requeued
    assert r.dispatch_requeued(now=10.0) == 1
    assert r.session_home[s.sid] == "b"


def test_router_reregistered_replica_starts_digest_clean():
    r = ClusterRouter(RouterConfig())
    r.register("a", None, now=0.0)
    _beat(r, "a", util=0.1, digest=_digest_for())
    assert r.replicas["a"].radix_digest is not None
    r.leave("a", now=1.0)
    assert "a" not in r.replicas                 # digest gone with the replica
    r.register("a", None, now=2.0)
    assert r.replicas["a"].radix_digest is None
    # an omitted-digest heartbeat keeps it clean (refresh-wholesale)
    _beat(r, "a", util=0.1, now=2.5)
    assert r.replicas["a"].radix_digest is None
    s = _family_session()
    ra = r.replicas["a"]
    assert r._prefix_match_frac(ra, s) == 0.0


def test_router_cluster_prefix_stats_aggregates_alive_digests():
    r = ClusterRouter(RouterConfig(heartbeat_timeout=5.0))
    for rid in ("a", "b", "c"):
        r.register(rid, None, now=0.0)
    _beat(r, "a", digest=_digest_for(fam="f1", hits=3, queries=4))
    _beat(r, "b", digest=_digest_for(fam="f2", hits=1, queries=2))
    _beat(r, "c")                                # digest-blind
    stats = r.cluster_prefix_stats()
    assert set(stats["replicas"]) == {"a", "b"}
    assert stats["cluster_prefix_hits"] == 4
    assert stats["cluster_prefix_queries"] == 6
    assert stats["cluster_prefix_hit_rate"] == pytest.approx(4 / 6)
    # a dead replica's digest leaves the aggregate with the failure
    _beat(r, "b", digest=_digest_for(fam="f2", hits=1, queries=2), now=10.0)
    assert set(r.check_failures(now=10.0)) == {"a", "c"}
    stats = r.cluster_prefix_stats()
    assert set(stats["replicas"]) == {"b"}       # a/c failed
    assert stats["cluster_prefix_hit_rate"] == pytest.approx(1 / 2)


def test_router_digest_placement_co_locates_family_end_to_end():
    """Two live engines behind the router: once the builder's replica
    advertises the family anchor, siblings land there and attach to the
    shared blocks instead of recomputing them."""
    r = ClusterRouter(RouterConfig())
    engines = {"a": _mini_engine(), "b": _mini_engine()}
    for rid, e in engines.items():
        r.register(rid, e, now=0.0)
        _beat(r, rid, util=0.0)
    builder = _family_session(n_shared=16, n_tail=2, tag="t0")
    home = r.place(builder, now=0.0)
    now = 0.0
    for _ in range(8):                           # build + index the prefix
        for rid, e in engines.items():
            el, _ = e.tick(now)
            _beat(r, rid, util=e.telem.kv_utilization,
                  digest=e.radix_digest(), now=now)
            now += max(el, 0.05)
    assert engines[home].radix.inserted_blocks >= 16
    sibs = [_family_session(n_shared=16, n_tail=2, tag=f"t{i+1}")
            for i in range(3)]
    for s in sibs:
        assert r.place(s, now=now) == home
    for _ in range(30):
        el, _ = engines[home].tick(now)
        now += max(el, 0.05)
        if all(s.meta.get("radix_hit") for s in sibs):
            break
    assert all(s.meta.get("radix_hit") for s in sibs)
    assert engines[home].prefix_hit_tokens >= 3 * 16 * 32
    for e in engines.values():
        e.check_invariants()


# ---------------------------------------------------------------------------
# live: two TorchBackend replicas on the CPU, one leaves mid-run
# ---------------------------------------------------------------------------

LIVE_DECODE = 6


def _live_sessions():
    """Six sessions in two shared-prefix families (three 32-token chunks
    each), two rounds with a 0.3 s sleep tool between; fixed sids, so a
    second build gives the same context ids."""
    from repro_torch.core.session import Round, make_session
    out = []
    for i in range(6):
        s = make_session(0.05 * i,
                         [Round(96 + 32 + 16, LIVE_DECODE, "sleep", 0.3),
                          Round(24, LIVE_DECODE, None, 0.0)],
                         ideal_time=1.0, sid=98101 + i)
        s.meta["prefix_hashes"] = \
            [(("live-fam", i % 2, c), 32) for c in range(3)] + \
            [(("live-u", s.sid), 32), (("live-u", s.sid, "part"), 16)]
        out.append(s)
    return out


def _live_engine(params):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.events import EventBus
    from repro_torch.engine.engine import Engine, EngineConfig
    from repro_torch.engine.tools import RealToolExecutor
    from repro_torch.engine.torch_runner import TorchBackend
    backend = TorchBackend(get_config("llama3.2-1b").reduced(), params=params,
                           device="cpu", dtype=torch.float32,
                           total_pages=48, page_size=32)
    bus = EventBus()
    tools = RealToolExecutor(cpu_slots=4, bus=bus)
    eng = Engine(EngineConfig(total_kv_blocks=48, block_size=32,
                              token_budget=256, max_decode_batch=4,
                              cpu_slots=4, scheduler="mixed"),
                 "mars", backend, bus=bus, tool_exec=tools)
    return eng, tools


@pytest.mark.live
def test_live_replica_leaves_mid_run():
    """Replica b leaves as soon as one of its sessions is in a tool: its
    sessions are detached (pages, host copies, the cancelled tool) and
    re-placed on a, where they resume by prefix recompute. Every session
    finishes with 2 x LIVE_DECODE tokens, the greedy tokens of the same
    sessions served by one backend. A session moved mid-decode (0 <
    decoded < LIVE_DECODE) is held to those tokens up to the move: the
    engine recomputes its prompt only, not the tokens it had decoded
    (ROADMAP.md §3)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm
    params = init_lm(get_config("llama3.2-1b").reduced(),
                     torch.Generator().manual_seed(0), torch.float32, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # tiny products; spare the shared cores
    try:
        _live_leave(params)
    finally:
        torch.set_num_threads(threads)


def _live_leave(params):
    from repro_torch.core.session import Phase
    from repro_torch.engine.engine import run_live
    from repro_torch.launch.serve import run_cluster_live
    one, tools = _live_engine(params)
    try:
        want = {s.sid: list(s.meta["generated"])
                for s in run_live(one, _live_sessions(), timeout=120)[0]}
    finally:
        tools.shutdown()
        one.backend.close()
    assert len(want) == 6

    router = ClusterRouter(RouterConfig(heartbeat_timeout=30.0))
    engines, all_tools = {}, []
    for rid in ("a", "b"):
        engines[rid], t = _live_engine(params)
        all_tools.append(t)
        router.register(rid, engines[rid], now=0.0)
    both = dict(engines)
    moved = {}                               # sid -> (phase, decoded, tokens)

    def leave_b(now):
        b = engines.get("b")
        if b is None or not any(s.phase == Phase.TOOL for s in b.active):
            return
        before = {s.sid: (s.phase, s.decoded, len(s.meta.get("generated",
                                                               [])))
                  for s in b.waiting + b.active}
        for s in router.leave("b", now=now):
            moved[s.sid] = before[s.sid]
            assert router.place(s, now=now) == "a"
        del engines["b"]

    try:
        finished, _ = run_cluster_live(router, engines, _live_sessions(),
                                       timeout=120, on_round=leave_b)
    finally:
        for t in all_tools:
            t.shutdown()
        for e in both.values():
            e.backend.close()
    for e in both.values():
        e.check_invariants()
    assert any(p == Phase.TOOL for p, _, _ in moved.values())
    got = {s.sid: list(s.meta["generated"]) for s in finished}
    assert set(got) == set(want)
    for sid, toks in got.items():
        assert len(toks) == 2 * LIVE_DECODE, sid
        phase, decoded, n = moved.get(sid, (None, 0, 0))
        if phase == Phase.DECODING and decoded > 0:
            assert toks[:n] == want[sid][:n], sid
        else:
            assert toks == want[sid], sid
    assert set(moved) <= {s.sid for s in both["a"].finished}
    assert both["b"].blocks.free == both["b"].blocks.total
    assert not both["b"].active and not both["b"].waiting
    assert router.cluster_prefix_stats()["cluster_prefix_hits"] > 0
