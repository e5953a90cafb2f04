"""``TorchBackend`` on the CPU against ``JaxBackend`` in the same Engine
scenarios: the greedy tokens must be identical.

Both backends serve a ``.reduced()`` config in float32 with the same
weights (the JAX backend's, carried across by ``repro_torch.models.
convert``): ``llama3.2-1b`` on the paged layout, ``gemma2-27b`` on the
dense slot layout (sliding window and softcaps: both backends choose it).
Each scenario is one of the live scenarios of
``tests/test_paged_runner.py`` / ``tests/test_continuous_batching.py``,
built with the reference's engine for the JAX backend and with the port's
own copy of the engine for the port. The paged scenarios run again on
``granite-moe-3b-a800m`` (the MoE family on the paged path), and the
OpenAI-style ``ServingAPI`` drives both backends as
``tests/test_engine_properties.py`` drives the JAX one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.events import EventBus as JEventBus
from repro.core.policies import KVAction as JKVAction
from repro.core.session import Round as JRound
from repro.core.session import make_session as jmake_session
from repro.engine import api as japi
from repro.engine import engine as jengine
from repro.engine.jax_runner import JaxBackend
from repro.engine.tools import RealToolExecutor as JRealToolExecutor
from repro_torch.configs.registry import get_config
from repro_torch.core import events as tev
from repro_torch.core.events import EventBus
from repro_torch.core.policies import KVAction
from repro_torch.core.session import Round, make_session
from repro_torch.engine import api as tapi
from repro_torch.engine import engine as tengine
from repro_torch.engine.tools import RealToolExecutor
from repro_torch.engine.torch_runner import TorchBackend
from repro_torch.models.convert import params_from_numpy
from test_torch_model import _reduced

ARCH = "llama3.2-1b"
MOE_ARCH = "granite-moe-3b-a800m"
GPT_OSS = "gpt-oss-120b"


def _jax_params(arch):
    """The weights JaxBackend(seed=0) draws (``model_zoo.init`` with
    ``PRNGKey(0)`` in float32), as numpy."""
    from repro.models import model_zoo
    params = model_zoo.init(_reduced(arch)[1], jax.random.PRNGKey(0),
                            jax.numpy.float32)
    return jax.tree.map(np.asarray, params)


def _composition(eng):
    """Per-tick batch composition from the engine's TICK events: the
    prefill, decode and swap counts and tokens of every tick that ran a
    batch (idle ticks, whose number follows the wall clock, left out)."""
    keys = ("n_prefills", "prefill_tokens", "n_decodes", "decode_tokens",
            "n_swapins", "n_swapouts")
    rows = [tuple(e.data[k] for k in keys) for e in eng.bus.log
            if e.kind == "tick"]
    return [r for r in rows if any(r)]


@pytest.fixture(scope="module")
def jax_backend_params():
    return _jax_params(ARCH)


# the two engines' vocabularies, so one scenario builder serves both
_JAX = dict(Round=JRound, make_session=jmake_session, EventBus=JEventBus,
            KVAction=JKVAction, engine=jengine, api=japi,
            Tools=JRealToolExecutor)
_TORCH = dict(Round=Round, make_session=make_session, EventBus=EventBus,
              KVAction=KVAction, engine=tengine, api=tapi,
              Tools=RealToolExecutor)


def _family(m, sids, *, shared_chunks=3, tail_chunks=1, rounds=1,
            tool_s=0.05):
    """Shared-prefix family with staggered arrivals (identical leading
    chunk keys, unique tails), as in ``tests/test_paged_runner.py``."""
    fam = [(("fam", i), 32) for i in range(shared_chunks)]
    first = 32 * (shared_chunks + tail_chunks)
    out = []
    for j, sid in enumerate(sids):
        rs = [m["Round"](first, 8, "t" if rounds > 1 else None,
                         tool_s if rounds > 1 else 0.0)]
        for r in range(1, rounds):
            rs.append(m["Round"](32, 6, "t" if r < rounds - 1 else None,
                                 tool_s if r < rounds - 1 else 0.0))
        s = m["make_session"](0.05 * j, rs, ideal_time=1.0, sid=sid)
        s.meta["prefix_hashes"] = fam + [
            (("u", sid, i), 32) for i in range(tail_chunks)]
        out.append(s)
    return out


def _duplicates(m, sids, *, shared_chunks=3, tail_tokens=16):
    """A canonical session plus exact duplicates with a non-block-aligned
    tail: the canonical's first decode writes into its indexed partial
    tail block (copy-on-write -> device page copy)."""
    first = 32 * shared_chunks + tail_tokens
    h = [(("dfam", i), 32) for i in range(shared_chunks)] + \
        [(("dfam", "t"), tail_tokens)]
    out = []
    for j, sid in enumerate(sids):
        s = m["make_session"](0.2 * j, [m["Round"](first, 8, None, 0.0)],
                              ideal_time=1.0, sid=sid)
        s.meta["prefix_hashes"] = list(h)
        out.append(s)
    return out


def _virtual_clock(m, eng, sessions, *, dt=100.0, max_ticks=2000):
    """Drive ``eng`` with a clock that advances ``dt`` seconds a tick,
    whatever the wall: arrivals, tool ends (the simulated tool executor)
    and every timestamp then follow the tick count, so two backends of
    different speed see one schedule while ``dt`` exceeds any tick's
    measured seconds. The swap stream is drained before each tick, so a
    restore never waits on a transfer still running on the wall clock.
    Returns the finished sessions."""
    arrivals = sorted(sessions, key=lambda s: s.arrival_time)
    stream = getattr(eng.backend._impl, "stream", None)   # dense: none
    i, now = 0, 0.0
    for _ in range(max_ticks):
        if stream is not None:
            stream.drain(timeout=60)
        while i < len(arrivals) and arrivals[i].arrival_time <= now:
            eng.submit(arrivals[i])
            i += 1
        eng.tick(now)
        if eng.done() and i >= len(arrivals):
            break
        now += dt
    return eng.finished, now


def _run(m, backend, sessions, *, scheduler="mixed", offload=None,
         tools=False, disk_blocks=0, virtual=False):
    """One Engine run under FCFS on the wall clock (``run_live``, real
    tools), or with ``virtual`` on ``_virtual_clock`` (simulated tools)."""
    bus = m["EventBus"]()
    tx = m["Tools"](cpu_slots=2, bus=bus) if tools and not virtual else None
    eng = m["engine"].Engine(
        m["engine"].EngineConfig(total_kv_blocks=30, block_size=32,
                                 token_budget=256, max_decode_batch=4,
                                 decode_granularity=4, cpu_slots=2,
                                 scheduler=scheduler,
                                 disk_tier_blocks=disk_blocks),
        "fcfs", backend, bus=bus, **({"tool_exec": tx} if tx else {}))
    eng.trace_ticks = True                  # TICK events: _composition
    if offload is not None:
        action = getattr(m["KVAction"], offload)
        eng.policy.on_tool_yield = lambda s, now: (action, 0.0)
    try:
        if virtual:
            finished, _ = _virtual_clock(m, eng, sessions)
        else:
            finished, _ = m["engine"].run_live(eng, sessions, timeout=120)
    finally:
        if tx is not None:
            tx.shutdown()
        backend.close()
    eng.check_invariants()
    return {s.sid: list(s.meta["generated"]) for s in finished}, eng


def _torch_backend(params, spool=None, arch=ARCH, layout="paged"):
    return TorchBackend(_reduced(arch)[0], layout=layout,
                        max_slots=4, max_len=256, device="cpu",
                        dtype=torch.float32,
                        params=params_from_numpy(params, dtype=torch.float32),
                        disk_spool=spool and f"{spool}/torch")


def _both(params, build, spool=None, arch=ARCH, **kw):
    jb = JaxBackend(_reduced(arch)[1], max_slots=4, max_len=256,
                    disk_spool=spool and f"{spool}/jax")
    jtok, jeng = _run(_JAX, jb, build(_JAX), **kw)
    ttok, eng = _run(_TORCH, _torch_backend(params, spool, arch),
                     build(_TORCH), **kw)
    return jtok, ttok, eng, jeng


@pytest.mark.live
def test_shared_family_tokens_match_jax_mixed_and_round(jax_backend_params):
    """Shared-prefix family, physically shared prefix pages, mid-prefill
    joins: on the mixed scheduler (one lm_mixed_paged call per tick) the
    port emits exactly the JAX backend's greedy tokens, and on the round
    scheduler (per-session prefill calls + decode steps) exactly its own
    mixed tokens."""
    sids = [95101, 95102, 95103]
    jtok, ttok, eng, jeng = _both(jax_backend_params, lambda m: _family(m, sids))
    assert set(ttok) == set(sids)
    assert ttok == jtok
    assert eng.prefix_hit_tokens >= 2 * 96
    st = eng.backend.dispatch_stats
    assert st["mixed_calls"] > 0
    assert st["prefill_inplace_bytes"] < st["prefill_gather_bytes"]
    rtok, reng = _run(_TORCH, _torch_backend(jax_backend_params),
                      _family(_TORCH, sids), scheduler="round")
    assert rtok == ttok
    assert reng.backend.dispatch_stats["mixed_calls"] == 0


@pytest.mark.live
def test_forced_offload_tokens_match_jax(jax_backend_params):
    """Forced OFFLOAD at every tool yield: per-block swap-out, prefetch and
    swap-in through the async stream give the JAX backend's tokens."""
    sids = [97101, 97102]
    jtok, ttok, eng, jeng = _both(jax_backend_params,
                            lambda m: _family(m, sids, rounds=2),
                            offload="OFFLOAD", tools=True)
    assert ttok == jtok and set(ttok) == set(sids)
    outs = [e for e in eng.bus.log if e.kind == tev.SWAP_OUT
            and e.data.get("tier") == "host"]
    assert outs, "offload path not exercised"
    assert any(e.data["copied"] < e.data["blocks"] for e in outs)
    assert eng.host.used_blocks == 0
    stats = eng.backend.swap_stream_stats()
    assert stats["d2h_completed"] > 0 and stats["h2d_completed"] > 0


@pytest.mark.live
def test_forced_disk_offload_tokens_match_jax(jax_backend_params, tmp_path):
    """Forced OFFLOAD_DISK with real spool files: KV spills to NVMe files
    and fills back (h2n / n2h jobs on the stream) and the tokens are still
    the JAX backend's."""
    sids = [97201, 97202]
    jtok, ttok, eng, jeng = _both(jax_backend_params,
                            lambda m: _family(m, sids, rounds=2),
                            spool=str(tmp_path), offload="OFFLOAD_DISK",
                            tools=True, disk_blocks=64)
    assert ttok == jtok and set(ttok) == set(sids)
    stats = eng.backend.swap_stream_stats()
    assert stats["h2n_completed"] >= 1 and stats["n2h_completed"] >= 1
    tier = eng.tiers.stats()
    assert tier["staged_restores"] >= 1
    assert tier["disk"]["used_blocks"] == tier["host"]["used_blocks"] == 0


def test_spool_round_trip_is_bit_exact_in_bf16(tmp_path):
    """bf16 host copies cross the numpy spool as their int16 bits."""
    from repro_torch.engine.torch_runner import _from_numpy, _to_numpy
    from repro_torch.kvcache.disk_tier import DiskFileStore
    k = torch.randn(2, 4, 32, 2, 16).to(torch.bfloat16)
    v = torch.randn(2, 4, 32, 2, 16).to(torch.bfloat16)
    store = DiskFileStore(str(tmp_path))
    store.write(5, _to_numpy(k), _to_numpy(v))
    k2, v2 = (_from_numpy(a, torch.bfloat16) for a in store.read(5))
    assert k2.dtype == torch.bfloat16 and torch.equal(k2, k)
    assert torch.equal(v2, v)


@pytest.mark.live
def test_duplicate_and_cow_tail_tokens_match_jax(jax_backend_params):
    sids = [94101, 94102]
    jtok, ttok, eng, jeng = _both(jax_backend_params,
                            lambda m: _duplicates(m, sids))
    assert ttok == jtok and set(ttok) == set(sids)
    assert eng.prefix_hit_tokens == 3 * 32
    assert eng.blocks.cow_count >= 1


def test_torch_backend_needs_a_card_unless_cpu(monkeypatch):
    """Entry points run on the card: with no CUDA device they raise unless
    the caller asks for the CPU."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBackend(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_live(arch=ARCH, policy="mars", n_sessions=1)
    b = TorchBackend(cfg, device="cpu", dtype=torch.float32, max_slots=1,
                     max_len=64)
    b.close()
    assert b.params["embed"].device.type == "cpu"


def test_unported_layouts_raise():
    """The MoE family is served, on the paged layout as JaxBackend serves
    it; a family that is no LM and an unknown layout are refused."""
    b = TorchBackend(get_config(MOE_ARCH).reduced(), device="cpu",
                     dtype=torch.float32, max_slots=1, max_len=64)
    try:
        assert b.layout == "paged" and b.supports_prefix_sharing
        assert "moe" in b.params["layers"]
    finally:
        b.close()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchBackend(get_config("rwkv6-1.6b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="layout"):
        TorchBackend(get_config(ARCH).reduced(), layout="slab",
                     device="cpu")


def test_dense_layout_choice_and_flags():
    """As in JaxBackend: ``layout="paged"`` on a config the paged kernels
    reject (gemma2) becomes ``"dense"``, ``"dense"`` is taken for any
    dense-family config, and the dense layout shares no prefix, needs no
    last-token compute, swaps synchronously and has no swap stream."""
    for cfg, layout in ((get_config("gemma2-27b").reduced(), "paged"),
                        (get_config(ARCH).reduced(), "dense")):
        b = TorchBackend(cfg, layout=layout, device="cpu",
                         dtype=torch.float32, max_slots=2, max_len=80)
        try:
            assert b.layout == "dense"
            assert not (b.supports_prefix_sharing
                        or b.requires_last_token_compute
                        or b.supports_async_swap)
            assert b.swap_stream_stats() is None
            assert b.kv_bytes_per_token() == \
                2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim_ * 4
        finally:
            b.close()


@pytest.mark.live
def test_gemma2_dense_tokens_match_jax_with_forced_offload():
    """gemma2 (window 64, softcaps, post norms) on the dense layout, two
    rounds past the window with a forced whole-slot OFFLOAD at the tool
    yield: the port emits exactly the JAX backend's greedy tokens, on the
    round path (the dense layout has no fused mixed tick)."""
    sids = [96101, 96102]
    jtok, ttok, eng, jeng = _both(
        _jax_params("gemma2-27b"),
        lambda m: _family(m, sids, rounds=2, tail_chunks=2),
        arch="gemma2-27b", offload="OFFLOAD", tools=True)
    assert ttok == jtok and set(ttok) == set(sids)
    assert eng.backend.layout == "dense"
    st = eng.backend.dispatch_stats
    assert st["mixed_calls"] == 0 and st["prefill_calls"] > 0
    outs = [e for e in eng.bus.log if e.kind == tev.SWAP_OUT
            and e.data.get("tier") == "host"]
    assert outs, "offload path not exercised"
    assert eng.prefix_hit_tokens == 0


@pytest.mark.live
def test_dense_layout_tokens_match_paged(jax_backend_params):
    """The port's own dense layout (every member recomputes its context)
    emits exactly the tokens of its paged layout (shared prefix pages),
    as ``test_paged_dense_greedy_decode_parity_on_shared_family`` holds
    for JAX."""
    sids = [91101, 91102, 91103]
    paged, _ = _run(_TORCH, _torch_backend(jax_backend_params),
                    _family(_TORCH, sids))
    dense, eng = _run(_TORCH, _torch_backend(jax_backend_params,
                                             layout="dense"),
                      _family(_TORCH, sids))
    assert set(dense) == set(sids) and dense == paged
    assert eng.backend.layout == "dense"
    assert eng.backend.dispatch_stats["mixed_calls"] == 0


def test_serve_live_gemma2_takes_the_dense_layout(monkeypatch):
    """``serve_live(arch="gemma2-27b")`` serves through the dense layout
    (here the reduced config on the CPU)."""
    from repro_torch.launch import serve
    built = []
    orig = TorchBackend.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        built.append(self)
    monkeypatch.setattr(TorchBackend, "__init__", spy)
    finished = serve.serve_live(arch="gemma2-27b", policy="mars",
                                n_sessions=1, device="cpu", verbose=False)
    assert [b.layout for b in built] == ["dense"]
    assert len(finished) == 1
    assert len(finished[0].meta["generated"]) == 12 + 8 + 8


def test_serve_live_moe_takes_the_paged_layout(monkeypatch):
    """``serve_live(arch="granite-moe-3b-a800m")`` serves the MoE family
    on the paged layout (here the reduced config on the CPU)."""
    from repro_torch.launch import serve
    built = []
    orig = TorchBackend.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        built.append(self)
    monkeypatch.setattr(TorchBackend, "__init__", spy)
    finished = serve.serve_live(arch=MOE_ARCH, policy="mars", n_sessions=1,
                                device="cpu", verbose=False)
    assert [b.layout for b in built] == ["paged"]
    assert [b.cfg.family for b in built] == ["moe"]
    assert len(finished) == 1
    assert len(finished[0].meta["generated"]) == 12 + 8 + 8


# ---------------------------------------------------------------------------
# the MoE family on the paged path, and the ServingAPI front end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_backend_params():
    return _jax_params(MOE_ARCH)


# each scenario twice: on the wall clock (``run_live``, real tools, the
# swap stream overlapping ticks), where the two backends' tick speeds give
# two schedules, and on the virtual clock (``_virtual_clock``), where they
# give one. The capacity dispatch couples every token of a call, so the
# schedule is compared only where it is one (ROADMAP.md §3).
_MOE_BUILDS = {
    "shared_family": dict(build=lambda m: _family(m, [93101, 93102, 93103])),
    "forced_offload": dict(build=lambda m: _family(m, [93201, 93202],
                                                   rounds=2),
                           offload="OFFLOAD", tools=True),
    "cow_tail": dict(build=lambda m: _duplicates(m, [93301, 93302])),
}
MOE_SCENARIOS = {**_MOE_BUILDS,
                 **{f"{k}_virtual": dict(v, virtual=True)
                    for k, v in _MOE_BUILDS.items()}}


@pytest.mark.live
@pytest.mark.parametrize("scenario", sorted(MOE_SCENARIOS))
def test_moe_tokens_match_jax(moe_backend_params, scenario):
    """The shared-family, forced-offload and CoW-tail scenarios above on
    ``granite-moe-3b-a800m``: every layer's FFN is the capacity-dispatched
    MoE over each pack's and each decode batch's own padded tokens, and the
    port emits exactly the JAX backend's greedy tokens. On the virtual
    clock the two engines' per-tick batch composition is compared first,
    so a schedule difference fails as such; on the wall clock it differs
    by the backends' speeds (the port decodes alone at tick 1 where JAX,
    slower, also prefills the second arrival) and only the tokens are
    held."""
    kw = dict(MOE_SCENARIOS[scenario])
    build = kw.pop("build")
    jtok, ttok, eng, jeng = _both(moe_backend_params, build, arch=MOE_ARCH,
                                  **kw)
    if kw.get("virtual"):
        assert _composition(eng) == _composition(jeng)
    assert ttok == jtok and len(ttok) >= 2
    assert eng.backend.layout == "paged"
    assert eng.backend.dispatch_stats["mixed_calls"] > 0
    if scenario.startswith("shared_family"):
        assert eng.prefix_hit_tokens >= 2 * 96
    elif scenario.startswith("forced_offload"):
        assert any(e.kind == tev.SWAP_OUT and e.data.get("tier") == "host"
                   for e in eng.bus.log)
        assert eng.backend.swap_stream_stats()["h2d_completed"] > 0
    else:
        assert eng.blocks.cow_count >= 1


def _api_run(m, backend):
    """Two rounds of one job through ``ServingAPI`` under MARS with a real
    tool in between, as ``test_serving_api_session_continuity`` runs them.
    Returns (results of both futures, tool effects, engine, whether the
    job's second round resumed warm)."""
    bus = m["EventBus"]()
    tools = m["Tools"](cpu_slots=1, bus=bus)
    eng = m["engine"].Engine(
        m["engine"].EngineConfig(total_kv_blocks=2 * 255 // 32,
                                 token_budget=128, max_decode_batch=2,
                                 decode_granularity=4, cpu_slots=1),
        "mars", backend, bus=bus, tool_exec=tools)
    eng.trace_ticks = True                  # TICK events: _composition
    api = m["api"].ServingAPI(eng)
    Req = m["api"].ChatRequest
    effects = []
    f1 = api.submit(Req(job_id="job-A", prompt_tokens=list(range(2, 50)),
                        max_tokens=8,
                        tool_call={"kind": "t",
                                   "fn": lambda: effects.append(1)}))
    f2 = api.submit(Req(job_id="job-A", prompt_tokens=list(range(2, 20)),
                        max_tokens=8, final=True))
    session = api._jobs["job-A"]
    try:
        m["engine"].run_live(eng, [], timeout=90)
    finally:
        tools.shutdown()
        backend.close()
    results = [f1.result(timeout=5), f2.result(timeout=5)]
    assert session.phase.value == "finished" and api.active_jobs() == []
    warm = any(e.kind == "unpin" and e.sid == session.sid
               and e.data.get("warm") for e in bus.log)
    return results, effects, eng, warm


@pytest.mark.live
@pytest.mark.parametrize("arch", [ARCH, MOE_ARCH])
def test_serving_api_tokens_match_jax(arch):
    """``ServingAPI`` over ``TorchBackend(device="cpu")`` and over
    ``JaxBackend``: one ``job_id`` spans both rounds, the tool runs once,
    the second round resumes warm (its KV pinned through the tool call)
    and both backends resolve the futures with the same greedy tokens,
    after the same per-tick batch composition (the MoE tokens depend on
    the schedule)."""
    params = _jax_params(arch)
    jb = JaxBackend(jget_config(arch).reduced(), max_slots=2, max_len=256)
    want, jeff, jeng, jwarm = _api_run(_JAX, jb)
    tb = TorchBackend(get_config(arch).reduced(), max_slots=2, max_len=256,
                      device="cpu", dtype=torch.float32,
                      params=params_from_numpy(params, dtype=torch.float32))
    got, teff, teng, twarm = _api_run(_TORCH, tb)
    assert _composition(teng) == _composition(jeng)
    assert teff == jeff == [1]
    assert [r["round"] for r in got] == [0, 1]
    assert all(r["job_id"] == "job-A" for r in got)
    assert all(len(r["tokens"]) == 8 and r["ttft"] is not None for r in got)
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    assert twarm and jwarm


@pytest.mark.live
def test_gpt_oss_dense_layout_tokens_match_jax():
    """``gpt-oss-120b`` ``.reduced()`` (MoE with local/global layers,
    window 128): both backends take the dense layout, and the port emits
    exactly the JAX backend's greedy tokens over two rounds with a tool in
    between, on the virtual clock (the MoE tokens depend on the schedule;
    see ``MOE_SCENARIOS``). The per-tick batch composition is compared
    first."""
    sids = [93151, 93152, 93153]
    jtok, ttok, eng, jeng = _both(
        _jax_params(GPT_OSS), lambda m: _family(m, sids, rounds=2),
        arch=GPT_OSS, tools=True, virtual=True)
    assert eng.backend.layout == "dense" and eng.backend.cfg.family == "moe"
    assert _composition(eng) == _composition(jeng)
    assert ttok == jtok and set(ttok) == set(sids)
    assert all(len(t) == 8 + 6 for t in ttok.values())
