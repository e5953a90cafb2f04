"""``TorchBackend`` on the CPU against ``JaxBackend`` in the same Engine
scenarios: the greedy tokens must be identical.

Both backends serve ``llama3.2-1b`` ``.reduced()`` in float32 with the same
weights (the JAX backend's, carried across by ``repro_torch.models.
convert``). Each scenario is one of the live scenarios of
``tests/test_paged_runner.py`` / ``tests/test_continuous_batching.py``,
built with the reference's engine for the JAX backend and with the port's
own copy of the engine for the port.
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
from repro.engine import engine as jengine
from repro.engine.jax_runner import JaxBackend
from repro.engine.tools import RealToolExecutor as JRealToolExecutor
from repro_torch.configs.registry import get_config
from repro_torch.core import events as tev
from repro_torch.core.events import EventBus
from repro_torch.core.policies import KVAction
from repro_torch.core.session import Round, make_session
from repro_torch.engine import engine as tengine
from repro_torch.engine.tools import RealToolExecutor
from repro_torch.engine.torch_runner import TorchBackend
from repro_torch.models.convert import params_from_numpy

ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def jax_backend_params():
    """The weights JaxBackend(seed=0) draws (``model_zoo.init`` with
    ``PRNGKey(0)`` in float32), as numpy."""
    from repro.models import model_zoo
    params = model_zoo.init(jget_config(ARCH).reduced(),
                            jax.random.PRNGKey(0), jax.numpy.float32)
    return jax.tree.map(np.asarray, params)


# the two engines' vocabularies, so one scenario builder serves both
_JAX = dict(Round=JRound, make_session=jmake_session, EventBus=JEventBus,
            KVAction=JKVAction, engine=jengine,
            Tools=JRealToolExecutor)
_TORCH = dict(Round=Round, make_session=make_session, EventBus=EventBus,
              KVAction=KVAction, engine=tengine,
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


def _run(m, backend, sessions, *, scheduler="mixed", offload=None,
         tools=False, disk_blocks=0):
    bus = m["EventBus"]()
    tx = m["Tools"](cpu_slots=2, bus=bus) if tools else None
    eng = m["engine"].Engine(
        m["engine"].EngineConfig(total_kv_blocks=30, block_size=32,
                                 token_budget=256, max_decode_batch=4,
                                 decode_granularity=4, cpu_slots=2,
                                 scheduler=scheduler,
                                 disk_tier_blocks=disk_blocks),
        "fcfs", backend, bus=bus, **({"tool_exec": tx} if tx else {}))
    if offload is not None:
        action = getattr(m["KVAction"], offload)
        eng.policy.on_tool_yield = lambda s, now: (action, 0.0)
    try:
        finished, _ = m["engine"].run_live(eng, sessions, timeout=120)
    finally:
        if tx is not None:
            tx.shutdown()
        backend.close()
    eng.check_invariants()
    return {s.sid: list(s.meta["generated"]) for s in finished}, eng


def _torch_backend(params, spool=None):
    return TorchBackend(get_config(ARCH).reduced(), max_slots=4, max_len=256,
                        device="cpu", dtype=torch.float32,
                        params=params_from_numpy(params, dtype=torch.float32),
                        disk_spool=spool and f"{spool}/torch")


def _both(params, build, spool=None, **kw):
    jb = JaxBackend(jget_config(ARCH).reduced(), max_slots=4, max_len=256,
                    disk_spool=spool and f"{spool}/jax")
    jtok, _ = _run(_JAX, jb, build(_JAX), **kw)
    ttok, eng = _run(_TORCH, _torch_backend(params, spool), build(_TORCH),
                     **kw)
    return jtok, ttok, eng


@pytest.mark.live
def test_shared_family_tokens_match_jax_mixed_and_round(jax_backend_params):
    """Shared-prefix family, physically shared prefix pages, mid-prefill
    joins: on the mixed scheduler (one lm_mixed_paged call per tick) the
    port emits exactly the JAX backend's greedy tokens, and on the round
    scheduler (per-session prefill calls + decode steps) exactly its own
    mixed tokens."""
    sids = [95101, 95102, 95103]
    jtok, ttok, eng = _both(jax_backend_params, lambda m: _family(m, sids))
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
    jtok, ttok, eng = _both(jax_backend_params,
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
    jtok, ttok, eng = _both(jax_backend_params,
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
    jtok, ttok, eng = _both(jax_backend_params,
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
    cfg = get_config(ARCH).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchBackend(cfg, layout="dense", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchBackend(get_config("gemma2-27b").reduced(), device="cpu")
