"""The mixed iteration's stages and their CUDA graphs
(``engine.torch_runner._StepGraphs``).

On the CPU: the two stages (``lm_pack_next_paged`` per pack,
``lm_decode_next_paged``) composed give ``lm_mixed_paged``'s tokens and
pool exactly; ``run_mixed`` stays eager and counts its stages as such;
the graph cache's policy with a stand-in for the graph object (first
sighting eager, second captured, later replayed; distinct keys; no
capture under a mesh or off the card; a moved pool drops every graph;
replays add their capture's launches); ``calibrate`` timing replayed
stages; and ``run_mixed`` served through the stand-in against the eager
one. On the card (``card`` tests, skipped
without one): the graphed ``run_mixed`` against eager ``lm_mixed_paged``
on a copy of the same pool, bit for bit, with replays of both kinds and
the same kernel launches, and the replayed kernels in the profiler's
device records. Run them there with ``python -m pytest
tests/test_torch_step_graphs.py``.

No JAX here: the card tests compare with the port's own eager path.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.session import Round, make_session
from repro_torch.engine import torch_runner as tr
from repro_torch.engine.backend import BatchWork
from repro_torch.engine.torch_runner import TorchBackend, _StepGraphs
from repro_torch.kernels.paged_attention import paged_attention_fused
from repro_torch.kernels.paged_flash_attention import paged_flash_attention
from repro_torch.models import transformer as tf
from repro_torch.obs import spans

ARCHS = ["llama3.2-1b", "granite-moe-3b-a800m"]
PAGE = 32
CHUNK = 100                   # each pack's real tokens an iteration: C 128
PROMPT = 400                  # four packs a session
LANES = (50, 77)              # the decode lanes' first positions
STAGES = (tr.EAGER, tr.CAPTURED, tr.REPLAYED)


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    yield torch.device("cuda")
    torch.cuda.empty_cache()


def _backend(arch, device="cpu", dtype=torch.float32):
    return TorchBackend(get_config(arch).reduced(), layout="paged",
                        total_pages=64, page_size=PAGE, max_slots=4,
                        device=device, dtype=dtype, seed=0)


class _Sessions:
    """Three sessions prefilling ``PROMPT`` tokens, ``CHUNK`` a pack, and
    two decode lanes, each on pages of its own; ``work()`` is the next
    iteration's batch, ``advance()`` moves every session past it."""

    def __init__(self):
        self.leases, nxt = {}, 0
        self.packs = []
        for sid in range(3):
            self.packs.append(make_session(0.0, [Round(PROMPT, 4)], sid=sid))
            self.leases[sid] = tuple(range(nxt, nxt + 14))
            nxt += 14
        self.lanes = []
        for k, pos in enumerate(LANES):
            s = make_session(0.0, [Round(pos, 8)], sid=10 + k)
            s.resident_len = pos
            s.meta["next_token"] = 5 + k
            self.lanes.append(s)
            self.leases[s.sid] = tuple(range(nxt, nxt + 4))
            nxt += 4

    def work(self):
        w = BatchWork(decodes=[(s, 1) for s in self.lanes],
                      prefills=[(s, CHUNK) for s in self.packs
                                if s.resident_len < PROMPT],
                      swapins=[], mixed=True)
        w.leases.update(self.leases)
        return w

    def advance(self, work):
        for s, chunk in work.prefills:
            s.resident_len += chunk
        for s, _g in work.decodes:
            s.resident_len += 1

    def tokens(self, work):
        return ([s.meta["next_token"] for s, _ in work.prefills],
                [s.meta["generated"][-1] for s, _ in work.decodes])


def _same_pool(a, b, scratch):
    """Every page but the scratch page, whose slots padded rows write in
    no fixed order, equal bit for bit."""
    keep = [i for i in range(a.k.shape[1]) if i != scratch]
    return (torch.equal(a.k[:, keep], b.k[:, keep])
            and torch.equal(a.v[:, keep], b.v[:, keep]))


def _stage_counts(sp):
    out = dict.fromkeys(STAGES, 0)
    for s in sp:
        if s.name == "run_mixed":
            for k in STAGES:
                out[k] += s.counts.get(k, 0)
    return out


# ---------------------------------------------------------------------------
# the two stages
# ---------------------------------------------------------------------------

def _mixed_args(cfg, scratch):
    """Two packs (the second a slack pack on the scratch page) and three
    lanes (the third idle), as ``lm_mixed_paged`` takes them."""
    rng = np.random.default_rng(7)
    C, Np = 32, 4
    p_toks = np.zeros((2, 1, C), np.int32)
    p_toks[0, 0, :20] = rng.integers(2, cfg.vocab_size, 20)
    p_pos = np.full((2, 1, C), Np * PAGE - 1, np.int32)
    p_pos[0, 0, :20] = np.arange(32, 52)
    p_tables = np.full((2, Np), scratch, np.int32)
    p_tables[0, :2] = [6, 7]
    p_wpid = np.full((2, C), scratch, np.int32)
    p_wpid[0, :20] = 7
    p_woff = np.tile(np.arange(C, dtype=np.int32) % PAGE, (2, 1))
    p_woff[0, :20] = np.arange(20)
    p_kvlen = np.array([52, C], np.int32)
    p_last = np.array([19, C - 1], np.int32)
    lens = np.array([91, 34, 1], np.int32)
    tables = np.array([[0, 1, 2], [3, 4, scratch], [scratch] * 3], np.int32)
    d_toks = rng.integers(2, cfg.vocab_size, 3).astype(np.int32)
    d_pos = lens - 1
    d_wpid = np.array([2, 4, scratch], np.int32)
    d_woff = d_pos % PAGE
    d_woff[2] = 0
    return [torch.from_numpy(a) for a in (
        p_toks, p_pos, p_tables, p_wpid, p_woff, p_kvlen, p_last,
        d_toks, d_pos, tables, lens, d_wpid, d_woff)]


@pytest.mark.parametrize("arch", ARCHS)
def test_stages_compose_to_lm_mixed_paged(arch):
    cfg = get_config(arch).reduced()
    params = tf.init_lm(cfg, torch.Generator().manual_seed(0),
                        torch.float32, "cpu")
    scratch = 11
    pool = tf.PagedKVCache.zeros(cfg, scratch + 1, PAGE, torch.float32)
    g = torch.Generator().manual_seed(1)
    pool.k.normal_(generator=g)
    pool.v.normal_(generator=g)
    a = tf.PagedKVCache(pool.k.clone(), pool.v.clone())
    b = tf.PagedKVCache(pool.k.clone(), pool.v.clone())
    args = _mixed_args(cfg, scratch)
    p_next, d_next, a = tf.lm_mixed_paged(cfg, params, a, *args)
    (p_toks, p_pos, p_tables, p_wpid, p_woff, p_kvlen, p_last), d_args = \
        args[:7], args[7:]
    nxt = []
    for j in range(2):
        n, b = tf.lm_pack_next_paged(
            cfg, params, b, p_toks[j], p_pos[j], p_tables[j], p_wpid[j],
            p_woff[j], p_kvlen[j], p_last[j:j + 1])
        assert n.shape == (1,) and n.dtype == torch.int32
        nxt.append(n)
    d, b = tf.lm_decode_next_paged(cfg, params, b, *d_args)
    assert torch.equal(torch.cat(nxt), p_next) and torch.equal(d, d_next)
    assert _same_pool(a, b, scratch)
    assert not _same_pool(a, pool, scratch)      # the stages wrote KV


# ---------------------------------------------------------------------------
# run_mixed on the CPU
# ---------------------------------------------------------------------------

def test_run_mixed_on_the_cpu_stays_eager():
    b = _backend("llama3.2-1b")
    assert b._impl.graphs is None
    ss = _Sessions()
    spans.enable()
    for _ in range(3):
        work = ss.work()
        b.run_batch(work, 0.0)
        ss.advance(work)
    sp, _ = spans.drain()
    # P 4 (three packs, one slack) and the lanes, three times
    assert _stage_counts(sp) == {tr.EAGER: 15, tr.CAPTURED: 0,
                                 tr.REPLAYED: 0}


# ---------------------------------------------------------------------------
# the graph cache's policy, with a stand-in for the graph object
# ---------------------------------------------------------------------------

class _Graph:
    """Stands in for ``_CudaGraph`` on the CPU: ``capture`` runs the stage
    and keeps it; ``replay`` runs it again into the captured output, with
    the host's launch counts left as they were (a replay runs no host
    code)."""

    def __init__(self):
        self.fn = self.out = None
        self.warmed = self.captured = self.replays = 0

    def warm(self, fn):
        self.warmed += 1
        return fn()

    def capture(self, fn):
        self.captured += 1
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        self.replays += 1
        held = [f.launches for f in tr._COUNTED]
        self.out.copy_(self.fn())
        for f, n in zip(tr._COUNTED, held):
            f.launches = n


@pytest.fixture
def launches(monkeypatch):
    monkeypatch.setattr(paged_attention_fused, "launches", 0)
    monkeypatch.setattr(paged_flash_attention, "launches", 0)


def _double(x):
    """A stage: two decode launches and one prefill launch, by count."""
    paged_attention_fused.launches += 2
    paged_flash_attention.launches += 1
    return x * 2


def _pool(n=4):
    return tf.PagedKVCache(torch.zeros(n), torch.zeros(n))


def test_first_sighting_eager_second_captured_then_replayed(launches):
    graphs = []

    def new_graph():
        graphs.append(_Graph())
        return graphs[-1]

    g = _StepGraphs(new_graph=new_graph)
    g.follow(_pool())
    key = ("pack", 128, 16)
    got = []
    for i in range(4):
        x = torch.full((3,), float(i))
        out, how = g.run(key, _double, (x,))
        got.append(how)
        assert torch.equal(out, x * 2)
    assert got == [tr.EAGER, tr.CAPTURED, tr.REPLAYED, tr.REPLAYED]
    (gr,) = graphs
    assert (gr.warmed, gr.captured, gr.replays) == (1, 1, 3)
    # the graph reads its own buffers: the caller's input is copied in
    x = torch.full((3,), 9.0)
    out, _ = g.run(key, _double, (x,))
    assert out is gr.out and torch.equal(out, x * 2)
    # five runs, as five eager calls would count them
    assert (paged_attention_fused.launches,
            paged_flash_attention.launches) == (10, 5)


def test_pack_and_decode_keys_are_distinct(launches):
    g = _StepGraphs(new_graph=_Graph)
    g.follow(_pool())
    x = torch.ones(2)
    hows = [g.run(("pack", 32, 2), _double, (x,))[1] for _ in range(2)]
    hows += [g.run(("decode", 32, 2), _double, (x,))[1] for _ in range(2)]
    hows += [g.run(("pack", 64, 2), _double, (x,))[1]]
    assert hows == [tr.EAGER, tr.CAPTURED, tr.EAGER, tr.CAPTURED, tr.EAGER]
    assert set(g.stages) == {("pack", 32, 2), ("decode", 32, 2),
                             ("pack", 64, 2)}


def test_a_moved_pool_drops_every_graph(launches):
    g = _StepGraphs(new_graph=_Graph)
    pool = _pool()
    g.follow(pool)
    x = torch.ones(2)
    for _ in range(2):
        g.run(("decode", 4, 8), _double, (x,))
    g.follow(pool)                                # the same storage: kept
    assert g.run(("decode", 4, 8), _double, (x,))[1] == tr.REPLAYED
    g.follow(tf.PagedKVCache(pool.k.clone(), pool.v))
    assert g.stages == {}
    assert g.run(("decode", 4, 8), _double, (x,))[1] == tr.EAGER


def _fake_cuda(shape=(4,)):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return torch.empty(shape, device="cuda")


def _fake_dtensor(local):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    mesh = DeviceMesh("cuda", torch.arange(1), _init_backend=False, _rank=0)
    spec = DTensorSpec(mesh, (Replicate(),), tensor_meta=TensorMeta(
        local.shape, local.stride(), local.dtype))
    return DTensor(local, spec, requires_grad=False)


def test_only_plain_card_tensors_without_a_mesh_are_captured():
    """Checked on fake CUDA tensors (no card, no process group)."""
    pool = tf.PagedKVCache(_fake_cuda(), _fake_cuda())
    params = {"embed": _fake_cuda(), "layers": {"w": _fake_cuda()}}
    assert tr._graphable(pool, params)
    sharded = {**params, "layers": {"w": _fake_dtensor(_fake_cuda())}}
    assert not tr._graphable(pool, sharded)
    assert not tr._graphable(tf.PagedKVCache(_fake_dtensor(_fake_cuda()),
                                             _fake_cuda()), params)
    assert not tr._graphable(_pool(), params)               # the CPU
    assert not tr._graphable(pool, {**params, "lm_head": torch.zeros(2)})


def test_calibrate_times_the_replayed_stages():
    """Where graphs engage, the oracle prices the path that serves: each
    calibration stage is warmed, captured (and replayed once), then
    replayed inside the timed region."""
    b = _backend("llama3.2-1b")
    made = []

    def new_graph():
        made.append(_Graph())
        return made[-1]
    impl = b._impl
    impl.graphs = _StepGraphs(new_graph=new_graph)
    impl.calibrate()
    assert list(impl.graphs.stages) == [("pack", 64, 4), ("decode", 4, 2)]
    assert [(g.warmed, g.captured, g.replays) for g in made] == [
        (1, 1, 2), (1, 1, 2)]
    assert b._prefill_s_per_tok > 0 and b._decode_s_per_step > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_run_mixed_through_the_stand_in_serves_the_eager_tokens(arch):
    """Three iterations of three packs (P 4, one slack) and two lanes:
    the first warms the pack bucket, captures it at its second pack and
    replays it for the rest, and warms the decode bucket; the second
    captures the decode bucket; the third replays everything."""
    eager, graphed = _backend(arch), _backend(arch)
    graphed._impl.graphs = _StepGraphs(new_graph=_Graph)
    runs = []
    for b in (eager, graphed):
        ss, toks = _Sessions(), []
        spans.enable()
        for _ in range(3):
            work = ss.work()
            b.run_batch(work, 0.0)
            toks.append(ss.tokens(work))
            ss.advance(work)
        sp, _ = spans.drain()
        spans.disable()
        runs.append((toks, [s.counts for s in sp if s.name == "run_mixed"]))
    assert runs[1][0] == runs[0][0]
    assert _same_pool(graphed._impl.cache, eager._impl.cache,
                      eager._impl.scratch)
    assert [{k: c.get(k, 0) for k in STAGES} for c in runs[1][1]] == [
        {tr.EAGER: 2, tr.CAPTURED: 1, tr.REPLAYED: 2},
        {tr.EAGER: 0, tr.CAPTURED: 1, tr.REPLAYED: 4},
        {tr.EAGER: 0, tr.CAPTURED: 0, tr.REPLAYED: 5}]
    assert set(graphed._impl.graphs.stages) == {("pack", 128, 16),
                                                ("decode", 2, 4)}
    graphed.close()
    assert graphed._impl.graphs.stages == {}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_run_mixed_equals_eager_on_the_card(card, arch):
    """Each iteration's pool is copied first; eager ``lm_mixed_paged``
    over the arrays ``run_mixed`` built, on the copy, must give the
    graphed tokens and pool (but the scratch page) bit for bit,
    launching the paged kernels as often as the graphed iteration
    counted."""
    b = _backend(arch, device=card, dtype=torch.bfloat16)
    impl = b._impl
    assert impl.graphs is not None
    built = []
    inner = impl._mixed_inputs

    def mixed_inputs(work):
        got = inner(work)
        built.append(got[-1])
        return got
    impl._mixed_inputs = mixed_inputs
    ss, total = _Sessions(), dict.fromkeys(STAGES, 0)
    counted = [0, 0]
    for _ in range(4):
        copy = tf.PagedKVCache(impl.cache.k.clone(), impl.cache.v.clone())
        work = ss.work()
        before = [f.launches for f in tr._COUNTED]
        spans.enable()
        b.run_batch(work, 0.0)
        sp, _ = spans.drain()
        spans.disable()
        graphed = [f.launches - n for f, n in zip(tr._COUNTED, before)]
        for k, n in _stage_counts(sp).items():
            total[k] += n
        p, d = ss.tokens(work)
        before = [f.launches for f in tr._COUNTED]
        ep, ed, copy = tf.lm_mixed_paged(b.cfg, b.params, copy, *built[-1])
        eager = [f.launches - n for f, n in zip(tr._COUNTED, before)]
        torch.cuda.synchronize()
        assert ep[:len(p)].tolist() == p and ed.tolist() == d
        assert _same_pool(copy, impl.cache, impl.scratch)
        assert graphed == eager
        counted = [a + c for a, c in zip(counted, graphed)]
        ss.advance(work)
    assert total[tr.REPLAYED] >= 2 and total[tr.CAPTURED] == 2
    kinds = {k[0] for k in impl.graphs.stages}
    assert kinds == {"pack", "decode"} and all(
        st.inputs is not None for st in impl.graphs.stages.values())
    assert min(counted) > 0
    b.close()


@pytest.mark.card
def test_the_profiler_sees_replayed_kernels_on_the_card(card):
    """Three iterations under ``torch.profiler`` (eager, captured,
    replayed): the decode kernel's device records come from all three,
    not from the eager one alone (the profiler may miss a record)."""
    b = _backend("llama3.2-1b", device=card, dtype=torch.bfloat16)
    ss = _Sessions()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            work = ss.work()
            b.run_batch(work, 0.0)
            ss.advance(work)
        torch.cuda.synchronize()
    assert {k[0] for k in b._impl.graphs.stages} == {"pack", "decode"}
    n = sum("paged_decode_split" in e.name()
            for e in prof.profiler.kineto_results.events()
            if "CUDA" in str(e.device_type()))
    assert n >= 2 * b.cfg.n_layers + 1
    b.close()
