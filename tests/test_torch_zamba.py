"""The port's Mamba2 block and zamba2 family on the CPU against the JAX
package.

Inputs come from a numpy seed, the weights from
``repro.models.model_zoo.init`` carried across by
``repro_torch.models.convert``, on ``zamba2-1.2b`` ``.reduced()``: 7 Mamba
layers, the shared block after layers 2 and 5 plus a trailing one-layer
segment, SSD chunk 16, d_inner 256 in 8 heads of 32, state 16. On a CPU
tensor the flash attention of the shared block runs its plain version.

- ``ssd_chunked`` and ``ssd_step`` against JAX's (f32, 1e-5 of the
  largest magnitude), ``ssd_chunked`` also against a loop of the port's
  ``ssd_step`` (the chunked form and the recurrence it stands for);
- the causal convolution (full and one-step) and ``mamba_block_full`` /
  ``mamba_block_step`` from a nonzero state, 1e-5;
- ``zamba_forward`` / ``zamba_prefill`` / ``zamba_decode`` logits and every
  cache field within 1e-4 of each tensor's largest magnitude (at least
  1), at T of two chunks, T equal to the chunk and T below it; a ragged T
  raises ``ValueError`` (JAX asserts); prefill plus teacher-forced decode
  steps against the forward over the whole sequence (1e-3 of the largest
  logit, the card check's limit);
- ``init``'s shapes and dtypes against ``jax.eval_shape``, the converter's
  per-leaf dtypes (``A_log``, ``dt_bias``, ``D_skip``, ``gn_scale`` stay f32
  under bf16), the cache specs;
- the train loss and every gradient leaf against ``jax.value_and_grad``,
  at ``tests/test_torch_train.py``'s LM tolerance (1e-4 of each leaf's
  largest magnitude), and ``remat`` equal to no remat.

JAX's ``softplus`` has no threshold, torch's returns x above 20; the
random-init ``dt`` stays far below it, and the two differ by below 2e-9
there in any case.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.distributed import steps as jsteps
from repro.models import mamba2 as jmamba
from repro.models import model_zoo as jzoo
from repro.models import zamba2 as jzamba
from repro_torch.configs.registry import get_config
from repro_torch.distributed import steps as tsteps
from repro_torch.launch.train import train
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import zamba2 as tzamba
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as topt

ARCH = "zamba2-1.2b"
F32 = torch.float32
MODEL_TOL = 1e-4
KERNEL_TOL = 1e-5
DECODE_TOL = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    want = _np(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0,
                               err_msg=what)


def _fields(cache):
    """(name, tensor) of every leaf of a (nested) cache dataclass."""
    out = []
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        out += [(f"{f.name}.{n}", t) for n, t in _fields(v)] \
            if dataclasses.is_dataclass(v) else [(f.name, v)]
    return out


def _cache_close(tcache, jcache, what):
    jf = dict(_fields(jcache))
    tf_ = _fields(tcache)
    assert [n for n, _ in tf_] == list(jf)
    for name, t in tf_:
        assert tuple(t.shape) == tuple(jf[name].shape), name
        _close(t, jf[name], MODEL_TOL, f"{what} {name}")


@functools.lru_cache(maxsize=None)
def _jit(name, dtype=jnp.float32):
    """``repro.models.model_zoo.<name>`` on the reduced config, jitted (the
    JAX side compiles once instead of dispatching op by op); ``init``
    takes the key and draws in ``dtype``."""
    jcfg = jget_config(ARCH).reduced()
    if name == "init":
        return jax.jit(lambda key: jzoo.init(jcfg, key, dtype))
    return jax.jit(functools.partial(getattr(jzoo, name), jcfg))


@functools.lru_cache(maxsize=None)
def _load():
    """(cfg, jcfg, JAX f32 params, the port's copy); shared, not mutated."""
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    jparams = _jit("init")(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=F32)
    return cfg, jcfg, jparams, tparams


def _layer(l=1):
    cfg, jcfg, jp, tp = _load()
    return (cfg, jcfg, jax.tree.map(lambda a: a[l], jp["mamba_layers"]),
            {k: v[l] for k, v in tp["mamba_layers"].items()})


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def _ssd_case(seed, B, T, H, P, N):
    """Inputs in the model's ranges: dt a softplus of a shifted normal,
    A from -1 to -16 as A_log's linspace, a nonzero incoming state."""
    rng = np.random.default_rng(seed)
    n = (lambda *s: rng.standard_normal(s).astype(np.float32))
    dt = np.log1p(np.exp(n(B, T, H) - 2.0)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    return (n(B, T, H, P), dt, A, n(B, T, N) * 0.5, n(B, T, N) * 0.5,
            n(B, H, P, N) * 0.3)


# (B, T, H, P, N, chunk): two chunks, one chunk, a longer chunk, B 1
SSD_CASES = [(2, 32, 4, 8, 16, 16), (1, 16, 2, 32, 16, 16),
             (2, 64, 3, 16, 8, 32), (1, 48, 8, 8, 4, 16)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_chunked_matches_jax_and_the_recurrence(case):
    B, T, H, P, N, chunk = case
    arrays = _ssd_case(B * 100 + T, B, T, H, P, N)
    y, S = tmamba.ssd_chunked(*map(torch.from_numpy, arrays), chunk)
    jy, jS = jmamba.ssd_chunked(*map(jnp.asarray, arrays), chunk)
    assert y.dtype == S.dtype == F32 and y.shape == (B, T, H, P)
    _close(y, jy, KERNEL_TOL, "y")
    _close(S, jS, KERNEL_TOL, "state")
    x, dt, A, Bm, Cm, state = map(torch.from_numpy, arrays)
    ys = []
    for t in range(T):
        yt, state = tmamba.ssd_step(x[:, t], dt[:, t], A, Bm[:, t],
                                    Cm[:, t], state)
        ys.append(yt)
    _close(y, torch.stack(ys, 1), KERNEL_TOL, "y vs the recurrence")
    _close(S, state, KERNEL_TOL, "state vs the recurrence")


def _steep_case(steep):
    """One chunk of 64 whose steepest head has ``|sum dt * A|`` = steep."""
    rng = np.random.default_rng(int(steep))
    n = (lambda *s: rng.standard_normal(s).astype(np.float32))
    A = np.array([-1.0, -16.0], np.float32)
    dt = np.full((1, 64, 2), steep / 16 / 64, np.float32)
    return (n(1, 64, 2, 8), dt, A, n(1, 64, 4), n(1, 64, 4),
            np.zeros((1, 2, 8, 4), np.float32))


def _ssd_grads(fn, arrays, lib):
    """The gradient of sum(y) + sum(state) w.r.t. x, dt, Bm, Cm."""
    if lib == "jax":
        def loss(x, dt, Bm, Cm):
            y, S = fn(x, dt, jnp.asarray(arrays[2]), Bm, Cm,
                      jnp.asarray(arrays[5]))
            return jnp.sum(y) + jnp.sum(S)
        ins = [jnp.asarray(arrays[i]) for i in (0, 1, 3, 4)]
        return [np.asarray(g) for g in
                jax.grad(loss, argnums=(0, 1, 2, 3))(*ins)]
    ins = [torch.from_numpy(arrays[i]).requires_grad_(True)
           for i in (0, 1, 3, 4)]
    y, S = fn(ins[0], ins[1], torch.from_numpy(arrays[2]), ins[2], ins[3],
              torch.from_numpy(arrays[5]))
    return [_np(g) for g in torch.autograd.grad(y.sum() + S.sum(), ins)]


def _recurrence(x, dt, A, Bm, Cm, state):
    ys = []
    for t in range(x.shape[1]):
        y, state = tmamba.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                   state)
        ys.append(y)
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("steep", [60.0, 95.0, 150.0, 190.0, 400.0])
def test_ssd_chunked_on_steep_chunks(steep):
    """JAX's centred intra-chunk weights hold its forward while half a
    chunk's ``|sum dt * A|`` stays inside f32's exp range (to ~177) and
    its gradient only to ~88.7 (above the diagonal the masked product
    overflows, and the mask, applied after the product with C.B, leaves
    0 * inf in C.B's gradient). The port takes exp of the masked
    difference: its forward and gradient equal the one-step recurrence's
    at every steepness, and its forward equals JAX's wherever JAX's is
    finite, its gradient wherever JAX's is."""
    arrays = _steep_case(steep)
    y, S = tmamba.ssd_chunked(*map(torch.from_numpy, arrays), 64)
    ry, rS = _recurrence(*map(torch.from_numpy, arrays))
    _close(y, ry, KERNEL_TOL, "y vs the recurrence")
    _close(S, rS, KERNEL_TOL, "state vs the recurrence")
    got = _ssd_grads(functools.partial(tmamba.ssd_chunked, chunk=64),
                     arrays, "torch")
    want = _ssd_grads(_recurrence, arrays, "torch")
    for g, w, what in zip(got, want, ("x", "dt", "Bm", "Cm")):
        assert np.isfinite(g).all(), what
        _close(g, w, KERNEL_TOL, f"d{what} vs the recurrence")
    jy, jS = jmamba.ssd_chunked(*map(jnp.asarray, arrays), 64)
    jgrad = _ssd_grads(functools.partial(jmamba.ssd_chunked, chunk=64),
                       arrays, "jax")
    assert np.isfinite(np.asarray(jy)).all() == (steep < 177)
    assert [np.isfinite(g).all() for g in jgrad] == \
        [steep < 177] * 2 + [steep < 88.7] * 2
    if steep < 177:
        _close(y, jy, KERNEL_TOL, "y vs JAX")
        _close(S, jS, KERNEL_TOL, "state vs JAX")
    for g, j, what in zip(got, jgrad, ("x", "dt", "Bm", "Cm")):
        if np.isfinite(j).all():
            _close(g, j, KERNEL_TOL, f"d{what} vs JAX")


def test_ssd_step_matches_jax():
    x, dt, A, Bm, Cm, state = _ssd_case(3, 2, 1, 4, 8, 16)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], state)
    y, S = tmamba.ssd_step(*map(torch.from_numpy, args))
    jy, jS = jmamba.ssd_step(*map(jnp.asarray, args))
    _close(y, jy, KERNEL_TOL, "y")
    _close(S, jS, KERNEL_TOL, "state")


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["full", "step"])
def test_causal_conv_matches_jax(form):
    _, _, jlp, tlp = _layer()
    rng = np.random.default_rng(4)
    ch, d_conv = tlp["conv_x_w"].shape
    T = 20 if form == "full" else 1
    u = rng.standard_normal((2, T, ch)).astype(np.float32)
    st = rng.standard_normal((2, ch, d_conv - 1)).astype(np.float32)
    w, b = tlp["conv_x_w"], torch.randn(ch, generator=torch.Generator()
                                        .manual_seed(0))
    if form == "full":
        got = tmamba._causal_conv(torch.from_numpy(u), torch.from_numpy(st),
                                  w, b, d_conv, T)
        want = jmamba._causal_conv(jnp.asarray(u), jnp.asarray(st),
                                   jnp.asarray(w.numpy()),
                                   jnp.asarray(b.numpy()), d_conv, T)
    else:
        got = tmamba._causal_conv_step(torch.from_numpy(u[:, 0]),
                                       torch.from_numpy(st), w, b)
        want = jmamba._causal_conv_step(jnp.asarray(u[:, 0]),
                                        jnp.asarray(st),
                                        jnp.asarray(w.numpy()),
                                        jnp.asarray(b.numpy()))
    for g, j, what in zip(got, want, ("out", "state")):
        assert tuple(g.shape) == tuple(j.shape), what
        _close(g, j, KERNEL_TOL, what)


@pytest.mark.parametrize("form,T", [("full", 32), ("full", 16),
                                    ("full", 8), ("step", 1)])
def test_mamba_block_matches_jax(form, T):
    cfg, jcfg, jlp, tlp = _layer()
    rng = np.random.default_rng(5 + T)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    js = jmamba.state_zeros(jcfg, 1, 2, jnp.float32)
    conv = rng.standard_normal(js.conv.shape[1:]).astype(np.float32)
    ssm = (rng.standard_normal(js.ssm.shape[1:]) * 0.3).astype(np.float32)
    if form == "full":
        got = tmamba.mamba_block_full(cfg, tlp, torch.from_numpy(x),
                                      torch.from_numpy(conv),
                                      torch.from_numpy(ssm))
        want = jax.jit(functools.partial(jmamba.mamba_block_full, jcfg))(
            jlp, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm))
    else:
        got = tmamba.mamba_block_step(cfg, tlp, torch.from_numpy(x[:, 0]),
                                      torch.from_numpy(conv),
                                      torch.from_numpy(ssm))
        want = jax.jit(functools.partial(jmamba.mamba_block_step, jcfg))(
            jlp, jnp.asarray(x[:, 0]), jnp.asarray(conv), jnp.asarray(ssm))
    (out, (nc, ns)), (jout, (jnc, jns)) = got, want
    assert ns.dtype == F32
    for g, j, what in ((out, jout, "out"), (nc, jnc, "conv"),
                       (ns, jns, "ssm")):
        assert tuple(g.shape) == tuple(j.shape), what
        _close(g, j, KERNEL_TOL, what)


def test_ragged_T_raises():
    """The chunk is min(chunk_size, T) and must divide T: JAX asserts, the
    port raises ValueError."""
    cfg, jcfg, jp, tp = _load()
    toks = np.ones((1, 24), np.int32)
    with pytest.raises(AssertionError):
        jzamba.zamba_forward(jcfg, jp, jnp.asarray(toks))
    with pytest.raises(ValueError, match="multiple"):
        tzamba.zamba_forward(cfg, tp, torch.from_numpy(toks))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_shared_positions_and_segments_match_jax():
    for over in ({}, dict(n_layers=6), dict(n_layers=9),
                 dict(shared_attn_every=1)):
        cfg = get_config(ARCH).reduced(**over)
        jcfg = jget_config(ARCH).reduced(**over)
        spos = tzamba.shared_positions(cfg)
        assert spos == jzamba.shared_positions(jcfg)
        assert tzamba._segments(cfg, spos) == jzamba._segments(jcfg, spos)
    full = get_config(ARCH)
    assert len(tzamba.shared_positions(full)) == 6
    assert tzamba._segments(full, tzamba.shared_positions(full))[-1] == \
        (36, 38)


def _pad(cache, jcache, cfg, jcfg, max_len):
    """Prefill caches (exactly as long as the prompt) copied into caches of
    ``max_len``, so a decode write has room."""
    T = cache.k.shape[2]
    tc = tzoo.cache_zeros(cfg, cache.k.shape[1], max_len, F32,
                          device="cpu")
    tc.k[:, :, :T], tc.v[:, :, :T] = cache.k, cache.v
    tc.mamba = cache.mamba
    jc = jzoo.cache_zeros(jcfg, cache.k.shape[1], max_len, jnp.float32)
    jc = dataclasses.replace(jc, mamba=jcache.mamba,
                             k=jc.k.at[:, :, :T].set(jcache.k),
                             v=jc.v.at[:, :, :T].set(jcache.v))
    return tc, jc


@pytest.mark.parametrize("T", [32, 16, 8])
def test_zamba_model_matches_jax(T):
    """forward, prefill (logits and every cache field) and two decode
    steps from the padded cache, through model_zoo."""
    cfg, jcfg, jp, tp = _load()
    toks = np.random.default_rng(T).integers(0, cfg.vocab_size, (2, T)) \
        .astype(np.int32)
    bt, bj = {"tokens": torch.from_numpy(toks)}, {"tokens": jnp.asarray(toks)}
    _close(tzoo.forward(cfg, tp, bt), _jit("forward")(jp, bj), MODEL_TOL,
           "forward")
    tlast, tcache = tzoo.prefill(cfg, tp, bt)
    jlast, jcache = _jit("prefill")(jp, bj)
    _close(tlast, jlast, MODEL_TOL, "prefill logits")
    _cache_close(tcache, jcache, "prefill")
    tc, jc = _pad(tcache, jcache, cfg, jcfg, T + 4)
    nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    for step in range(2):
        pos = np.full((2,), T + step, np.int32)
        tl, tc = tzoo.decode(cfg, tp, tc, torch.from_numpy(nxt),
                             torch.from_numpy(pos))
        jl, jc = _jit("decode")(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        _close(tl, jl, MODEL_TOL, f"decode {step} logits")
        _cache_close(tc, jc, f"decode {step}")
        assert np.argmax(_np(tl), -1).tolist() == \
            np.argmax(np.asarray(jl), -1).tolist()
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)


def test_prefill_then_decode_matches_forward():
    """prefill(S) then teacher-forced decode steps give the logits of one
    forward over the whole sequence at every decoded position (the chunked
    SSD against its one-step recurrence), within chip_smoke.py's limit for
    the full-width check, 1e-3 of the largest logit, the same argmax."""
    cfg, _, _, tp = _load()
    S, D = 16, 16
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, S + D)).astype(np.int32))
    want = tzoo.forward(cfg, tp, {"tokens": toks})
    last, cache = tzoo.prefill(cfg, tp, {"tokens": toks[:, :S]})
    tc = tzoo.cache_zeros(cfg, 2, S + D, F32, device="cpu")
    tc.k[:, :, :S], tc.v[:, :, :S], tc.mamba = cache.k, cache.v, cache.mamba
    got = [last]
    for i in range(D - 1):
        lg, tc = tzoo.decode(cfg, tp, tc, toks[:, S + i],
                             torch.full((2,), S + i, dtype=torch.int32))
        got.append(lg)
    got = torch.stack(got, 1)
    _close(got, want[:, S - 1:S + D - 1], DECODE_TOL, "decode vs forward")
    assert torch.equal(got.argmax(-1), want[:, S - 1:S + D - 1].argmax(-1))


def test_decode_past_the_cache_end_raises():
    """A prefill cache is exactly as long as the prompt. JAX's decode at
    position T drops the K/V write (``.at[].set`` out of range) and
    attends without the new key; the port raises, so a caller pads the
    cache first (ROADMAP.md section 3)."""
    cfg, _, jp, tp = _load()
    toks = np.ones((1, 16), np.int32)
    _, tcache = tzoo.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)})
    _, jcache = _jit("prefill")(jp, {"tokens": jnp.asarray(toks)})
    jl, _ = _jit("decode")(jp, jcache, jnp.ones((1,), jnp.int32),
                           jnp.full((1,), 16, jnp.int32))
    assert np.isfinite(np.asarray(jl)).all()
    with pytest.raises(IndexError):
        tzoo.decode(cfg, tp, tcache, torch.ones(1, dtype=torch.int32),
                    torch.full((1,), 16, dtype=torch.int32))


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_init_zamba_and_cache_specs_match_jax(dtype, jdtype):
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    want = jax.eval_shape(lambda k: jzoo.init(jcfg, k, jdtype),
                          jax.random.PRNGKey(0))
    got = tzoo.init(cfg, 0, dtype, device="cpu")
    flat_j = {jax.tree_util.keystr(p): s for p, s in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_t = {jax.tree_util.keystr(p): t for p, t in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_t.keys() == flat_j.keys()
    for key, spec in flat_j.items():
        t = flat_t[key]
        assert tuple(t.shape) == tuple(spec.shape), key
        assert str(t.dtype)[6:] == str(spec.dtype), key
        assert torch.isfinite(t.float()).all(), key
    layers = got["mamba_layers"]
    assert torch.equal(layers["A_log"][0], layers["A_log"][-1])
    assert float(layers["dt_bias"][0, 0]) == -4.0
    ts, js = tzoo.cache_specs(cfg, 3, 48, dtype), \
        jzoo.cache_specs(jcfg, 3, 48, jdtype)
    tz = tzoo.cache_zeros(cfg, 3, 48, dtype, device="cpu")
    jf = dict(_fields(js))
    for (name, spec), (_, zero) in zip(_fields(ts), _fields(tz)):
        assert tuple(spec.shape) == tuple(jf[name].shape), name
        assert str(spec.dtype)[6:] == str(jf[name].dtype), name
        assert zero.shape == spec.shape and zero.dtype == spec.dtype
        assert not zero.any()
    assert ts.mamba.ssm.dtype == F32


def test_convert_keeps_leaf_dtypes():
    """A bf16 JAX tree carries across leaf for leaf, dtype and bits: the
    stacked ``mamba_layers`` and the ``shared`` block, with ``A_log``,
    ``dt_bias``, ``D_skip`` and ``gn_scale`` f32."""
    _, jcfg, _, _ = _load()
    tree = jax.tree.map(np.array,
                        _jit("init", jnp.bfloat16)(jax.random.PRNGKey(0)))
    got = params_from_numpy(tree, dtype=torch.bfloat16)
    leaves_t = dict((jax.tree_util.keystr(p), t) for p, t in
                    jax.tree_util.tree_flatten_with_path(got)[0])
    for path, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        t = leaves_t[jax.tree_util.keystr(path)]
        assert str(t.dtype)[6:] == str(arr.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(arr, np.float32))
    for name in ("A_log", "dt_bias", "D_skip", "gn_scale"):
        assert got["mamba_layers"][name].dtype == F32
    assert got["mamba_layers"]["w_x"].dtype == torch.bfloat16
    assert got["shared"]["attn"]["wq"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(cfg, seed, B=2, S=32):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "targets")}


def test_train_loss_and_grads_match_jax():
    cfg, jcfg, jp, tp = _load()
    batch = _batch(cfg, 4)

    def loss(p):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return jsteps.cross_entropy(jzoo.forward(jcfg, p, jb, pctx=None),
                                    jb["targets"])
    jl, jg = jax.jit(jax.value_and_grad(loss))(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tg = tsteps.loss_and_grads(cfg, tp, tb, remat=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    leaves = topt.tree_leaves(tg)
    assert len(flat) == len(leaves)
    for (path, a), b in zip(flat, leaves):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == F32, path
        scale = np.abs(a).max()
        err = np.abs(_np(b) - a).max()
        assert scale > 0 and err <= MODEL_TOL * scale, \
            (jax.tree_util.keystr(path), err, scale)
    assert all(not p.requires_grad and p.grad is None
               for p in topt.tree_leaves(tp))


def test_remat_equals_no_remat():
    cfg, _, _, tp = _load()
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5).items()}
    la, ga = tsteps.loss_and_grads(cfg, tp, tb, remat=False)
    lb, gb = tsteps.loss_and_grads(cfg, tp, tb, remat=True)
    assert torch.equal(la, lb)
    for a, b in zip(topt.tree_leaves(ga), topt.tree_leaves(gb)):
        assert torch.equal(a, b)


def test_trainer_runs_on_the_cpu():
    """``launch.train.train`` takes zamba2-1.2b: finite losses, the
    params moved."""
    losses, params = train("zamba2-1.2b", steps=2, seq_len=32, batch=2,
                           device="cpu", verbose=False)
    assert len(losses) == 2 and np.isfinite(losses).all()
    fresh = tzoo.init(get_config("zamba2-1.2b").reduced(), 0, F32, device="cpu")
    assert not torch.equal(params["embed"], fresh["embed"])
