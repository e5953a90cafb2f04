"""The port's rwkv6 family and WKV6 recurrence on the CPU against the JAX
package.

On a CPU tensor ``repro_torch.kernels.wkv6`` runs its plain version, so
these tests hold ``wkv6_ref`` against ``repro.kernels.ref.wkv6_ref``
(1e-5) and against the Pallas ``wkv6`` in interpret mode (5e-4, the JAX
tests' own tolerance) over the sweeps of ``test_wkv6_shapes``, the strong
decay case and T = 1; the port's ``wkv6_chunked``/``wkv6_step`` against
JAX's; and the model functions of ``rwkv6-1.6b`` ``.reduced()`` (weights
from ``repro.models.model_zoo.init``, carried across by
``repro_torch.models.convert``) against JAX's in float32.

Model tolerance: 1e-4 times the compared tensor's largest magnitude (at
least 1). The wkv state reaches ~50 and the logits ~5, and the per-head
group norm amplifies f32 rounding where a head's output has little
variance (the first step, whose state is zero), so an absolute 1e-4 would
ask for agreement below what XLA and ATen, summing in other orders, give
on the same weights; the layer functions themselves agree to ~2e-6 on the
same inputs. The Hopper kernel runs only on the card, where
``chip_smoke.py`` holds it against the same plain version.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro.models import model_zoo as jzoo
from repro.models import rwkv6 as jrwkv
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-1.6b"
MODEL_TOL = 1e-4
STATE_FIELDS = ("att_shift", "ffn_shift", "wkv")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_scaled(got, want, what=""):
    want = _np(want)
    tol = MODEL_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0, err_msg=what)


def _state_close(tstate, jstate, what=""):
    for f in STATE_FIELDS:
        _close_scaled(getattr(tstate, f), getattr(jstate, f), f"{what} {f}")


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

def _wkv_case(seed, B, T, H, K):
    """The distributions of tests/test_kernels.py's test_wkv6_shapes."""
    rng = np.random.default_rng(seed)
    n = (lambda *s: rng.standard_normal(s).astype(np.float32))
    r, k, v = (n(B, T, H, K) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(n(B, T, H, K) * 0.5 - 1.0)).astype(np.float32)
    return r, k, v, w, n(H, K) * 0.3, n(B, H, K, K) * 0.1


def _strong_decay_case(B=1, T=64, H=2, K=32):
    f = (lambda val, *s: np.full(s, val, np.float32))
    return (f(0.3, B, T, H, K), f(0.3, B, T, H, K), f(1.0, B, T, H, K),
            f(0.25, B, T, H, K), f(0.0, H, K), f(0.0, B, H, K, K))


# (B, T, H, K, chunk): test_wkv6_shapes, then the strong-decay case and a
# single decode step
WKV_CASES = [(2, 64, 2, 32, 32), (1, 128, 4, 64, 32), (2, 96, 1, 64, 16),
             (1, 32, 2, 32, 8), "strong", (2, 1, 2, 32, 32)]


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv6_ref_matches_jax(case):
    if case == "strong":
        arrays, chunk = _strong_decay_case(), 32
    else:
        B, T, H, K, chunk = case
        arrays = _wkv_case(B * 100 + T, B, T, H, K)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    o, sT = tref.wkv6_ref(*t)
    o_j, s_j = jref.wkv6_ref(*j)
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(sT), np.asarray(s_j), atol=1e-5,
                               rtol=1e-5)
    o_p, s_p = jwkv6(*j, chunk=chunk)          # Pallas, interpret mode
    assert np.isfinite(np.asarray(o_p)).all()
    np.testing.assert_allclose(_np(o), np.asarray(o_p), atol=5e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(sT), np.asarray(s_p), atol=5e-4,
                               rtol=1e-4)
    # the wrapper on CPU tensors is the plain version, launching nothing
    before = wkv_mod.wkv6.launches
    o2, s2 = tops.wkv(*t, chunk=chunk)
    assert wkv_mod.wkv6.launches == before
    assert torch.equal(o2, o) and torch.equal(s2, sT)
    assert o2.dtype == s2.dtype == torch.float32


def test_wkv6_chunked_and_step_match_jax():
    """Mirrors test_model_chunked_wkv_matches_ref (B 2, T 96, H 2, K 32,
    chunk 16), then one wkv6_step from the chunked form's final state."""
    rng = np.random.default_rng(5)
    B, T, H, K = 2, 96, 2, 32
    n = (lambda *s: rng.standard_normal(s).astype(np.float32))
    r, k, v = (n(B, T, H, K) * 0.4 for _ in range(3))
    w = np.exp(-np.exp(n(B, T, H, K) * 0.3 - 1.5)).astype(np.float32)
    u = n(H, K) * 0.2
    s0 = np.zeros((B, H, K, K), np.float32)
    arrays = (r, k, v, w, u, s0)
    o_t, s_t = trwkv.wkv6_chunked(*(torch.from_numpy(a) for a in arrays),
                                  chunk=16)
    o_j, s_j = jrwkv.wkv6_chunked(*(jnp.asarray(a) for a in arrays),
                                  chunk=16)
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(s_t), np.asarray(s_j), atol=1e-5,
                               rtol=1e-5)
    o_r, s_r = jref.wkv6_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_np(o_t), np.asarray(o_r), atol=5e-4)
    np.testing.assert_allclose(_np(s_t), np.asarray(s_r), atol=5e-4)
    step = [a[:, 0] for a in (r, k, v, w)]
    o1, s1 = trwkv.wkv6_step(*(torch.from_numpy(a) for a in step),
                             torch.from_numpy(u), s_t)
    o1_j, s1_j = jrwkv.wkv6_step(*(jnp.asarray(a) for a in step),
                                 jnp.asarray(u), s_j)
    np.testing.assert_allclose(_np(o1), np.asarray(o1_j), atol=1e-4)
    np.testing.assert_allclose(_np(s1), np.asarray(s1_j), atol=1e-4)


def test_wkv6_wrapper_contract():
    """The reference's length contract holds on every device; a device
    without a kernel raises instead of falling back."""
    arrays = [torch.from_numpy(a) for a in _wkv_case(1, 1, 48, 2, 32)]
    with pytest.raises(ValueError, match="multiple"):
        tops.wkv(*arrays, chunk=32)
    tops.wkv(*arrays, chunk=16)                  # 48 = 3 x 16 is fine
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(ValueError, match="no kernel"):
        tops.wkv(*meta, chunk=16)


# ---------------------------------------------------------------------------
# the Hopper kernel's blocking (csrc/wkv6.cu), modelled in torch
# ---------------------------------------------------------------------------

CHUNK, SUB, MAX_SPAN = 32, 16, 60.0     # the kernel's kC, kSub, kMaxSpan


def _blocked_wkv6(r, k, v, w, u, state):
    """The chunked kernel's arithmetic in f32, as a model of its range
    design: chunks of 32 steps (a tail chunk padded with log w = 0 and
    r = k = v = 0), per channel a reference point for the decayed r k^T,
    the chunk's log-decay midpoint while it spans at most 60 and else the
    end of the first 16-step sub-block, and per-pair weights on the two
    diagonal sub-blocks of a chunk with any steeper channel. Returns
    (o, final state, number of chunks that took the per-pair branch)."""
    f = torch.float32
    r, k, v = (x.to(f).permute(0, 2, 1, 3) for x in (r, k, v))
    lw = torch.log(torch.clamp(w.to(f), 1e-12, 1.0)).permute(0, 2, 1, 3)
    B, H, T, K = r.shape
    pad = -T % CHUNK
    r, k, v, lw = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                   for x in (r, k, v, lw))
    u, S = u.to(f), state.to(f).clone()
    t_idx = torch.arange(CHUNK)
    below = t_idx[None, :] < t_idx[:, None]             # s < t
    sub = t_idx // SUB
    same = sub[:, None] == sub[None, :]
    outs, pairs = [], 0
    for c0 in range(0, T + pad, CHUNK):
        rc, kc, vc, lc = (x[:, :, c0:c0 + CHUNK] for x in (r, k, v, lw))
        L = torch.cumsum(lc, dim=2)                       # inclusive
        Lp = L - lc                                       # L_{t-1}
        tot, le = L[:, :, -1:], L[:, :, SUB - 1:SUB]
        steep = -tot > MAX_SPAN
        ref = torch.where(steep, le, 0.5 * tot)
        first = (t_idx < SUB)[None, None, :, None]
        # a steep channel's factors only where they are <= 1: rows of
        # sub-block 1, keys of sub-block 0
        qx = torch.where(steep & first, 0.0, rc * torch.exp(Lp - ref))
        kx = torch.where(steep & ~first, 0.0, kc * torch.exp(ref - L))
        att = qx @ kx.transpose(-1, -2)
        pair = steep.any(-1, keepdim=True)                # (B, H, 1, 1)
        if pair.any():
            pairs += 1
            expo = torch.where(below[..., None], Lp[:, :, :, None] -
                               L[:, :, None], -torch.inf)  # (B,H,t,s,K)
            direct = (rc[:, :, :, None] * kc[:, :, None] *
                      torch.exp(expo)).sum(-1)
            att = torch.where(pair & same, direct, att)
        bonus = (rc * u[None, :, None] * kc).sum(-1)
        att = torch.where(below, att, 0.0) + torch.diag_embed(bonus)
        outs.append(rc * torch.exp(Lp) @ S + att @ vc)
        S = torch.exp(tot).transpose(-1, -2) * S + \
            (kc * torch.exp(tot - L)).transpose(-1, -2) @ vc
    o = torch.cat(outs, dim=2)[:, :, :T].permute(0, 2, 1, 3)
    return o, S, pairs


def _extreme_case(kind, B=2, T=64, H=2, K=32, seed=3):
    """Test-distribution r/k/v/u/state with w = 1e-12, w per channel from
    {1e-12, 1}, w = 1e-12 on the first 24 steps of every 32 and 1 after
    (a steep chunk whose log-decay midpoint is not the sub-block edge), or
    w = 1e-3 (where the TPU kernel's half-chunk centring overflows at
    chunk 32)."""
    r, k, v, _, u, s0 = _wkv_case(seed, B, T, H, K)
    if kind == "channels":
        pick = np.random.default_rng(seed).random((1, 1, H, K)) < 0.5
        w = np.broadcast_to(np.where(pick, 1e-12, 1.0), (B, T, H, K))
    elif kind == "front":
        front = (np.arange(T) % 32 < 24)[None, :, None, None]
        w = np.broadcast_to(np.where(front, 1e-12, 1.0), (B, T, H, K))
    else:
        w = np.full((B, T, H, K), float(kind))
    return r, k, v, np.ascontiguousarray(w, np.float32), u, s0


def _against_jax(arrays, atol=5e-4, rtol=1e-4):
    o, s, pairs = _blocked_wkv6(*(torch.from_numpy(a) for a in arrays))
    o_j, s_j = jref.wkv6_ref(*(jnp.asarray(a) for a in arrays))
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(s), np.asarray(s_j), atol=atol, rtol=rtol)
    return pairs


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_blocked_model_matches_jax(case):
    """The kernel's blocking against JAX's sequential oracle on the sweeps
    of test_wkv6_shapes, the strong decay and a single step."""
    if case == "strong":
        arrays = _strong_decay_case()
    else:
        B, T, H, K, _ = case
        arrays = _wkv_case(B * 100 + T, B, T, H, K)
    assert _against_jax(arrays) == 0          # no chunk is steep here


@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("kind", ["1e-12", "channels", "front", "1e-3"])
def test_blocked_model_extreme_decay(kind, K):
    """Finite and within 5e-4 over the clipped range, through the per-pair
    branch of the diagonal sub-blocks."""
    assert _against_jax(_extreme_case(kind, K=K), rtol=0) == 2


# (B, T, H, K): tails of the 32-step chunk (shorter and longer than a
# sub-block), and T between 2 and 32
@pytest.mark.parametrize("shape", [(1, 48, 2, 32), (2, 80, 1, 64),
                                   (1, 40, 2, 32), (2, 7, 2, 32),
                                   (1, 17, 1, 64), (2, 2, 1, 32)], ids=str)
def test_blocked_model_tail_chunks(shape):
    assert _against_jax(_wkv_case(sum(shape), *shape)) == 0


def test_blocked_model_mild_at_the_model_clip():
    """The model clips w to exp(-exp(0.35)) from below: 32 such steps sum
    to 45.4 in log, inside the centred range, so no chunk of the served
    path takes the per-pair branch."""
    r, k, v, _, u, s0 = _wkv_case(9, 1, 64, 2, 32)
    w = np.full(r.shape, np.exp(-np.exp(0.35)), np.float32)
    assert 32 * np.exp(0.35) < MAX_SPAN
    assert _against_jax((r, k, v, w, u, s0)) == 0
    w[:, :32] = 0.05                     # 32 x 3.0: past the centred range
    assert _against_jax((r, k, v, w, u, s0)) == 1


def test_wkv6_wrapper_finite_at_the_decay_floor():
    """On CPU tensors the wrapper's plain version stays finite at
    w = 1e-12 (the clip floor) and matches JAX's oracle."""
    arrays = _extreme_case("1e-12", T=96)
    o, s = tops.wkv(*(torch.from_numpy(a) for a in arrays), chunk=32)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    o_j, s_j = jref.wkv6_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_np(o), np.asarray(o_j), atol=5e-4)
    np.testing.assert_allclose(_np(s), np.asarray(s_j), atol=5e-4)


def test_wkv6_check_alignment():
    """The chunked kernel copies rows 16 bytes at a time: for T >= 2 every
    row must start 16-byte aligned (the main path's contiguous and
    (B, H, T, K)-transposed layouts do); a decode step reads scalars."""
    B, T, H, K = 2, 64, 2, 32
    t = [torch.from_numpy(a) for a in _wkv_case(4, B, T, H, K)]
    wkv_mod._check(*t)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in t[:4]]
    wkv_mod._check(*views, *t[4:])
    bf = [x.to(torch.bfloat16) for x in t[:3]]
    wkv_mod._check(*bf, *t[3:])
    shifted = torch.empty(B * T * H * K + 1)[1:].view(B, T, H, K)
    shifted.copy_(t[0])
    with pytest.raises(ValueError, match="16-byte"):
        wkv_mod._check(shifted, *t[1:])
    odd = torch.empty(B, T, H, K + 1, dtype=torch.bfloat16)[..., :K]
    with pytest.raises(ValueError, match="16-byte"):
        wkv_mod._check(*bf[:2], odd, *t[3:])
    step = [x[:, :1] for x in (shifted, *t[1:4])]
    wkv_mod._check(*step, *t[4:])                # T = 1: scalar reads
    s_odd = torch.empty(B * H * K * K + 1)[1:].view(B, H, K, K)
    with pytest.raises(ValueError, match="16-byte aligned state"):
        wkv_mod._check(*t[:5], s_odd)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _load(arch):
    """(cfg, jcfg, JAX f32 params, the port's copy); shared, not mutated."""
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    jparams = jzoo.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, jcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _load(ARCH)


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, 512, (2, 64)).astype(np.int32)


def test_rwkv_forward_prefill_decode_match_jax(model, prompt):
    cfg, jcfg, jp, tp = model
    tok_t = torch.from_numpy(prompt)
    jl, js = jrwkv.rwkv_forward(jcfg, jp, jnp.asarray(prompt),
                                return_state=True)
    tl, ts = trwkv.rwkv_forward(cfg, tp, tok_t, return_state=True)
    assert tl.dtype == torch.float32 and tl.shape == (2, 64, cfg.vocab_size)
    _close_scaled(tl, jl, "forward logits")
    _state_close(ts, js, "forward")
    tlast, ts = trwkv.rwkv_prefill(cfg, tp, tok_t)
    jlast, js = jrwkv.rwkv_prefill(jcfg, jp, jnp.asarray(prompt))
    _close_scaled(tlast, jlast, "prefill logits")
    _state_close(ts, js, "prefill")
    for step in range(3):
        nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)
        assert torch.argmax(tlast, -1).tolist() == nxt.tolist()
        pos = np.full((2,), 64 + step, np.int32)
        tlast, ts = trwkv.rwkv_decode(cfg, tp, ts, torch.from_numpy(nxt),
                                      torch.from_numpy(pos))
        jlast, js = jrwkv.rwkv_decode(jcfg, jp, js, jnp.asarray(nxt),
                                      jnp.asarray(pos))
        _close_scaled(tlast, jlast, f"decode {step} logits")
        _state_close(ts, js, f"decode {step}")


def test_incremental_decode_matches_teacher_forced_forward(model, prompt):
    """Prefill 32 tokens, then feed the rest one decode step at a time and
    once as a resumed 32-token forward: both reproduce the port's own
    forward over the whole 64 tokens."""
    cfg, _, _, tp = model
    toks = torch.from_numpy(prompt)
    full = trwkv.rwkv_forward(cfg, tp, toks)
    last, st = trwkv.rwkv_prefill(cfg, tp, toks[:, :32])
    _close_scaled(last, full[:, 31])
    resumed, _ = trwkv.rwkv_forward(cfg, tp, toks[:, 32:], state=st,
                                    return_state=True)
    _close_scaled(resumed, full[:, 32:], "resumed forward")
    for t in range(32, 40):
        last, st = trwkv.rwkv_decode(cfg, tp, st, toks[:, t])
        _close_scaled(last, full[:, t], f"decode at {t}")


@pytest.mark.parametrize("T", [16, 32, 64, 48])
def test_length_contract(model, prompt, T):
    """JAX's prefill takes T <= 32 or a multiple of 32; at T = 48 its
    wkv6_chunked fails to reshape, and the port raises ValueError."""
    cfg, jcfg, jp, tp = model
    toks = prompt[:, :T]
    if T == 48:
        with pytest.raises(TypeError):
            jrwkv.rwkv_prefill(jcfg, jp, jnp.asarray(toks))
        with pytest.raises(ValueError, match="multiple"):
            trwkv.rwkv_prefill(cfg, tp, torch.from_numpy(toks))
        return
    tlast, ts = trwkv.rwkv_prefill(cfg, tp, torch.from_numpy(toks))
    assert tlast.shape == (2, cfg.vocab_size)
    assert torch.isfinite(tlast).all()
    assert ts.wkv.shape == (cfg.n_layers, 2, 4, 32, 32)


# ---------------------------------------------------------------------------
# model_zoo, init, convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", ARCH])
def test_model_zoo_dispatch_matches_jax(arch):
    cfg, jcfg, jp, tp = _load(arch)
    toks = np.random.default_rng(2).integers(0, 512, (2, 32)).astype(
        np.int32)
    batch_t, batch_j = {"tokens": torch.from_numpy(toks)}, \
        {"tokens": jnp.asarray(toks)}
    _close_scaled(tzoo.forward(cfg, tp, batch_t),
                  jzoo.forward(jcfg, jp, batch_j), f"{arch} forward")
    tlast, tcache = tzoo.prefill(cfg, tp, batch_t)
    jlast, jcache = jzoo.prefill(jcfg, jp, batch_j)
    _close_scaled(tlast, jlast, f"{arch} prefill")
    if arch == ARCH:
        nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)
        pos = np.full((2,), 32, np.int32)
        tl, tcache = tzoo.decode(cfg, tp, tcache, torch.from_numpy(nxt),
                                 torch.from_numpy(pos))
        jl, jcache = jzoo.decode(jcfg, jp, jcache, jnp.asarray(nxt),
                                 jnp.asarray(pos))
        _close_scaled(tl, jl, f"{arch} decode")
        _state_close(tcache, jcache, arch)
    else:
        # a dense decode writes at its position: give it room
        tc = tzoo.cache_zeros(cfg, 2, 40, torch.float32, device="cpu")
        jc = jzoo.cache_zeros(jcfg, 2, 40, jnp.float32)
        tc.k[:, :, :32], tc.v[:, :, :32] = tcache.k, tcache.v
        jc.k = jc.k.at[:, :, :32].set(jcache.k)
        jc.v = jc.v.at[:, :, :32].set(jcache.v)
        nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)
        pos = np.full((2,), 32, np.int32)
        tl, _ = tzoo.decode(cfg, tp, tc, torch.from_numpy(nxt),
                            torch.from_numpy(pos))
        jl, _ = jzoo.decode(jcfg, jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        _close_scaled(tl, jl, f"{arch} decode")
    # cache specs: the same fields, shapes and dtypes as JAX's
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        ts_ = tzoo.cache_specs(cfg, 3, 48, dt)
        js_ = jzoo.cache_specs(jcfg, 3, 48, jdt)
        tz = tzoo.cache_zeros(cfg, 3, 48, dt, device="cpu")
        for name, spec in vars(ts_).items():
            jspec = getattr(js_, name)
            assert tuple(spec.shape) == tuple(jspec.shape), name
            assert str(spec.dtype)[6:] == str(jspec.dtype), name
            zero = getattr(tz, name)
            assert zero.shape == spec.shape and zero.dtype == spec.dtype
            assert not zero.any()


def test_model_zoo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        tzoo.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tzoo.cache_zeros(cfg, 1, 16)


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_init_rwkv_shapes_and_dtypes_match_jax(dtype, jdtype):
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
    assert got["layers"]["u"].dtype == torch.float32
    assert torch.isfinite(got["lm_head"].float()).all()


@pytest.mark.parametrize("arch", [ARCH, "llama3.2-1b"])
def test_convert_keeps_leaf_dtypes(arch):
    """A bf16 JAX tree converts leaf for leaf, dtype and bits (rwkv6's f32
    u, w_base and ln_x_scale stay f32); an f32 tree gives the plain
    torch.from_numpy tensors the converter always gave."""
    _, jcfg, jp32, _ = _load(arch)
    trees = {}
    for jdtype, dtype in ((jnp.bfloat16, torch.bfloat16),
                          (jnp.float32, torch.float32)):
        jp = jp32 if jdtype == jnp.float32 else \
            jzoo.init(jcfg, jax.random.PRNGKey(0), jdtype)
        tree = trees[dtype] = jax.tree.map(np.array, jp)
        got = params_from_numpy(tree, dtype=dtype)
        leaves_j = jax.tree_util.tree_flatten_with_path(tree)[0]
        leaves_t = dict((jax.tree_util.keystr(p), t) for p, t in
                        jax.tree_util.tree_flatten_with_path(got)[0])
        for path, arr in leaves_j:
            t = leaves_t[jax.tree_util.keystr(path)]
            assert str(t.dtype)[6:] == str(arr.dtype), path
            if jdtype == jnp.float32:
                assert torch.equal(t, torch.from_numpy(arr))
            else:
                np.testing.assert_array_equal(
                    t.float().numpy(), np.asarray(arr, np.float32))
        if arch == ARCH and jdtype == jnp.bfloat16:
            for name in ("u", "w_base", "ln_x_scale"):
                assert got["layers"][name].dtype == torch.float32
            assert got["layers"]["wr"].dtype == torch.bfloat16
    with pytest.raises(TypeError, match="model dtype"):
        params_from_numpy(trees[torch.bfloat16], dtype=torch.float32)


_BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked in the port")
        return None
sys.meta_path.insert(0, _Block())
import repro_torch.models.rwkv6
import repro_torch.models.model_zoo
import repro_torch.kernels.wkv6
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""


def test_rwkv_modules_import_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
