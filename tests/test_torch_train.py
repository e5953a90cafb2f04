"""The port's training path on the CPU against the JAX package.

- ``lr_at``, ``global_norm`` and ``adamw_update`` against JAX's on the same
  numpy param and gradient trees (identical gradients each step: Adam's
  first steps are sign-like, so gradients that differ by rounding would
  say nothing), over warmup, decay and clipped steps: the f32 moments and
  float32 params within rtol 1e-5 (atol 1e-7), bfloat16 params within 2
  ulp of bf16 (2^-6 of the value: a value on a rounding boundary may
  round either way, and then carries the flip).
- ``cross_entropy`` and ``chunked_cross_entropy`` against JAX's and each
  other: rtol 1e-5.
- The train loss and every gradient leaf against ``jax.value_and_grad`` of
  ``cross_entropy(model_zoo.forward(cfg, p, batch, pctx=None))``, built
  here, on llama3.2-1b, gemma2-27b, granite-moe-3b-a800m, rwkv6-1.6b and
  llava-next-34b (with ``embeds``) ``.reduced()``: loss within rtol 1e-5;
  each leaf within 1e-4 of its largest magnitude (measured ≈ 3e-6), rwkv6
  within 2e-3 (measured ≈ 6e-4: its random-init backward grows the
  gradient ≈ 200x over the 4 layers, and XLA's and ATen's summation
  orders already part the logits by ≈ 7e-5 of their magnitude; the port's
  chunked or sequential WKV changes it by < 2e-5).
- ``lm_forward`` with given ``positions`` (rows shifted by 5, through the
  plain ``layers.attention``) against JAX's on gemma2-27b ``.reduced()``
  (1e-4), and against the kernel path at 0..S-1 (RoPE is relative).
- ``remat=True`` equal to ``remat=False``, exactly.
- Each autograd Function (the two kernels' and ``_ProductF32``) against
  autograd of its plain version; the kernel launches' grad guard.
- ``lm_decode_windowed`` against JAX's (1e-4) and the port's full-cache
  decode (atol 3e-4, rtol 1e-4, as tests/test_perf_opts.py).
- ``launch.train.train(..., device="cpu")``: the loss falls, and a crash
  and resume reproduces the uninterrupted run exactly (the port's
  counterparts of the two training tests of tests/test_system.py).
"""
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.distributed import steps as jsteps
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro_torch.configs.registry import get_config
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import _grad, ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import wkv6 as twkv
from repro_torch.models import layers as tL
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as topt

F32 = torch.float32


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _load(arch, **over):
    cfg, jcfg = get_config(arch).reduced(**over), \
        jget_config(arch).reduced(**over)
    jparams = jzoo.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=F32)
    return cfg, jcfg, jparams, tparams


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-2, warmup_steps=3, total_steps=10)


def test_lr_at_matches_jax():
    tcfg, jcfg = topt.OptConfig(**OPT), jopt.OptConfig(**OPT)
    for step in range(13):
        got = topt.lr_at(tcfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.lr_at(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == F32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=f"step {step}")


def _trees(rng, dtype):
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5)}, "e": (7,)}

    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return shapes, draw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Ten steps on identical gradients: warmup, cosine decay, the clip
    engaged on the large-gradient steps and not on the others."""
    rng = np.random.default_rng(0)
    _, draw = _trees(rng, dtype)
    p0 = draw(_trees(rng, dtype)[0], 1.0)
    jd, td = {"float32": (jnp.float32, F32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jd), p0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jstate, tstate = jopt.init_opt(jp), topt.init_opt(tp)
    jcfg, tcfg = jopt.OptConfig(**OPT), topt.OptConfig(**OPT)
    shapes = _trees(rng, dtype)[0]
    clipped = 0
    for step in range(10):
        g = draw(shapes, 0.5 if step % 2 else 0.05)   # gnorm > 1, < 1
        jg = jax.tree.map(jnp.asarray, g)
        tg = topt.tree_map(torch.from_numpy, g)
        jp, jstate, jm = jopt.adamw_update(jcfg, jp, jg, jstate)
        tp, tstate, tm = topt.adamw_update(tcfg, tp, tg, tstate)
        clipped += float(jm["grad_norm"]) > 1.0
        for key in ("grad_norm", "lr"):
            assert tm[key].dim() == 0
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for a, b in zip(jax.tree.leaves(jp), topt.tree_leaves(tp)):
            assert b.dtype == td
            a = np.asarray(a, np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(_np(b), a, rtol=1e-5, atol=1e-7)
            else:
                assert np.all(np.abs(_np(b) - a) <= 2 ** -6 * np.abs(a))
        for jt, tt in ((jstate.mu, tstate.mu), (jstate.nu, tstate.nu)):
            for a, b in zip(jax.tree.leaves(jt), topt.tree_leaves(tt)):
                assert b.dtype == F32
                np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-5,
                                           atol=1e-7)
    assert 0 < clipped < 10


def test_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    shapes, draw = _trees(rng, "float32")
    g = draw(shapes, 3.0)
    got = topt.global_norm(topt.tree_map(torch.from_numpy, g))
    want = jopt.global_norm(jax.tree.map(jnp.asarray, g))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 16, 64)).astype(np.float32) * 3
    tgts = rng.integers(0, 64, (2, 16)).astype(np.int32)
    got = tsteps.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(tgts))
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(tgts))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("chunk", [16, 24])     # 24 does not divide 64
def test_chunked_cross_entropy_matches_jax(chunk):
    cfg, jcfg, jparams, tparams = _load("llama3.2-1b")
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (2, 64)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    hidden = ttf.lm_forward(cfg, tparams, torch.from_numpy(toks),
                            return_hidden=True)
    logits = ttf.lm_forward(cfg, tparams, torch.from_numpy(toks))
    a = tsteps.cross_entropy(logits, torch.from_numpy(tgts))
    b = tsteps.chunked_cross_entropy(cfg, tparams, hidden,
                                     torch.from_numpy(tgts), chunk=chunk)
    jh = jtf.lm_forward(jcfg, jparams, jnp.asarray(toks), return_hidden=True)
    want = jsteps.chunked_cross_entropy(jcfg, jparams, jh, jnp.asarray(tgts),
                                        chunk=chunk)
    np.testing.assert_allclose(float(b), float(a), rtol=1e-5)
    np.testing.assert_allclose(float(b), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

GRAD_ARCHS = ["llama3.2-1b", "gemma2-27b", "granite-moe-3b-a800m",
              "rwkv6-1.6b", "llava-next-34b"]


def _batch(cfg, rng, B=2, S=32):
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S))
             .astype(np.int32),
             "targets": rng.integers(1, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.frontend == "image_patches":
        batch["embeds"] = (rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _jax_loss(jcfg, batch):
    def loss(p):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits = jzoo.forward(jcfg, p, jb, pctx=None)
        tgt = jb["targets"]
        if logits.shape[1] != tgt.shape[1]:
            tgt = jnp.pad(tgt, ((0, 0), (logits.shape[1] - tgt.shape[1], 0)))
        return jsteps.cross_entropy(logits, tgt)
    return loss


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_train_loss_and_grads_match_jax(arch):
    cfg, jcfg, jparams, tparams = _load(arch)
    batch = _batch(cfg, np.random.default_rng(4))
    jl, jg = jax.value_and_grad(_jax_loss(jcfg, batch))(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tg = tsteps.loss_and_grads(cfg, tparams, tb, remat=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    rel = 2e-3 if cfg.family == "rwkv6" else 1e-4
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    leaves = topt.tree_leaves(tg)
    assert len(flat) == len(leaves)
    for (path, a), b in zip(flat, leaves):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == F32, path
        scale = np.abs(a).max()
        err = np.abs(_np(b) - a).max()
        assert scale > 0 and err <= rel * scale, \
            (jax.tree_util.keystr(path), err, scale)
    # the parameters are left as they were: no grad, no .grad
    assert all(not p.requires_grad and p.grad is None
               for p in topt.tree_leaves(tparams))


def test_lm_forward_positions_are_not_ported():
    """Given positions (every row shifted by 5) run through the plain
    ``layers.attention``: JAX's ``lm_forward`` with the same positions
    within 1e-4, and the kernel path at 0..S-1 within 1e-4 (RoPE depends
    on the offset between positions only)."""
    cfg, jcfg, jparams, tparams = _load("gemma2-27b")
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    pos = np.broadcast_to(np.arange(5, 21, dtype=np.int32), (2, 16))
    got = ttf.lm_forward(cfg, tparams, torch.from_numpy(toks),
                         positions=torch.from_numpy(pos.copy()))
    want = jtf.lm_forward(jcfg, jparams, jnp.asarray(toks),
                          positions=jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    base = ttf.lm_forward(cfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch,chunked_ce", [("gemma2-27b", False),
                                             ("granite-moe-3b-a800m", True),
                                             ("rwkv6-1.6b", False)])
def test_remat_equals_no_remat(arch, chunked_ce):
    cfg, _, _, tparams = _load(arch)
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(cfg, np.random.default_rng(5)).items()}
    la, ga = tsteps.loss_and_grads(cfg, tparams, tb, remat=False,
                                   chunked_ce=chunked_ce)
    lb, gb = tsteps.loss_and_grads(cfg, tparams, tb, remat=True,
                                   chunked_ce=chunked_ce)
    assert torch.equal(la, lb)
    for a, b in zip(topt.tree_leaves(ga), topt.tree_leaves(gb)):
        assert torch.equal(a, b)


def test_train_step_builders():
    """One train step moves the params and the step count; the prefill and
    decode steps return int32 next tokens and the cache."""
    cfg, _, _, tparams = _load("llama3.2-1b")
    before = {k: v.clone() for k, v in tparams["layers"]["attn"].items()}
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(cfg, np.random.default_rng(6)).items()}
    step = tsteps.build_train_step(cfg, chunked_ce=True)
    params, state, m = step(tparams, topt.init_opt(tparams), tb)
    assert int(state.step) == 1 and set(m) == {"loss", "grad_norm", "lr"}
    for name, w in params["layers"]["attn"].items():
        assert not torch.equal(w, before[name]), name
    nxt, cache = tsteps.build_prefill_step(cfg)(params, tb)
    assert nxt.dtype == torch.int32 and nxt.shape == (2,)
    assert cache.k.shape[2] == 32
    pos = torch.full((2,), 31, dtype=torch.int32)
    nxt2, _ = tsteps.build_decode_step(cfg)(params, cache, nxt, pos)
    assert nxt2.dtype == torch.int32 and nxt2.shape == (2,)


# ---------------------------------------------------------------------------
# the autograd Functions and the grad guard
# ---------------------------------------------------------------------------

def _grads(fn, inputs, cots):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(outs, leaves, cots)


@pytest.mark.parametrize("window,softcap,q_offset", [(None, None, 0),
                                                     (16, 30.0, 8)])
def test_flash_attention_function_backward(monkeypatch, window, softcap,
                                           q_offset):
    """The Function with the kernel's forward replaced by the plain
    version (no kernel here): its backward equals autograd of the plain
    version."""
    monkeypatch.setattr(tfa, "_launch", lambda q, k, v, causal, window,
                        softcap, q_offset: ref.flash_attention_ref(
                            q, k, v, causal=causal, window=window,
                            softcap=softcap, q_offset=q_offset))
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 24, 32), (2, 2, 32, 32), (2, 2, 32, 32)))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    got = _grads(lambda q, k, v: tfa._FlashAttention.apply(
        q, k, v, True, window, softcap, q_offset), (q, k, v), (do,))
    want = _grads(lambda q, k, v: ref.flash_attention_ref(q, k, v, **kw),
                  (q, k, v), (do,))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("T,chunk", [(64, 32), (16, 32), (1, 32)])
def test_wkv6_function_backward(monkeypatch, T, chunk):
    """The Function's backward (autograd of the chunked plain form) against
    autograd of the sequential ``wkv6_ref``, for both outputs: within 1e-4
    of each gradient's largest magnitude (two summation orders)."""
    monkeypatch.setattr(twkv, "_launch", ref.wkv6_ref)
    rng = np.random.default_rng(8)
    B, H, K = 2, 2, 32
    r, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, K))
                                .astype(np.float32) * 0.5) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.6, 0.999, (B, T, H, K))
                         .astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((H, K)).astype(np.float32) * .1)
    s0 = torch.from_numpy(rng.standard_normal((B, H, K, K))
                          .astype(np.float32) * 0.1)
    do = torch.from_numpy(rng.standard_normal((B, T, H, K))
                          .astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal((B, H, K, K))
                          .astype(np.float32))
    args = (r, k, v, w, u, s0)
    got = _grads(lambda *a: twkv._WKV6.apply(*a, min(chunk, T)), args,
                 (do, ds))
    want = _grads(ref.wkv6_ref, args, (do, ds))
    for name, a, b in zip("rkvwus", got, want):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.parametrize("launch,n", [(tfa._launch, 7), (twkv._launch, 6)])
def test_kernel_launch_refuses_grad(launch, n):
    """A direct launch with an input that requires grad raises before it
    reaches the card; under no_grad it passes the guard."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="detached"):
        launch(*([x] * n))
    with torch.no_grad():
        _grad.refuse_grad("k", x)
    _grad.refuse_grad("k", torch.ones(2), None)


def test_product_f32_backward_matches_jax():
    """``matmul_f32`` / ``bmm_f32`` in bf16 (the Function) against JAX's
    gradient of ``einsum(..., preferred_element_type=F32)``: the f32
    cotangent times the other operand, cast to bf16; within one bf16 ulp
    (2^-7 of the largest magnitude)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    c = rng.standard_normal((6, 8)).astype(np.float32)
    xb = rng.standard_normal((3, 6, 16)).astype(np.float32)
    wb = rng.standard_normal((3, 16, 8)).astype(np.float32)
    cb = rng.standard_normal((3, 6, 8)).astype(np.float32)
    for tf_, eq, xs, ws, cs in ((tL.matmul_f32, "cd,df->cf", x, w, c),
                                (tL.bmm_f32, "ecd,edf->ecf", xb, wb, cb)):
        def jf(a, b, eq=eq, cs=cs):
            return jnp.sum(jnp.einsum(eq, a, b,
                                      preferred_element_type=jnp.float32)
                           * cs)
        ja, jb = (jnp.asarray(t, jnp.bfloat16) for t in (xs, ws))
        want = jax.grad(jf, argnums=(0, 1))(ja, jb)
        ta, tb = (torch.from_numpy(t).to(torch.bfloat16).requires_grad_(True)
                  for t in (xs, ws))
        out = tf_(ta, tb)
        assert out.dtype == F32
        got = torch.autograd.grad(torch.sum(out * torch.from_numpy(cs)),
                                  (ta, tb))
        for g, wnt in zip(got, want):
            assert g.dtype == torch.bfloat16
            wnt = np.asarray(wnt, np.float32)
            assert np.abs(_np(g) - wnt).max() <= 2 ** -7 * np.abs(wnt).max()


# ---------------------------------------------------------------------------
# windowed decode
# ---------------------------------------------------------------------------

def test_lm_decode_windowed_matches_jax_and_full_cache():
    """Ring-buffered local layers reproduce JAX's windowed decode and the
    port's full-cache decode, once the context is past the window too."""
    over = dict(n_layers=4, sliding_window=8,
                layer_pattern=("local", "global"))
    cfg, jcfg, jparams, tparams = _load("gemma2-27b", **over)
    B, T, W = 2, 20, 8
    toks = np.random.default_rng(10).integers(1, cfg.vocab_size, (B, T)) \
        .astype(np.int32)
    full = ttf.KVCache.zeros(cfg, B, T, F32)
    win = ttf.WindowedKVCache.zeros(cfg, B, T, F32)
    shp = (2, B, W, cfg.n_kv_heads, cfg.head_dim_)
    gshp = (2, B, T, cfg.n_kv_heads, cfg.head_dim_)
    jwin = jtf.WindowedKVCache(jnp.zeros(shp), jnp.zeros(shp),
                               jnp.zeros(gshp), jnp.zeros(gshp))
    step = jax.jit(lambda c, t, p: jtf.lm_decode_windowed(jcfg, jparams, c,
                                                          t, p))
    for t in range(T):
        pos = np.full((B,), t, np.int32)
        lf, full = ttf.lm_decode(cfg, tparams, full,
                                 torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(pos))
        lw, win = ttf.lm_decode_windowed(cfg, tparams, win,
                                         torch.from_numpy(toks[:, t]),
                                         torch.from_numpy(pos))
        lj, jwin = step(jwin, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        np.testing.assert_allclose(_np(lw), _np(lf), atol=3e-4, rtol=1e-4,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(lw), np.asarray(lj), atol=1e-4,
                                   err_msg=f"step {t}")
    nxt, _ = tsteps.build_decode_step(cfg, windowed=True)(
        tparams, win, torch.from_numpy(toks[:, -1]),
        torch.full((B,), T - 1, dtype=torch.int32))
    assert nxt.dtype == torch.int32


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_training_loss_decreases():
    from repro_torch.launch.train import train
    losses, _ = train("llama3.2-1b", reduced=True, steps=30, seq_len=64,
                      batch=4, verbose=False, device="cpu")
    assert len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_checkpoint_restart_is_exact():
    """Crash and resume reproduce the uninterrupted run, loss for loss."""
    from repro_torch.launch.train import train
    d = tempfile.mkdtemp()
    try:
        kw = dict(steps=12, seq_len=32, batch=2, verbose=False, device="cpu")
        full, _ = train("llama3.2-1b", **kw)
        part, _ = train("llama3.2-1b", stop_after=6, ckpt_dir=d,
                        ckpt_every=6, **kw)
        resumed, _ = train("llama3.2-1b", ckpt_dir=d, resume=True,
                           ckpt_every=100, **kw)
        assert part == full[:6]
        assert resumed == full[6:]
    finally:
        shutil.rmtree(d, ignore_errors=True)
