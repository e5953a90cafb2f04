"""The port's whisper family (encoder-decoder) on the CPU against the JAX
package.

Inputs come from a numpy seed (frame embeddings of the stub front end ×
0.1), the weights from ``repro.models.model_zoo.init`` carried across by
``repro_torch.models.convert``, on ``whisper-tiny`` ``.reduced()``: 2
encoder and 4 decoder layers, d_model 128, 4 heads of 32, layernorm,
``max_target_len`` 448. On a CPU tensor every flash attention runs its
plain version (the JAX package runs its plain ``layers.attention``).

- ``_sinusoid`` at T_enc 24 and 1,500 (within T_enc x 2 ulp of 1: the two
  f32 ``exp``s part by an ulp and the position multiplies it) and
  ``encode`` (T_enc 24 and 37) within 1e-5 of the largest magnitude;
- ``whisper_forward`` / ``whisper_prefill`` / ``whisper_decode`` logits and
  every cache field within 1e-4 of each tensor's largest magnitude (at
  least 1), decode from the padded cache; decode past the learned
  positions (``max_target_len`` 8: JAX clips the position index);
  prefill plus teacher-forced decode against the forward over the whole
  sequence (1e-3 of the largest logit, the card check's limit);
- ``EncDecCache`` specs with and without ``enc_len`` (0 takes
  ``n_frontend_tokens``, 0 for whisper-tiny, as in JAX);
- ``init``'s shapes and dtypes against ``jax.eval_shape``, the converter's
  per-leaf dtypes of ``enc_layers`` / ``dec_layers``;
- the train loss and every gradient leaf against ``jax.value_and_grad``,
  at ``tests/test_torch_train.py``'s LM tolerance (1e-4 of each leaf's
  largest magnitude), and ``remat`` equal to no remat.
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
from repro.models import model_zoo as jzoo
from repro.models import whisper as jwhisper
from repro_torch.configs.registry import get_config
from repro_torch.distributed import steps as tsteps
from repro_torch.launch.train import train
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import whisper as twhisper
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as topt

ARCH = "whisper-tiny"
F32 = torch.float32
MODEL_TOL = 1e-4
DECODE_TOL = 1e-3
FIELDS = ("self_k", "self_v", "cross_k", "cross_v")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    want = _np(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0,
                               err_msg=what)


def _cache_close(tcache, jcache, what):
    for f in FIELDS:
        t, j = getattr(tcache, f), getattr(jcache, f)
        assert tuple(t.shape) == tuple(j.shape), f
        _close(t, j, MODEL_TOL, f"{what} {f}")


@functools.lru_cache(maxsize=None)
def _jit(name, dtype=jnp.float32, **over):
    """``repro.models.model_zoo.<name>`` on the reduced config, jitted;
    ``init`` takes the key and draws in ``dtype``."""
    jcfg = jget_config(ARCH).reduced(**over)
    if name == "init":
        return jax.jit(lambda key: jzoo.init(jcfg, key, dtype))
    if name == "encode":
        return jax.jit(functools.partial(jwhisper.encode, jcfg))
    return jax.jit(functools.partial(getattr(jzoo, name), jcfg))


@functools.lru_cache(maxsize=None)
def _load(**over):
    """(cfg, jcfg, JAX f32 params, the port's copy); shared, not mutated."""
    cfg = get_config(ARCH).reduced(**over)
    jcfg = jget_config(ARCH).reduced(**over)
    jparams = _jit("init", **over)(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=F32)
    return cfg, jcfg, jparams, tparams


def _inputs(cfg, seed, B, T_dec, T_enc):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T_dec)).astype(np.int32)
    frames = (rng.standard_normal((B, T_enc, cfg.d_model)) * 0.1) \
        .astype(np.float32)
    return ({"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)},
            {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})


def _pad(cache, jcache, cfg, jcfg, dec_len):
    """Prefill caches (self K/V exactly as long as the prompt) copied into
    caches whose self K/V hold ``dec_len`` positions."""
    T = cache.self_k.shape[2]
    B, T_enc = cache.cross_k.shape[1], cache.cross_k.shape[2]
    tc = tzoo.cache_zeros(cfg, B, dec_len, F32, enc_len=T_enc, device="cpu")
    tc.self_k[:, :, :T], tc.self_v[:, :, :T] = cache.self_k, cache.self_v
    tc.cross_k, tc.cross_v = cache.cross_k, cache.cross_v
    jc = jzoo.cache_zeros(jcfg, B, dec_len, jnp.float32, enc_len=T_enc)
    jc = dataclasses.replace(
        jc, self_k=jc.self_k.at[:, :, :T].set(jcache.self_k),
        self_v=jc.self_v.at[:, :, :T].set(jcache.self_v),
        cross_k=jcache.cross_k, cross_v=jcache.cross_v)
    return tc, jc


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def test_sinusoid_matches_jax():
    """XLA's and ATen's f32 ``exp`` part by an ulp on some frequencies
    (below 1), and the position multiplies that: the angles, and so the
    values, may differ by up to ``length`` x 2 ulp of 1."""
    for length, dim in ((24, 128), (1500, 384)):
        got = twhisper._sinusoid(length, dim)
        want = np.asarray(jwhisper._sinusoid(length, dim))
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-6 + length * 2.0 ** -22,
                                   err_msg=f"{length}x{dim}")


@pytest.mark.parametrize("T_enc", [24, 37])
def test_encode_matches_jax(T_enc):
    cfg, _, jp, tp = _load()
    bt, bj = _inputs(cfg, T_enc, 2, 4, T_enc)
    got = twhisper.encode(cfg, tp, bt["frames"])
    assert got.shape == (2, T_enc, cfg.d_model)
    _close(got, _jit("encode")(jp, bj["frames"]), 1e-5, "encode")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T_dec,T_enc", [(32, 24), (5, 37)])
def test_whisper_model_matches_jax(T_dec, T_enc):
    """forward, prefill (logits and every cache field) and two decode
    steps from the padded cache, through model_zoo."""
    cfg, jcfg, jp, tp = _load()
    bt, bj = _inputs(cfg, T_dec, 2, T_dec, T_enc)
    _close(tzoo.forward(cfg, tp, bt), _jit("forward")(jp, bj), MODEL_TOL,
           "forward")
    tlast, tcache = tzoo.prefill(cfg, tp, bt)
    jlast, jcache = _jit("prefill")(jp, bj)
    _close(tlast, jlast, MODEL_TOL, "prefill logits")
    _cache_close(tcache, jcache, "prefill")
    tc, jc = _pad(tcache, jcache, cfg, jcfg, T_dec + 4)
    nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    for step in range(2):
        pos = np.full((2,), T_dec + step, np.int32)
        tl, tc = tzoo.decode(cfg, tp, tc, torch.from_numpy(nxt),
                             torch.from_numpy(pos))
        jl, jc = _jit("decode")(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        _close(tl, jl, MODEL_TOL, f"decode {step} logits")
        _cache_close(tc, jc, f"decode {step}")
        assert np.argmax(_np(tl), -1).tolist() == \
            np.argmax(np.asarray(jl), -1).tolist()
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)


def test_decode_past_the_learned_positions_matches_jax():
    """With max_target_len 8 a 6-token prompt decodes to position 11: the
    learned position is clipped to row 7, as in JAX; the self cache holds
    12 positions."""
    over = dict(max_target_len=8)
    cfg, jcfg, jp, tp = _load(**over)
    bt, bj = _inputs(cfg, 3, 2, 6, 16)
    tlast, tcache = tzoo.prefill(cfg, tp, bt)
    jlast, jcache = _jit("prefill", **over)(jp, bj)
    tc, jc = _pad(tcache, jcache, cfg, jcfg, 12)
    nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    for p in range(6, 12):
        pos = np.full((2,), p, np.int32)
        tl, tc = tzoo.decode(cfg, tp, tc, torch.from_numpy(nxt),
                             torch.from_numpy(pos))
        jl, jc = _jit("decode", **over)(jp, jc, jnp.asarray(nxt),
                                        jnp.asarray(pos))
        _close(tl, jl, MODEL_TOL, f"decode at {p}")
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    _cache_close(tc, jc, "after decoding past the learned positions")


def test_decode_past_the_cache_end_raises():
    """A prefill's self cache is exactly as long as the prompt. JAX's
    decode at position T drops the K/V write and attends without the new
    key; the port raises, so a caller pads the cache first (ROADMAP.md
    section 3)."""
    cfg, _, jp, tp = _load()
    bt, bj = _inputs(cfg, 5, 1, 6, 16)
    _, tcache = tzoo.prefill(cfg, tp, bt)
    _, jcache = _jit("prefill")(jp, bj)
    jl, _ = _jit("decode")(jp, jcache, jnp.ones((1,), jnp.int32),
                           jnp.full((1,), 6, jnp.int32))
    assert np.isfinite(np.asarray(jl)).all()
    with pytest.raises(IndexError):
        tzoo.decode(cfg, tp, tcache, torch.ones(1, dtype=torch.int32),
                    torch.full((1,), 6, dtype=torch.int32))


def test_prefill_then_decode_matches_forward():
    """prefill(S) then teacher-forced decode steps give the logits of one
    forward over the whole sequence at every decoded position, within
    chip_smoke.py's limit for the full-width check, 1e-3 of the largest
    logit, the same argmax."""
    cfg, _, _, tp = _load()
    S, D = 8, 12
    bt, _ = _inputs(cfg, 9, 2, S + D, 24)
    toks = bt["tokens"]
    want = tzoo.forward(cfg, tp, bt)
    last, cache = tzoo.prefill(cfg, tp, {"tokens": toks[:, :S],
                                         "frames": bt["frames"]})
    tc = tzoo.cache_zeros(cfg, 2, S + D, F32, enc_len=24, device="cpu")
    tc.self_k[:, :, :S], tc.self_v[:, :, :S] = cache.self_k, cache.self_v
    tc.cross_k, tc.cross_v = cache.cross_k, cache.cross_v
    got = [last]
    for i in range(D - 1):
        lg, tc = tzoo.decode(cfg, tp, tc, toks[:, S + i],
                             torch.full((2,), S + i, dtype=torch.int32))
        got.append(lg)
    got = torch.stack(got, 1)
    _close(got, want[:, S - 1:S + D - 1], DECODE_TOL, "decode vs forward")
    assert torch.equal(got.argmax(-1), want[:, S - 1:S + D - 1].argmax(-1))


@pytest.mark.parametrize("enc_len", [0, 24])
@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_cache_specs_match_jax(dtype, jdtype, enc_len):
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    ts = tzoo.cache_specs(cfg, 3, 48, dtype, enc_len=enc_len)
    js = jzoo.cache_specs(jcfg, 3, 48, jdtype, enc_len=enc_len)
    tz = tzoo.cache_zeros(cfg, 3, 48, dtype, enc_len=enc_len, device="cpu")
    for f in FIELDS:
        spec, jspec, zero = getattr(ts, f), getattr(js, f), getattr(tz, f)
        assert tuple(spec.shape) == tuple(jspec.shape), f
        assert str(spec.dtype)[6:] == str(jspec.dtype), f
        assert zero.shape == spec.shape and zero.dtype == spec.dtype
        assert not zero.any()
    assert ts.cross_k.shape[2] == enc_len          # n_frontend_tokens is 0


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_init_whisper_shapes_and_dtypes_match_jax(dtype, jdtype):
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


def test_convert_keeps_leaf_dtypes():
    """A bf16 JAX tree carries across leaf for leaf, dtype and bits: the
    stacked ``enc_layers`` and ``dec_layers`` included."""
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
    assert got["dec_layers"]["cross_attn"]["wk"].shape[0] == 4
    assert got["enc_layers"]["ln_attn"]["bias"].shape[0] == 2


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(cfg, seed, B=2, S=32, T_enc=16):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
    batch["frames"] = (rng.standard_normal((B, T_enc, cfg.d_model)) * 0.1) \
        .astype(np.float32)
    return batch


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
    """``launch.train.train`` takes whisper-tiny (zero frames of the stub front end, as in JAX): finite losses, the
    params moved."""
    losses, params = train("whisper-tiny", steps=2, seq_len=16, batch=2,
                           device="cpu", verbose=False)
    assert len(losses) == 2 and np.isfinite(losses).all()
    fresh = tzoo.init(get_config("whisper-tiny").reduced(), 0, F32, device="cpu")
    assert not torch.equal(params["embed"], fresh["embed"])
