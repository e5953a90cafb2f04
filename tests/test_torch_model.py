"""The port's model paths on the CPU against the JAX package: the paged
path on ``llama3.2-1b``, the dense-cache path (``lm_forward``, chunked
``lm_step``, ``lm_decode``) on ``gemma2-27b``, ``llama3.2-1b``,
``qwen2.5-3b`` (qkv bias, tied embeddings), ``internlm2-20b`` and
``llava-next-34b``. The ``check_*`` bodies also serve the MoE family
(tests/test_torch_moe.py).

Weights come from ``repro.models.model_zoo.init`` on the ``.reduced()``
configs (gemma2's post norms and tied embeddings included) and are carried
across by ``repro_torch.models.convert``; every other input is drawn with
numpy and handed to both packages. Logits, real rows only, and
non-scratch cache positions agree within 1e-4 (XLA and ATen sum in other
orders); layer functions within 2e-5 in float32 and 3e-2 in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import layers as jL
from repro.models import model_zoo
from repro.models import transformer as jtf
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as tL
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy

ATOL = 1e-4


def _load(arch):
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    jparams = model_zoo.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32)
    return cfg, jcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _load("llama3.2-1b")


DENSE_ARCHS = ["gemma2-27b", "llama3.2-1b", "qwen2.5-3b", "internlm2-20b",
               "llava-next-34b"]


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense_model(request):
    return _load(request.param)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_functions_match_jax(model, dtype):
    cfg, jcfg, jparams, tparams = model
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    scale = rng.standard_normal((cfg.d_model,), np.float32) * 0.1
    bias = rng.standard_normal((cfg.d_model,), np.float32) * 0.1
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(dtype)
    js, ts = jnp.asarray(scale, jd), torch.from_numpy(scale).to(dtype)

    def close(got, want, atol=tol):
        assert got.dtype == dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=tol)

    close(tL.rms_norm(tx, ts), jL.rms_norm(jx, js))
    close(tL.layer_norm(tx, ts, torch.from_numpy(bias).to(dtype)),
          jL.layer_norm(jx, js, jnp.asarray(bias, jd)))
    xh = x.reshape(2, 5, 4, cfg.d_model // 4)
    close(tL.rope(torch.from_numpy(xh).to(dtype), torch.from_numpy(pos),
                  cfg.rope_theta),
          jL.rope(jnp.asarray(xh, jd), jnp.asarray(pos), jcfg.rope_theta))

    def lp(tree, l=1):
        return jax.tree.map(lambda a: jnp.asarray(a[l], jd), tree)

    jattn = lp(jparams["layers"]["attn"])
    tattn = {k: v[1].to(dtype) for k, v in
             tparams["layers"]["attn"].items()}
    for jt, tt in zip(jL.attn_qkv(jcfg, jattn, jx, jnp.asarray(pos)),
                      tL.attn_qkv(cfg, tattn, tx, torch.from_numpy(pos))):
        close(tt, jt)
    o = rng.standard_normal((2, 5, cfg.n_heads, cfg.head_dim_), np.float32)
    close(tL.attn_out(tattn, torch.from_numpy(o).to(dtype)),
          jL.attn_out(jattn, jnp.asarray(o, jd)))
    jmlp = lp(jparams["layers"]["mlp"])
    tmlp = {k: v[1].to(dtype) for k, v in tparams["layers"]["mlp"].items()}
    close(tL.mlp(cfg, tmlp, tx), jL.mlp(jcfg, jmlp, jx))
    # the tanh-approximate gelu, ungated
    import dataclasses
    gcfg = dataclasses.replace(cfg, act="gelu", gated_mlp=False)
    jgcfg = dataclasses.replace(jcfg, act="gelu", gated_mlp=False)
    close(tL.mlp(gcfg, tmlp, tx), jL.mlp(jgcfg, jmlp, jx))


# ---------------------------------------------------------------------------
# paged model functions
# ---------------------------------------------------------------------------

def _pools(cfg, P, page, seed):
    rng = np.random.default_rng(seed)
    shp = (cfg.n_layers, P, page, cfg.n_kv_heads, cfg.head_dim_)
    k = rng.standard_normal(shp, np.float32) * 0.5
    v = rng.standard_normal(shp, np.float32) * 0.5
    return (jtf.PagedKVCache(jnp.asarray(k), jnp.asarray(v)),
            ttf.PagedKVCache(torch.from_numpy(k.copy()),
                             torch.from_numpy(v.copy())))


def _assert_pools(jc, tc, scratch):
    live = [p for p in range(tc.k.shape[1]) if p != scratch]
    np.testing.assert_allclose(_np(tc.k[:, live]), np.asarray(jc.k[:, live]),
                               atol=ATOL)
    np.testing.assert_allclose(_np(tc.v[:, live]), np.asarray(jc.v[:, live]),
                               atol=ATOL)


def _decode_inputs(page, scratch, lens, tables):
    """Decode-lane arrays for lanes at the given lengths (0 = idle)."""
    B = len(lens)
    toks = np.arange(3, 3 + B, dtype=np.int32) * 7
    pos = np.array([max(n - 1, 0) for n in lens], np.int32)
    lengths = np.array([max(n, 1) for n in lens], np.int32)
    tbl = np.full((B, tables.shape[1]), scratch, np.int32)
    wp = np.full((B,), scratch, np.int32)
    wo = np.zeros((B,), np.int32)
    for i, n in enumerate(lens):
        if n:
            tbl[i] = tables[i]
            wp[i] = tables[i, (n - 1) // page]
            wo[i] = (n - 1) % page
    return toks, pos, tbl, lengths, wp, wo


def test_lm_decode_paged_matches_jax(model):
    check_lm_decode_paged(model)


def check_lm_decode_paged(model):
    """Four decode lanes (two long, one short, one idle) in one step."""
    cfg, jcfg, jparams, tparams = model
    page, P = 32, 10
    scratch = P - 1
    jc, tc = _pools(cfg, P, page, 2)
    tables = np.array([[0, 1, 2], [3, 4, scratch], [5, scratch, scratch],
                       [scratch, scratch, scratch]], np.int32)
    args = _decode_inputs(page, scratch, [70, 40, 1, 0], tables)
    jl, jc = jtf.lm_decode_paged(jcfg, jparams, jc,
                                 *(jnp.asarray(a) for a in args))
    tl, tc = ttf.lm_decode_paged(cfg, tparams, tc,
                                 *(torch.from_numpy(a) for a in args))
    assert tl.dtype == torch.float32 and tl.shape == (4, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl[:3]), np.asarray(jl[:3]), atol=ATOL)
    _assert_pools(jc, tc, scratch)


def test_lm_prefill_paged_matches_jax(model):
    check_lm_prefill_paged(model)


def check_lm_prefill_paged(model):
    """Chunked prefill, a physically shared prefix and a ragged final chunk
    (the construction of ``test_lm_prefill_paged_bitwise_matches_gather``):
    logits of real lanes and non-scratch pages agree after every chunk."""
    cfg, jcfg, jparams, tparams = model
    page, P, Np = 32, 8, 4
    scratch = P - 1
    jc, tc = _pools(cfg, P, page, 3)
    rng = np.random.default_rng(17)

    def chunk(jc, tc, start, n_real, table, lane=32):
        toks = np.zeros(lane, np.int32)
        toks[:n_real] = rng.integers(1, 97, n_real)
        pos = np.arange(start, start + lane, dtype=np.int32)
        pos[n_real:] = Np * page - 1
        table = np.asarray(table, np.int32)
        wp = np.where(np.arange(lane) < n_real,
                      table[np.minimum((start + np.arange(lane)) // page,
                                       Np - 1)],
                      scratch).astype(np.int32)
        wo = np.where(np.arange(lane) < n_real,
                      (start + np.arange(lane)) % page,
                      np.arange(lane) % page).astype(np.int32)
        kv_len = np.int32(start + n_real)
        args = (toks[None], pos[None], table, wp, wo, kv_len)
        jl, jc = jtf.lm_prefill_paged(jcfg, jparams, jc,
                                      *(jnp.asarray(a) for a in args))
        tl, tc = ttf.lm_prefill_paged(cfg, tparams, tc,
                                      *(torch.from_numpy(np.asarray(a))
                                        for a in args))
        np.testing.assert_allclose(_np(tl[:, :n_real]),
                                   np.asarray(jl[:, :n_real]), atol=ATOL)
        _assert_pools(jc, tc, scratch)
        return jc, tc

    table_a = [0, 1, 2, scratch]
    for start in (0, 32, 64):
        jc, tc = chunk(jc, tc, start, 32, table_a)
    table_b = [0, 1, 4, scratch]             # shares A's pages 0 and 1
    jc, tc = chunk(jc, tc, 64, 32, table_b)
    table_c = [5, 6, scratch, scratch]       # ragged final chunk
    jc, tc = chunk(jc, tc, 0, 32, table_c)
    jc, tc = chunk(jc, tc, 32, 16, table_c)


def test_lm_mixed_paged_matches_jax(model):
    check_lm_mixed_paged(model)


def check_lm_mixed_paged(model):
    """Two prefill packs (one a slack pack on the scratch page) and three
    decode lanes (one idle) in one mixed iteration."""
    cfg, jcfg, jparams, tparams = model
    page, P, Np, C = 32, 12, 4, 32
    scratch = P - 1
    jc, tc = _pools(cfg, P, page, 4)
    rng = np.random.default_rng(23)
    p_toks = np.zeros((2, 1, C), np.int32)
    p_toks[0, 0, :20] = rng.integers(2, cfg.vocab_size, 20)
    p_pos = np.full((2, 1, C), Np * page - 1, np.int32)
    p_pos[0, 0, :20] = np.arange(32, 52)
    p_tables = np.full((2, Np), scratch, np.int32)
    p_tables[0, :2] = [6, 7]
    p_wpid = np.full((2, C), scratch, np.int32)
    p_wpid[0, :20] = 7
    p_woff = np.tile(np.arange(C, dtype=np.int32) % page, (2, 1))
    p_woff[0, :20] = np.arange(20)
    p_kvlen = np.array([52, C], np.int32)
    p_last = np.array([19, C - 1], np.int32)
    tables = np.array([[0, 1, 2], [3, 4, scratch], [scratch] * 3], np.int32)
    d_args = _decode_inputs(page, scratch, [90, 33, 0], tables)
    args = (p_toks, p_pos, p_tables, p_wpid, p_woff, p_kvlen, p_last,
            *d_args)
    jp, jd, jc = jtf.lm_mixed_paged(jcfg, jparams, jc,
                                    *(jnp.asarray(a) for a in args))
    tp, td, tc = ttf.lm_mixed_paged(cfg, tparams, tc,
                                    *(torch.from_numpy(a) for a in args))
    assert tp.dtype == td.dtype == torch.int32
    assert int(tp[0]) == int(jp[0])
    assert td[:2].tolist() == np.asarray(jd[:2]).tolist()
    _assert_pools(jc, tc, scratch)


# ---------------------------------------------------------------------------
# dense-cache model functions
# ---------------------------------------------------------------------------

def test_lm_forward_and_prefill_match_jax(dense_model):
    check_lm_forward_and_prefill(dense_model)


def check_lm_forward_and_prefill(model):
    cfg, jcfg, jparams, tparams = model
    if cfg.sliding_window is not None:
        assert cfg.post_sublayer_norm and cfg.tie_embeddings
        assert "lm_head" not in tparams
    toks = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (2, 90)).astype(np.int32)   # past gemma2's window
    jl = jtf.lm_forward(jcfg, jparams, jnp.asarray(toks))
    tl = ttf.lm_forward(cfg, tparams, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (2, 90, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    jlast, jc = jtf.lm_prefill(jcfg, jparams, jnp.asarray(toks))
    tlast, tc = ttf.lm_prefill(cfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast), atol=ATOL)
    np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), atol=ATOL)
    np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), atol=ATOL)


def _dense_caches(cfg, B, Smax, seed):
    rng = np.random.default_rng(seed)
    shp = (cfg.n_layers, B, Smax, cfg.n_kv_heads, cfg.head_dim_)
    k = rng.standard_normal(shp, np.float32) * 0.5
    v = rng.standard_normal(shp, np.float32) * 0.5
    return (jtf.KVCache(jnp.asarray(k), jnp.asarray(v)),
            ttf.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))


def _assert_dense(jc, tc, Smax):
    """Non-scratch positions only: padded lanes scatter to Smax - 1 in an
    unordered way in both frameworks."""
    for j, t in ((jc.k, tc.k), (jc.v, tc.v)):
        np.testing.assert_allclose(_np(t[:, :, :Smax - 1]),
                                   np.asarray(j[:, :, :Smax - 1]), atol=ATOL)


def test_lm_step_chunked_prefill_matches_jax(dense_model):
    check_lm_step_chunked_prefill(dense_model)


def check_lm_step_chunked_prefill(model):
    """One sequence in chunks as the dense layout runs them: a full
    chunk, then ragged chunks whose padded lanes park at ``Smax - 1``, the
    last one past gemma2's 64-token window and running past the cache's
    end (start + bucket > Smax)."""
    cfg, jcfg, jparams, tparams = model
    Smax = 160
    jc, tc = _dense_caches(cfg, 1, Smax, 6)
    rng = np.random.default_rng(7)
    for start, n, lane in ((0, 64, 64), (64, 20, 32), (84, 60, 64),
                           (144, 9, 32)):
        toks = np.zeros((1, lane), np.int32)
        toks[0, :n] = rng.integers(1, cfg.vocab_size, n)
        pos = np.arange(start, start + lane, dtype=np.int32)
        pos[n:] = Smax - 1
        jl, jc = jtf.lm_step(jcfg, jparams, jc, jnp.asarray(toks),
                             jnp.asarray(pos[None]))
        tl, tc = ttf.lm_step(cfg, tparams, tc, torch.from_numpy(toks),
                             q_offset=start, n_real=n)
        np.testing.assert_allclose(_np(tl[:, :n]), np.asarray(jl[:, :n]),
                                   atol=ATOL)
        assert torch.isfinite(tl).all()
        _assert_dense(jc, tc, Smax)


def test_lm_decode_matches_jax(dense_model):
    check_lm_decode(dense_model)


def check_lm_decode(model):
    """Every slot steps at its own position (one past gemma2's window,
    one short, one parked at the scratch position as an idle lane)."""
    cfg, jcfg, jparams, tparams = model
    Smax = 128
    jc, tc = _dense_caches(cfg, 3, Smax, 8)
    toks = np.array([11, 23, 0], np.int32)
    for step in range(2):
        pos = np.array([100 + step, 7 + step, Smax - 1], np.int32)
        jl, jc = jtf.lm_decode(jcfg, jparams, jc, jnp.asarray(toks),
                               jnp.asarray(pos))
        tl, tc = ttf.lm_decode(cfg, tparams, tc, torch.from_numpy(toks),
                               torch.from_numpy(pos))
        assert tl.shape == (3, cfg.vocab_size)
        np.testing.assert_allclose(_np(tl[:2]), np.asarray(jl[:2]),
                                   atol=ATOL)
        _assert_dense(jc, tc, Smax)
        toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert torch.argmax(tl[:2], dim=-1).tolist() == toks[:2].tolist()


def test_lm_step_chunk_contract(model):
    """A chunk is one sequence whose positions come from its host-side
    start alone; anything else raises instead of running some other
    attention."""
    cfg, _jcfg, _jparams, tparams = model
    cache = ttf.KVCache.zeros(cfg, 2, 64, torch.float32)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    with pytest.raises(ValueError, match="one sequence"):
        ttf.lm_step(cfg, tparams, cache, toks, q_offset=0)
    one = ttf.KVCache(cache.k[:, :1], cache.v[:, :1])
    with pytest.raises(ValueError, match="q_offset"):
        ttf.lm_step(cfg, tparams, one, toks[:1], pos[:1])
    with pytest.raises(ValueError, match="no positions"):
        ttf.lm_step(cfg, tparams, one, toks[:1], pos[:1], q_offset=0)
    # padded lanes need the scratch position: real rows stop below it
    with pytest.raises(ValueError, match="do not fit below 63"):
        ttf.lm_step(cfg, tparams, one, toks[:1], q_offset=60, n_real=4)
    with pytest.raises(ValueError, match="do not fit"):
        ttf.lm_step(cfg, tparams, one, toks[:1], q_offset=0, n_real=0)
    _, c = ttf.lm_step(cfg, tparams, one, toks[:1], q_offset=56)
    assert c.k.abs().sum() > 0                        # a full chunk fits


def test_dense_attention_matches_jax():
    """``layers.attention`` (the decode step's plain attention), blocked
    over q_chunk, with the gemma2 toggle on and off."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 8, 4, 32), np.float32)
    k = rng.standard_normal((2, 40, 2, 32), np.float32)
    v = rng.standard_normal((2, 40, 2, 32), np.float32)
    q_pos = np.stack([np.arange(20, 28), np.arange(30, 38)]).astype(np.int32)
    kv_pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    kv_valid = kv_pos <= q_pos.max(axis=1, keepdims=True)
    for is_local, q_chunk in ((True, 4), (False, 2048)):
        kw = dict(causal=True, window=6, softcap=50.0, q_chunk=q_chunk)
        want = jL.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos,
                                                        kv_pos)),
                            kv_valid=jnp.asarray(kv_valid),
                            is_local=jnp.float32(is_local), **kw)
        got = tL.attention(*(torch.from_numpy(a) for a in (q, k, v, q_pos,
                                                           kv_pos)),
                           kv_valid=torch.from_numpy(kv_valid),
                           is_local=is_local, **kw)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
    m_j = jL.attention_scores_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                   causal=True, window=6)
    m_t = tL.attention_scores_mask(torch.from_numpy(q_pos),
                                   torch.from_numpy(kv_pos), causal=True,
                                   window=6)
    assert np.array_equal(m_t.numpy(), np.asarray(m_j))


def test_moe_family_is_not_ported():
    """The MoE family is served now: ``init_lm`` draws its router and
    stacked experts (the parity tests are in tests/test_torch_moe.py);
    a family that is no transformer LM is refused."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    p = ttf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32)
    m = cfg.moe
    assert "mlp" not in p["layers"]
    assert p["layers"]["moe"]["w_down"].shape == (
        cfg.n_layers, m.num_experts, m.d_ff_expert, cfg.d_model)
    with pytest.raises(ValueError, match="not a transformer"):
        ttf.init_lm(get_config("rwkv6-1.6b").reduced(),
                    torch.Generator().manual_seed(0), torch.float32)


def test_init_lm_shapes_match_jax(model):
    cfg, _jcfg, _jparams, tparams = model
    mine = ttf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32)
    shapes = jax.tree.map(lambda a: tuple(a.shape), tparams)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    # same scales: the embedding is drawn with std d_model ** -0.5
    std = float(mine["embed"].std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_init_lm_draws_in_slices(monkeypatch):
    """Full-width weights are drawn slice by slice straight into the
    stacked tensor (no whole-tensor f32 temporary); the slices keep the
    scale and fill every row."""
    monkeypatch.setattr(ttf, "_DRAW_ELEMS", 3000)
    cfg = get_config("gemma2-27b").reduced()
    p = ttf.init_lm(cfg, torch.Generator().manual_seed(1), torch.bfloat16)
    w = p["layers"]["mlp"]["w_up"]
    assert w.dtype == torch.bfloat16
    assert w.shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    rows = w.float().reshape(cfg.n_layers, -1)
    stds = rows.std(dim=1)
    assert torch.all((stds - cfg.d_model ** -0.5).abs()
                     < 0.1 * cfg.d_model ** -0.5)
    assert not torch.equal(rows[0], rows[1])
    assert "lm_head" not in p and "ln_post_attn" in p["layers"]
