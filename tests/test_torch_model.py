"""The port's paged model path on the CPU against the JAX package.

Weights come from ``repro.models.model_zoo.init`` on ``llama3.2-1b``
``.reduced()`` and are carried across by ``repro_torch.models.convert``;
every other input is drawn with numpy and handed to both packages. Logits
and non-scratch pool pages agree within 1e-4 (XLA and ATen sum in other
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


@pytest.fixture(scope="module")
def model():
    cfg = get_config("llama3.2-1b").reduced()
    jcfg = jget_config("llama3.2-1b").reduced()
    jparams = model_zoo.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32)
    return cfg, jcfg, jparams, tparams


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


def test_moe_family_is_not_ported():
    cfg = get_config("granite-moe-3b-a800m").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32)


def test_init_lm_shapes_match_jax(model):
    cfg, _jcfg, _jparams, tparams = model
    mine = ttf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32)
    shapes = jax.tree.map(lambda a: tuple(a.shape), tparams)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    # same scales: the embedding is drawn with std d_model ** -0.5
    std = float(mine["embed"].std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
