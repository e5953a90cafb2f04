"""The port's MoE chain and MoE model paths on the CPU against the JAX
package.

``_route``, ``_dispatch``, ``_combine``, ``_expert_ffn`` and ``moe_ffn``
take the same seeded numpy inputs as ``repro.models.layers``' functions:
routes, capacity slots and the keep mask must be equal, values within
2e-5 in float32. A router biased towards one expert forces capacity
overflow; padded rows (identical tokens, as a pack's padded lanes are)
route identically to one another, so no check relies on them routing
uniquely. The model functions run on ``granite-moe-3b-a800m``,
``qwen3-coder-30b-a3b`` and ``dbrx-132b`` ``.reduced()`` with the weights
of JAX's ``model_zoo.init`` carried across by ``params_from_numpy``,
through the bodies of tests/test_torch_model.py: logits and non-scratch
pages within 1e-4. ``gpt-oss-120b`` (MoE with local/global layers,
window 128) has no paged path in either package; its dense-cache
functions run in tests/test_torch_model.py's dense parametrization.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import layers as jL
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtf
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as tL
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy
from test_torch_model import (_load, _np, _reduced, check_lm_decode,
                              check_lm_decode_paged,
                              check_lm_forward_and_prefill,
                              check_lm_mixed_paged, check_lm_prefill_paged,
                              check_lm_step_chunked_prefill)

MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-coder-30b-a3b", "dbrx-132b"]
TOL = 2e-5


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    return _load(request.param)


# ---------------------------------------------------------------------------
# the chain, function by function
# ---------------------------------------------------------------------------

def _cfgs(arch, **moe):
    """(port, JAX) reduced configs, the MoE settings overridden."""
    cfg, jcfg = _reduced(arch)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
    return cfg, jcfg


def _tokens(case, T, D, rng):
    """(T, D) float32 rows; ``padded``: the last third are one repeated
    row, as a pack's padded lanes (one token at one position) are;
    ``biased``: every row shifted along the all-ones direction."""
    x = rng.standard_normal((T, D), np.float32)
    if case == "padded":
        x[2 * T // 3:] = x[-1]
    if case == "biased":
        x += 1.0
    return x


def _router(case, D, E, rng):
    """(D, E) router; ``biased``: expert 0 reads the all-ones direction,
    so that it is every shifted row's first choice and overflows."""
    r = rng.standard_normal((D, E), np.float32) * D ** -0.5
    if case == "biased":
        r[:, 0] = 4.0 * D ** -0.5
    return r


CASES = [("granite-moe-3b-a800m", "random", {}),
         ("granite-moe-3b-a800m", "biased", {}),
         ("qwen3-coder-30b-a3b", "padded", {}),
         ("qwen3-coder-30b-a3b", "random", dict(num_experts=16, top_k=4)),
         ("qwen3-coder-30b-a3b", "biased", dict(num_experts=16, top_k=4))]


@pytest.mark.parametrize("arch,case,moe", CASES)
def test_route_dispatch_combine_match_jax(arch, case, moe):
    cfg, jcfg = _cfgs(arch, **moe)
    m = cfg.moe
    T, D = 48, cfg.d_model
    rng = np.random.default_rng(31)
    x = _tokens(case, T, D, rng)
    router = _router(case, D, m.num_experts, rng)
    logits = np.asarray(x @ router, np.float32)
    jidx, jw = jL._route(jcfg.moe, jnp.asarray(logits))
    tidx, tw = tL._route(m, torch.from_numpy(logits))
    assert tidx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=TOL)
    capacity = max(8, int(T * m.top_k / m.num_experts * m.capacity_factor))
    jbuf, (je, jpos, jkeep) = jL._dispatch(jnp.asarray(x), jidx, jw,
                                           m.num_experts, capacity)
    tbuf, (te, tpos, tkeep) = tL._dispatch(torch.from_numpy(x), tidx, tw,
                                           m.num_experts, capacity)
    assert te.tolist() == np.asarray(je).tolist()
    assert tpos.tolist() == np.asarray(jpos).tolist()
    assert tkeep.tolist() == np.asarray(jkeep).tolist()
    assert torch.equal(tbuf, torch.from_numpy(np.array(jbuf)))
    if case == "biased":
        assert not tkeep.all(), "no entry overflowed"
    out = rng.standard_normal(tuple(tbuf.shape), np.float32)
    jc = jL._combine(jnp.asarray(out), (je, jpos, jkeep), jw, T)
    tc = tL._combine(torch.from_numpy(out), (te, tpos, tkeep), tw, T)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)


def _layer_moe(jparams, l=1):
    jp = jax.tree.map(lambda a: a[l], jparams["layers"]["moe"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           dtype=torch.float32)
    return jp, tp


@pytest.mark.parametrize("arch,case,moe", CASES)
def test_expert_ffn_and_moe_ffn_match_jax(arch, case, moe):
    """``_expert_ffn`` on one buffer and ``moe_ffn`` on (B, S, D) tokens,
    with layer 1's weights of JAX's init (the router biased for
    ``biased``): overflow drops and padded rows included."""
    cfg, jcfg = _cfgs(arch, **moe)
    m = cfg.moe
    jparams = jzoo.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jp, tp = _layer_moe(jparams)
    rng = np.random.default_rng(37)
    router = _router(case, cfg.d_model, m.num_experts, rng)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    buf = rng.standard_normal((m.num_experts, 10, cfg.d_model), np.float32)
    np.testing.assert_allclose(
        tL._expert_ffn(cfg, tp, torch.from_numpy(buf)).numpy(),
        np.asarray(jL._expert_ffn(jcfg, jp, jnp.asarray(buf))), atol=TOL)
    B, S = 2, 40
    x = _tokens(case, B * S, cfg.d_model, rng).reshape(B, S, cfg.d_model)
    want = jL.moe_ffn(jcfg, jp, jnp.asarray(x))
    got = tL.moe_ffn(cfg, tp, torch.from_numpy(x))
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    if case == "biased":      # some token lost an expert to the capacity
        xt = torch.from_numpy(x.reshape(B * S, -1))
        idx, w = tL._route(m, tL.matmul_f32(xt, tp["router"]))
        cap = max(8, int(B * S * m.top_k / m.num_experts
                         * m.capacity_factor))
        _, (_, _, keep) = tL._dispatch(xt, idx, w, m.num_experts, cap)
        assert not keep.all()


# ---------------------------------------------------------------------------
# init, convert and model_zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_lm_moe_shapes_match_jax(arch):
    cfg, jcfg = _reduced(arch)
    want = jax.eval_shape(lambda k: jtf.init_lm(jcfg, k, jnp.float32),
                          jax.random.PRNGKey(0))
    mine = ttf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda a: tuple(a.shape), want)
    # the scales of JAX's init_moe: D ** -0.5, and F ** -0.5 for w_down
    moe = mine["layers"]["moe"]
    for name, fan in (("router", cfg.d_model), ("w_up", cfg.d_model),
                      ("w_down", cfg.moe.d_ff_expert)):
        std = float(moe[name].std())
        assert abs(std - fan ** -0.5) < 0.1 * fan ** -0.5, name


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_convert_moe_tree(dtype, jdtype):
    """``params_from_numpy`` carries an MoE tree leaf for leaf: the dtype
    and shape of each leaf of JAX's init."""
    jcfg = jget_config("granite-moe-3b-a800m").reduced()
    jparams = jzoo.init(jcfg, jax.random.PRNGKey(0), jdtype)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=dtype)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jparams))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tparams))
    assert flat_j.keys() == flat_t.keys()
    assert any("moe" in jax.tree_util.keystr(k) for k in flat_t)
    for k, t in flat_t.items():
        j = flat_j[k]
        assert tuple(t.shape) == tuple(j.shape), k
        assert str(t.dtype)[6:] == str(j.dtype), k
        assert t.dtype == dtype, k


def test_model_zoo_serves_moe():
    """``model_zoo`` routes ``moe`` to the transformer functions, as JAX's
    does: init, forward, prefill, decode and the cache specs."""
    arch = "granite-moe-3b-a800m"
    cfg, jcfg, jparams, tparams = _load(arch)
    mine = tzoo.init(cfg, 0, torch.float32, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda t: tuple(t.shape), tparams)
    toks = np.random.default_rng(9).integers(
        1, cfg.vocab_size, (2, 24)).astype(np.int32)
    batch_t, batch_j = ({"tokens": torch.from_numpy(toks)},
                        {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(
        _np(tzoo.forward(cfg, tparams, batch_t)),
        np.asarray(jzoo.forward(jcfg, jparams, batch_j)), atol=1e-4)
    tlast, tc = tzoo.prefill(cfg, tparams, batch_t)
    jlast, jc = jzoo.prefill(jcfg, jparams, batch_j)
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast), atol=1e-4)
    tcache = tzoo.cache_zeros(cfg, 2, 32, torch.float32, device="cpu")
    jcache = jzoo.cache_zeros(jcfg, 2, 32, jnp.float32)
    tcache.k[:, :, :24], tcache.v[:, :, :24] = tc.k, tc.v
    jcache.k = jcache.k.at[:, :, :24].set(jc.k)
    jcache.v = jcache.v.at[:, :, :24].set(jc.v)
    nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    pos = np.full((2,), 24, np.int32)
    tl, _ = tzoo.decode(cfg, tparams, tcache, torch.from_numpy(nxt),
                        torch.from_numpy(pos))
    jl, _ = jzoo.decode(jcfg, jparams, jcache, jnp.asarray(nxt),
                        jnp.asarray(pos))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4)
    spec = tzoo.cache_specs(cfg, 3, 48)
    jspec = jzoo.cache_specs(jcfg, 3, 48)
    assert tuple(spec.k.shape) == tuple(jspec.k.shape)


# ---------------------------------------------------------------------------
# the model functions (the bodies of tests/test_torch_model.py)
# ---------------------------------------------------------------------------

def test_lm_decode_paged_matches_jax(moe_model):
    check_lm_decode_paged(moe_model)


def test_lm_prefill_paged_matches_jax(moe_model):
    check_lm_prefill_paged(moe_model)


def test_lm_mixed_paged_matches_jax(moe_model):
    check_lm_mixed_paged(moe_model)


def test_lm_forward_and_prefill_match_jax(moe_model):
    check_lm_forward_and_prefill(moe_model)


def test_lm_step_chunked_prefill_matches_jax(moe_model):
    check_lm_step_chunked_prefill(moe_model)


def test_lm_decode_matches_jax(moe_model):
    check_lm_decode(moe_model)

