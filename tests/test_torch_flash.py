"""The port's dense flash attention on the CPU against the JAX package.

On a CPU tensor ``repro_torch.kernels.flash_attention`` runs its plain
version, so these tests hold ``flash_attention_ref`` (and the
``ops.attention`` dispatcher and the model-layout call built on it) against
``repro.kernels.ref.flash_attention_ref`` over the sweeps of
``test_flash_attention_shapes``, ``_masking_variants`` and ``_ragged_q`` in
``tests/test_kernels.py``, and against the Pallas kernel in interpret mode
on two of those shapes. Inputs are drawn with numpy and handed to both
packages. Tolerances are the JAX tests' own: 2e-5 in float32, 2e-2 in
bfloat16. The Hopper kernel runs only on the card, where
``chip_smoke.py`` holds it against the same plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tL

F32_TOL, BF16_TOL = 2e-5, 2e-2
_JD = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _case(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D), np.float32),
            rng.standard_normal((B, Hkv, Skv, D), np.float32),
            rng.standard_normal((B, Hkv, Skv, D), np.float32))


def _both(arrays, dtype):
    return ([jnp.asarray(a, _JD[dtype]) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


SHAPES = [(2, 4, 2, 128, 128, 64), (1, 8, 8, 256, 256, 64),
          (1, 8, 2, 64, 192, 128), (2, 2, 1, 128, 128, 128)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_ref_matches_jax_shapes(B, Hq, Hkv, Sq, Skv, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_case(B * 7 + Sq, B, Hq, Hkv, Sq,
                                             Skv, D), dtype)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True,
                                    q_offset=Skv - Sq)
    got = tref.flash_attention_ref(tq, tk, tv, causal=True,
                                   q_offset=Skv - Sq)
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, D)
    _close(got, want, F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("window,softcap,causal", [
    (64, None, True), (None, 30.0, True), (32, 50.0, True),
    (None, None, False)])
def test_flash_ref_matches_jax_masking_variants(window, softcap, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_case(3, 1, 4, 2, 128, 128, 64),
                                       torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _close(tref.flash_attention_ref(tq, tk, tv, **kw),
           jref.flash_attention_ref(jq, jk, jv, **kw), F32_TOL)


@pytest.mark.parametrize("Sq", [100, 65, 1])
def test_flash_ref_matches_jax_ragged_q(Sq):
    (jq, jk, jv), (tq, tk, tv) = _both(_case(Sq, 1, 4, 2, Sq, 128, 64),
                                       torch.float32)
    got = tref.flash_attention_ref(tq, tk, tv, q_offset=128 - Sq)
    assert got.shape == (1, 4, Sq, 64)
    _close(got, jref.flash_attention_ref(jq, jk, jv, q_offset=128 - Sq),
           F32_TOL)


@pytest.mark.parametrize("shape,kw", [
    ((1, 8, 2, 64, 192, 128), dict(q_offset=128)),
    ((1, 4, 2, 100, 128, 64), dict(q_offset=28, window=32, softcap=50.0)),
])
def test_flash_ref_matches_pallas_interpret(shape, kw):
    """The Pallas kernel itself (interpret mode), not only its oracle; the
    second case has a ragged final q block, a window and a softcap."""
    (jq, jk, jv), (tq, tk, tv) = _both(_case(11, *shape), torch.float32)
    want = jflash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                  interpret=True, **kw)
    _close(tref.flash_attention_ref(tq, tk, tv, causal=True, **kw), want,
           F32_TOL)


def test_ops_attention_on_cpu_runs_plain_version():
    (_, (tq, tk, tv)) = _both(_case(5, 2, 4, 2, 96, 160, 32), torch.float32)
    before = fa_mod.flash_attention.launches
    kw = dict(causal=True, window=48, softcap=50.0, q_offset=64)
    got = tops.attention(tq, tk, tv, **kw)
    assert fa_mod.flash_attention.launches == before
    assert torch.equal(got, tref.flash_attention_ref(tq, tk, tv, **kw))


def test_model_layout_views_match_contiguous():
    """``dense_prefill_attention`` hands the model-layout query and a slot
    of the dense cache over as transposed views; the result equals the
    plain version on contiguous copies, past the cache's end included
    (padded rows of a chunk)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 32, 4, 32), np.float32))
    cache = torch.from_numpy(rng.standard_normal((3, 80, 2, 32), np.float32))
    slot = cache[1:2]                          # (1, Skv, Hkv, D) view
    o = tL.dense_prefill_attention(q, slot, slot, window=16, softcap=50.0,
                                   q_offset=60)
    want = tref.flash_attention_ref(
        q.transpose(1, 2).contiguous(), slot.transpose(1, 2).contiguous(),
        slot.transpose(1, 2).contiguous(), window=16, softcap=50.0,
        q_offset=60)
    assert o.shape == (1, 32, 4, 32)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, want.transpose(1, 2), atol=0, rtol=0)


def test_flash_attention_rejects_devices_without_a_kernel():
    q = torch.empty((1, 2, 4, 32), device="meta")
    k = torch.empty((1, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa_mod.flash_attention(q, k, k)


# Tile-edge shapes the tensor-core kernel is held to on the card (64-row
# query blocks, 64-key tiles): Sq and Skv off multiples of 64, windows
# that start mid-tile, G of 1, 2, 4 and 8, D of 32, 64 and 128, rows past
# the cache's end, a non-causal window. (B, Hq, Hkv, Sq, Skv, D), kwargs.
EDGE_CASES = [
    ((1, 2, 2, 1, 77, 64), dict(q_offset=76)),
    ((2, 4, 2, 15, 100, 32), dict(q_offset=85, window=40)),
    ((1, 8, 2, 17, 129, 128), dict(q_offset=112, softcap=30.0)),
    ((1, 8, 1, 63, 190, 64), dict(q_offset=127, window=100, softcap=50.0)),
    ((1, 4, 2, 65, 65, 128), dict(q_offset=0)),
    ((1, 4, 1, 200, 333, 64), dict(q_offset=133, window=77)),
    ((1, 2, 1, 65, 150, 32), dict(causal=False, window=50)),
    ((1, 4, 4, 17, 70, 64), dict(q_offset=60)),
]


@pytest.mark.parametrize("shape,kw", EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_ref_matches_jax_tile_edges(shape, kw, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_case(sum(shape), *shape), dtype)
    got = tref.flash_attention_ref(tq, tk, tv, **kw)
    assert got.shape == tq.shape and got.dtype == dtype
    _close(got, jref.flash_attention_ref(jq, jk, jv, **kw),
           F32_TOL if dtype == torch.float32 else BF16_TOL)


def _bf16_misaligned(shape):
    """A contiguous bf16 tensor that starts 2 bytes past an aligned one."""
    n = int(np.prod(shape))
    return torch.empty(n + 8, dtype=torch.bfloat16)[1:n + 1].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_check_accepts_main_path_views(dtype):
    """The gemma2 chunk as the dense path hands it over: a (B, Sq, Hq, D)
    query and a slot of the (L, B, Smax, Hkv, D) cache, as views."""
    q = torch.empty((1, 512, 32, 128), dtype=dtype).transpose(1, 2)
    cache = torch.empty((2, 3, 6144, 16, 128), dtype=dtype)
    k = cache[1, 2:3].transpose(1, 2)
    fa_mod._check(q, k, k, 4096, 50.0, 4096)
    fa_mod._check(q.contiguous(), k.contiguous(), k, None, None, 0)


def test_flash_check_rejects_what_the_bf16_copies_cannot_read():
    q = torch.empty((1, 4, 16, 64), dtype=torch.bfloat16)
    k = torch.empty((1, 2, 80, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa_mod._check(_bf16_misaligned(q.shape), k, k, None, None, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa_mod._check(q, k, _bf16_misaligned(k.shape), None, None, 64)
    odd = torch.empty((1, 2, 80, 66), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        fa_mod._check(q, odd, k, None, None, 64)
    # float32 runs the CUDA-core body, which reads element by element
    f = torch.empty((1, 2, 80, 66))[..., :64]
    fa_mod._check(q.float(), f, f, None, None, 64)
    wide = torch.empty((1, 4, 16, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod._check(wide, wide[:, :2], wide[:, :2], None, None, 0)
