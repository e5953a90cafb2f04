"""The port's paged-attention kernels on the CPU against the JAX package.

On a CPU tensor the port's wrappers run their plain versions, so these
tests hold those plain versions (and the ``ops`` dispatchers built on
them) against ``repro.kernels.ref`` / ``repro.kernels.ops`` over the
shapes of ``tests/test_kernels.py``, plus one small shape against the JAX
Pallas kernels in interpret mode. Inputs are drawn with numpy and handed
to both packages. Tolerances: 2e-5 in float32 (the JAX sweeps' own), 3e-2
in bfloat16; pool writes are exact. The Hopper kernels themselves run only
on the card, where ``chip_smoke.py`` holds them against the same plain
versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL, BF16_TOL = 2e-5, 3e-2


def _both(a, dtype):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _decode_case(seed, B, Hq, Hkv, D, page, P, maxp, *, distinct=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    if distinct:
        table = rng.choice(P, (B, maxp), replace=False).astype(np.int32)
    else:
        table = rng.integers(0, P, (B, maxp)).astype(np.int32)
    lengths = rng.integers(1, maxp * page + 1, (B,)).astype(np.int32)
    return q, kp, vp, table, lengths


DECODE_SHAPES = [(4, 8, 2, 64, 32, 64, 8), (2, 4, 4, 128, 16, 32, 4),
                 (1, 16, 8, 64, 32, 16, 6), (3, 6, 2, 64, 8, 40, 10)]


# every shape in float32; bfloat16 on the first (the JAX sweeps' own bf16
# case is a single shape too)
DECODE_CASES = [(*s, torch.float32) for s in DECODE_SHAPES] + \
    [(*DECODE_SHAPES[0], torch.bfloat16)]


@pytest.mark.parametrize("B,Hq,Hkv,D,page,P,maxp,dtype", DECODE_CASES)
def test_paged_attention_ref_matches_jax(B, Hq, Hkv, D, page, P, maxp,
                                         dtype):
    q, kp, vp, table, lengths = _decode_case(B * 7 + P, B, Hq, Hkv, D, page,
                                             P, maxp)
    jq, tq = _both(q, dtype)
    jk, tk = _both(kp, dtype)
    jv, tv = _both(vp, dtype)
    want = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(table),
                                    jnp.asarray(lengths))
    got = tref.paged_attention_ref(tq, tk, tv, torch.from_numpy(table),
                                   torch.from_numpy(lengths))
    assert got.dtype == dtype and got.shape == (B, Hq, D)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def _prefill_case(seed, B, Hq, Hkv, D, page, P, Np, Sq):
    """As ``tests/test_kernels.py``: duplicate (shared) pages within and
    across rows, kv_len short of the table, nonzero q_offset."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    table = rng.integers(0, min(P, 4), (B, Np)).astype(np.int32)
    kv_len = rng.integers(Sq, (Np - 1) * page + 1, (B,)).astype(np.int32)
    q_offset = (kv_len - Sq).astype(np.int32)
    return q, kp, vp, table, kv_len, q_offset


PREFILL_SHAPES = [(2, 4, 2, 64, 32, 8, 4, 64), (1, 8, 8, 64, 16, 6, 6, 64),
                  (2, 2, 1, 128, 32, 8, 4, 32), (1, 4, 2, 64, 32, 8, 8, 96),
                  (2, 4, 2, 64, 32, 8, 4, 33), (2, 4, 2, 64, 32, 8, 4, 7)]


PREFILL_CASES = [(*s, torch.float32) for s in PREFILL_SHAPES] + \
    [(*PREFILL_SHAPES[i], torch.bfloat16) for i in (0, 4)]


@pytest.mark.parametrize("B,Hq,Hkv,D,page,P,Np,Sq,dtype", PREFILL_CASES)
def test_paged_flash_attention_ref_matches_jax(B, Hq, Hkv, D, page, P, Np,
                                               Sq, dtype):
    q, kp, vp, table, kv_len, q_offset = _prefill_case(
        B * 31 + Np + Sq, B, Hq, Hkv, D, page, P, Np, Sq)
    jq, tq = _both(q, dtype)
    jk, tk = _both(kp, dtype)
    jv, tv = _both(vp, dtype)
    want = jref.paged_flash_attention_ref(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(kv_len),
        jnp.asarray(q_offset))
    got = tref.paged_flash_attention_ref(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(kv_len),
        torch.from_numpy(q_offset))
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, D)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def test_paged_flash_attention_ref_shared_prefix_rows():
    """Two rows whose tables share the physical prefix pages and whose
    kv_len stops inside it see identical context: identical rows."""
    rng = np.random.default_rng(5)
    B, Hq, Hkv, D, page, P, Sq = 2, 4, 2, 64, 32, 8, 32
    q0 = rng.standard_normal((1, Hq, Sq, D), np.float32)
    q = torch.from_numpy(np.concatenate([q0, q0]))
    kp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D), np.float32))
    table = torch.tensor([[0, 1, 2, 3], [0, 1, 2, 4]], dtype=torch.int32)
    kv_len = torch.full((B,), 3 * page, dtype=torch.int32)
    out = tops.prefill_attention(q, kp, vp, table, kv_len, kv_len - Sq)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


@pytest.mark.parametrize("B,Hq,Hkv,D,page,P,maxp", [
    (4, 8, 2, 64, 32, 64, 8), (2, 4, 4, 128, 16, 32, 4),
    (3, 6, 2, 64, 8, 40, 10)])
def test_ops_fused_decode_matches_jax(B, Hq, Hkv, D, page, P, maxp):
    """The fused decode dispatcher (scatter, then attend, in place) against
    the JAX dispatcher's plain path: output within 2e-5, pools exact."""
    q, kp, vp, table, lengths = _decode_case(B * 13 + P, B, Hq, Hkv, D, page,
                                             P, maxp, distinct=True)
    rng = np.random.default_rng(B)
    k_new = rng.standard_normal((B, Hkv, D), np.float32)
    v_new = rng.standard_normal((B, Hkv, D), np.float32)
    wp = table[np.arange(B), (lengths - 1) // page].astype(np.int32)
    wo = ((lengths - 1) % page).astype(np.int32)
    jo, jk, jv = jops.decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), k_new=jnp.asarray(k_new),
        v_new=jnp.asarray(v_new), write_pages=jnp.asarray(wp),
        write_offsets=jnp.asarray(wo), use_kernel=False)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, tk2, tv2 = tops.decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lengths), k_new=torch.from_numpy(k_new),
        v_new=torch.from_numpy(v_new), write_pages=torch.from_numpy(wp),
        write_offsets=torch.from_numpy(wo))
    assert tk2 is tk and tv2 is tv           # updated in place
    np.testing.assert_allclose(_np(to), _np(jo), atol=F32_TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # only the write slots moved
    moved = np.zeros(kp.shape[:2], bool)
    moved[wp, wo] = True
    np.testing.assert_array_equal(tk.numpy()[~moved], kp[~moved])


def test_ops_decode_read_only_matches_jax():
    q, kp, vp, table, lengths = _decode_case(3, 2, 4, 2, 64, 16, 16, 4)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(table),
                                 jnp.asarray(lengths), use_kernel=False)
    got = tops.decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                torch.from_numpy(vp), torch.from_numpy(table),
                                torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


def test_ops_prefill_matches_jax():
    q, kp, vp, table, kv_len, q_offset = _prefill_case(5, 2, 4, 2, 64, 32, 8,
                                                       4, 64)
    want = jops.prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(kv_len), jnp.asarray(q_offset), use_kernel=False)
    got = tops.prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(kv_len),
        torch.from_numpy(q_offset))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


def test_idle_lanes_are_harmless():
    """Idle decode lanes (length 1, all-scratch table, slot (scratch, 0))
    next to a live lane: the live lane's output and every non-scratch page
    match a run without the idle lanes."""
    rng = np.random.default_rng(9)
    Hq, Hkv, D, page, P, maxp = 8, 2, 64, 32, 9, 4
    scratch = P - 1
    q = torch.from_numpy(rng.standard_normal((3, Hq, D), np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D), np.float32))
    kn = torch.from_numpy(rng.standard_normal((3, Hkv, D), np.float32))
    vn = torch.from_numpy(rng.standard_normal((3, Hkv, D), np.float32))
    table = torch.full((3, maxp), scratch, dtype=torch.int32)
    table[0, :3] = torch.tensor([2, 5, 1])
    lengths = torch.tensor([70, 1, 1], dtype=torch.int32)
    wp = torch.tensor([1, scratch, scratch], dtype=torch.int32)  # pos 69
    wo = torch.tensor([69 % page, 0, 0], dtype=torch.int32)
    k1, v1 = kp.clone(), vp.clone()
    o, _, _ = tops.decode_attention(q, k1, v1, table, lengths, k_new=kn,
                                    v_new=vn, write_pages=wp,
                                    write_offsets=wo)
    k2, v2 = kp.clone(), vp.clone()
    o_live, _, _ = tops.decode_attention(
        q[:1], k2, v2, table[:1], lengths[:1], k_new=kn[:1], v_new=vn[:1],
        write_pages=wp[:1], write_offsets=wo[:1])
    torch.testing.assert_close(o[:1], o_live, rtol=0, atol=0)
    torch.testing.assert_close(k1[:scratch], k2[:scratch], rtol=0, atol=0)
    torch.testing.assert_close(v1[:scratch], v2[:scratch], rtol=0, atol=0)
    assert torch.isfinite(o).all()


def test_plain_versions_match_pallas_interpret():
    """One small shape against the JAX Pallas kernels themselves, run in
    interpret mode on the CPU as the JAX package's own tests run them."""
    from repro.kernels.paged_attention import paged_attention_fused
    from repro.kernels.paged_flash_attention import paged_flash_attention
    q, kp, vp, table, kv_len, q_offset = _prefill_case(11, 1, 4, 2, 64, 32,
                                                       8, 4, 33)
    want = paged_flash_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(kv_len), jnp.asarray(q_offset), block_q=32,
        interpret=True)
    got = tops.prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(kv_len),
        torch.from_numpy(q_offset))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)

    B, Hkv, D, page = 2, 2, 64, 16
    q, kp, vp, table, lengths = _decode_case(4, B, 4, Hkv, D, page, 16, 4,
                                             distinct=True)
    rng = np.random.default_rng(4)
    k_new = rng.standard_normal((B, Hkv, D), np.float32)
    v_new = rng.standard_normal((B, Hkv, D), np.float32)
    wp = table[np.arange(B), (lengths - 1) // page].astype(np.int32)
    wo = ((lengths - 1) % page).astype(np.int32)
    jo, jk, jv = paged_attention_fused(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(wp), jnp.asarray(wo), interpret=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, _, _ = tops.decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lengths), k_new=torch.from_numpy(k_new),
        v_new=torch.from_numpy(v_new), write_pages=torch.from_numpy(wp),
        write_offsets=torch.from_numpy(wo))
    np.testing.assert_allclose(_np(to), _np(jo), atol=F32_TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_wrappers_count_only_kernel_launches():
    """On a CPU tensor the wrappers run the plain versions and launch
    nothing, so their counters stay put."""
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_fused)
    from repro_torch.kernels.paged_flash_attention import \
        paged_flash_attention
    before = (paged_attention.launches, paged_attention_fused.launches,
              paged_flash_attention.launches)
    test_ops_prefill_matches_jax()
    test_ops_decode_read_only_matches_jax()
    assert (paged_attention.launches, paged_attention_fused.launches,
            paged_flash_attention.launches) == before
