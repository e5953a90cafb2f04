"""The port's paged-attention kernels on the CPU against the JAX package.

On a CPU tensor the port's wrappers run their plain versions, so these
tests hold those plain versions (and the ``ops`` dispatchers built on
them) against ``repro.kernels.ref`` / ``repro.kernels.ops`` over the
shapes of ``tests/test_kernels.py``, plus one small shape against the JAX
Pallas kernels in interpret mode. Inputs are drawn with numpy and handed
to both packages. Tolerances: 2e-5 in float32 (the JAX sweeps' own), 3e-2
in bfloat16; pool writes are exact. The Hopper kernels themselves run only
on the card, where ``chip_smoke.py`` holds them against the same plain
versions; what of them runs on the host is tested here: the split-K decode
kernel's split plan and input checks, and its split-and-combine algebra
(written out in torch) against the JAX package's plain decode attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_flash_attention as pfa
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


# Tile-edge shapes the tensor-core kernel is held to on the card (64-row
# query blocks, 64-key tiles read through the table): Sq off multiples of
# 64, kv_len mid-page and off multiples of 64, G of 1, 2, 4 and 8, D of
# 32, 64 and 128, page of 8, 16 and 32.
# (B, Hq, Hkv, D, page, P, Np, Sq), kv_len per row
PREFILL_EDGE_CASES = [
    ((2, 2, 2, 64, 8, 24, 10, 1), (73, 1)),
    ((2, 4, 2, 32, 16, 20, 6, 15), (90, 15)),
    ((1, 8, 2, 128, 32, 8, 5, 17), (147,)),
    ((2, 8, 1, 64, 8, 40, 12, 63), (91, 70)),
    ((1, 4, 2, 64, 16, 16, 10, 65), (150,)),
    ((1, 4, 1, 128, 32, 12, 9, 200), (263,)),
]


@pytest.mark.parametrize("shape,kv_len", PREFILL_EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_attention_ref_matches_jax_tile_edges(shape, kv_len,
                                                          dtype):
    B, Hq, Hkv, D, page, P, Np, Sq = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((B, Hq, Sq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    table = rng.choice(P, (B, Np), replace=False).astype(np.int32)
    kv = np.asarray(kv_len, np.int32)
    qo = (kv - Sq).astype(np.int32)
    jq, tq = _both(q, dtype)
    jk, tk = _both(kp, dtype)
    jv, tv = _both(vp, dtype)
    want = jref.paged_flash_attention_ref(jq, jk, jv, jnp.asarray(table),
                                          jnp.asarray(kv), jnp.asarray(qo))
    got = tref.paged_flash_attention_ref(tq, tk, tv, torch.from_numpy(table),
                                         torch.from_numpy(kv),
                                         torch.from_numpy(qo))
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, D)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def _paged_args(dtype, *, Sq=256, Hq=32, Hkv=8, D=64, page=32, P=80, Np=66):
    """The main path's paged prefill pack (C 256 over llama3.2-1b's pool)."""
    i32 = torch.int32
    return (torch.empty((1, Hq, Sq, D), dtype=dtype),
            torch.empty((P, page, Hkv, D), dtype=dtype),
            torch.empty((P, page, Hkv, D), dtype=dtype),
            torch.zeros((1, Np), dtype=i32), torch.tensor([1280], dtype=i32),
            torch.tensor([1024], dtype=i32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_check_accepts_main_path(dtype):
    pfa._check(*_paged_args(dtype))


def test_paged_flash_check_rejects_and_limits_shared_memory_to_f32():
    q, kp, vp, table, kv_len, q_offset = _paged_args(torch.bfloat16)
    n = q.numel()
    odd = torch.empty(n + 8, dtype=torch.bfloat16)[1:n + 1].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pfa._check(odd, kp, vp, table, kv_len, q_offset)
    n = kp.numel()
    odd = torch.empty(n + 8, dtype=torch.bfloat16)[1:n + 1].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pfa._check(q, kp, odd, table, kv_len, q_offset)
    with pytest.raises(ValueError, match="head dim"):
        pfa._check(*_paged_args(torch.bfloat16, D=48))
    # page * D above the f32 body's 48 KiB staging: fine in bf16, which
    # streams 64-key tiles whatever the page size
    big = dict(D=128, page=128, P=12, Np=11)
    pfa._check(*_paged_args(torch.bfloat16, **big))
    with pytest.raises(ValueError, match="48 KiB"):
        pfa._check(*_paged_args(torch.float32, **big))


# ---------------------------------------------------------------------------
# The split-K decode kernel's host side and algebra (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------

# (B, Hkv, maxp, page): the decode sweeps above and chip_smoke.py's (page
# 8, 16, 32), the main path, one long lane, large batches
SPLIT_PLAN_CASES = sorted({(s[0], s[2], s[6], s[4]) for s in DECODE_SHAPES}
                          | {(8, 8, 64, 32), (8, 8, 600, 32), (1, 8, 512, 32),
                             (4, 8, 512, 32), (1, 8, 1, 32), (1, 1, 1, 8),
                             (2, 2, 40, 8), (1, 8, 2048, 16), (64, 8, 64, 32),
                             (256, 8, 4096, 32), (3, 2, 10, 8)})


@pytest.mark.parametrize("B,Hkv,maxp,page", SPLIT_PLAN_CASES)
def test_split_plan_covers_the_table(B, Hkv, maxp, page):
    pps, S = pa._split_plan(B, Hkv, maxp, page)
    assert isinstance(pps, int) and isinstance(S, int)   # whole pages
    assert pps >= 1 and S >= 1
    assert S * pps >= maxp                   # every table entry has a split
    assert (S - 1) * pps < maxp              # no split wholly past the table
    assert S <= pa._MAX_SPLITS
    assert B * Hkv * S <= max(pa._MAX_BLOCKS, B * Hkv)
    assert pps * page >= min(pa._KEYS_PER_SPLIT, maxp * page)


def test_split_plan_main_path_fills_the_card():
    """The main path's 8 lanes x 8 kv heads: 256-key splits, 512 blocks
    (64 before the split); one 16,384-token lane: 512 blocks, not 8; short
    lanes keep 128-key splits."""
    assert pa._split_plan(8, 8, 64, 32) == (8, 8)
    pps, S = pa._split_plan(1, 8, 512, 32)
    assert 8 * S == 512 and pps * 32 == 256
    assert pa._split_plan(8, 8, 16, 32) == (4, 4)


def _decode_args(dtype, *, B=8, Hq=32, Hkv=8, D=64, page=32, P=80, maxp=64,
                 fused=True):
    """The main path's decode call (llama3.2-1b, 8 lanes, 64 pages)."""
    i32 = torch.int32
    args = [torch.empty((B, Hq, D), dtype=dtype),
            torch.empty((P, page, Hkv, D), dtype=dtype),
            torch.empty((P, page, Hkv, D), dtype=dtype),
            torch.zeros((B, maxp), dtype=i32), torch.ones((B,), dtype=i32)]
    if fused:
        args += [torch.empty((B, Hkv, D), dtype=dtype),
                 torch.empty((B, Hkv, D), dtype=dtype),
                 torch.zeros((B,), dtype=i32), torch.zeros((B,), dtype=i32)]
    return args


def _misaligned(t):
    """A view of t's shape and dtype that starts one element past a
    16-byte boundary (CPU allocations are 64-byte aligned)."""
    n = t.numel()
    return torch.empty(n + 8, dtype=t.dtype)[1:n + 1].view(t.shape)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_check_accepts_main_path(dtype, fused):
    pa._check(*_decode_args(dtype, fused=fused))
    for D, G in ((32, 1), (128, 8), (64, 3)):     # the other instances
        pa._check(*_decode_args(dtype, Hq=2 * G, Hkv=2, D=D, fused=fused))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_check_rejects_what_vector_loads_cannot_read(dtype):
    args = _decode_args(dtype)
    for i, name in ((0, "q"), (1, "k_pages"), (2, "v_pages"), (5, "k_new"),
                    (6, "v_new")):
        bad = list(args)
        bad[i] = _misaligned(args[i])
        assert bad[i].data_ptr() % 16
        with pytest.raises(ValueError, match=f"{name} must start on a "
                                             "16-byte boundary"):
            pa._check(*bad)
    for D in (36, 48, 96, 256):    # not a multiple of the vector, or no
        with pytest.raises(ValueError, match="head dim"):   # instance
            pa._check(*_decode_args(dtype, D=D))
    with pytest.raises(ValueError, match="exceed one block"):
        pa._check(*_decode_args(dtype, Hq=32, Hkv=2))


def _split_combine(q, kp, vp, table, lengths, pps, S, k_new=None,
                   v_new=None):
    """The split decode kernel's algebra, written in torch (f32): split s
    of lane b reads rows [s * pps * page, (s + 1) * pps * page) below the
    limit (``lengths[b]``, fused ``lengths[b] - 1``) and gives (m, l, acc)
    in base 2 (scores scaled by D**-0.5 * log2 e); an empty split gives
    (-1e30, 0) and no acc; fused, the new token is one more partial
    (q.k_new, 1, v_new) read from k_new / v_new. The combine:
    o = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30) over
    the partials with l_s > 0. Rows at or past the limit are never read."""
    B, Hq, D = q.shape
    _, page, Hkv, _ = kp.shape
    G, maxp = Hq // Hkv, table.shape[1]
    scale = D ** -0.5 * float(np.log2(np.e))
    fused = k_new is not None
    o = torch.empty(B, Hq, D)
    for b in range(B):
        limit = min(int(lengths[b]) - int(fused), maxp * page)
        for h in range(Hkv):
            qh = q[b, h * G:(h + 1) * G].float() * scale          # (G, D)
            parts = []
            for s in range(S):
                lo = s * pps * page
                hi = min(limit, lo + pps * page)
                if lo >= hi:
                    parts.append((torch.full((G,), -1e30), torch.zeros(G),
                                  None))
                    continue
                rows = torch.arange(lo, hi)
                pid = table[b, rows // page].long()
                k = kp[pid, rows % page, h].float()                # (n, D)
                v = vp[pid, rows % page, h].float()
                sc = qh @ k.T                                      # (G, n)
                m = sc.max(-1).values
                p = torch.exp2(sc - m[:, None])
                parts.append((m, p.sum(-1), p @ v))
            if fused:
                parts.append((qh @ k_new[b, h].float(), torch.ones(G),
                              v_new[b, h].float().expand(G, D)))
            live = [pt for pt in parts if bool((pt[1] > 0).all())]
            M = torch.stack([pt[0] for pt in parts]).max(0).values
            L, A = torch.zeros(G), torch.zeros(G, D)
            for m, l, acc in live:
                c = torch.exp2(m - M)
                L, A = L + c * l, A + c[:, None] * acc
            o[b, h * G:(h + 1) * G] = A / torch.clamp(L, min=1e-30)[:, None]
    return o


# (B, Hq, Hkv, D, page, maxp, pps): G 4, 3, 8 and 1; page 16, 8, 32; the
# plan's own pps (None) and smaller splits for more of them
COMBINE_SHAPES = [(6, 8, 2, 64, 16, 16, None), (6, 8, 2, 64, 16, 16, 3),
                  (4, 6, 2, 32, 8, 24, 4), (3, 16, 2, 128, 32, 8, 1),
                  (5, 4, 4, 64, 32, 12, 2)]


def _edge_lengths(B, page, maxp, pps, fused):
    """Limits (``lengths - fused``) at split edges (k*split, k*split +- 1)
    and at maxp * page, then mid-split, and a last lane of length 1 (fused:
    an idle lane)."""
    k, top = pps * page, maxp * page - int(fused)
    limits = [k, k - 1, k + 1, 2 * k, top] + [k // 2 + 3] * B
    lens = [min(x, top) + int(fused) for x in limits[:B - 1]] + [1]
    return np.asarray(lens, np.int32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape", COMBINE_SHAPES)
def test_split_combine_matches_jax(shape, fused):
    """The split-and-combine algebra against the JAX package's plain
    decode attention, f32 at 2e-5: lengths on split edges, empty splits,
    a lane of length 1 and, fused, the new token as its own partial with
    NaN in its pool slot and everywhere no lane may read."""
    B, Hq, Hkv, D, page, maxp, pps = shape
    plan = pa._split_plan(B, Hkv, maxp, page)
    pps = pps or plan[0]
    S = -(-maxp // pps)
    P = B * maxp + 1
    q, kp, vp, _, _ = _decode_case(sum(shape[:6]) + fused, B, Hq, Hkv, D,
                                   page, P, maxp)
    rng = np.random.default_rng(B + D)
    table = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = _edge_lengths(B, page, maxp, pps, fused)
    k_new = rng.standard_normal((B, Hkv, D), np.float32)
    v_new = rng.standard_normal((B, Hkv, D), np.float32)
    wp = table[np.arange(B), (lengths - 1) // page]
    wo = (lengths - 1) % page
    kw, vw = kp.copy(), vp.copy()
    if fused:
        kw[wp, wo], vw[wp, wo] = k_new, v_new
    want = jref.paged_attention_ref(jnp.asarray(q), jnp.asarray(kw),
                                    jnp.asarray(vw), jnp.asarray(table),
                                    jnp.asarray(lengths))
    # poison what no lane may read: past each limit, and the fused slot
    readable = np.zeros(kp.shape[:2], bool)
    for b in range(B):
        t = np.arange(lengths[b] - int(fused))
        readable[table[b, t // page], t % page] = True
    kz, vz = kp.copy(), vp.copy()
    kz[~readable] = np.nan
    vz[~readable] = np.nan
    extra = (torch.from_numpy(k_new), torch.from_numpy(v_new)) if fused \
        else ()
    got = _split_combine(torch.from_numpy(q), torch.from_numpy(kz),
                         torch.from_numpy(vz), torch.from_numpy(table),
                         torch.from_numpy(lengths), pps, S, *extra)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL)
    if fused:      # the idle lane (length 1) outputs its own v_new
        np.testing.assert_allclose(
            got[-1].numpy(), np.repeat(v_new[-1], Hq // Hkv, 0), atol=1e-6)
