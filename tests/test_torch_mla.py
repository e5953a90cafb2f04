"""Multi-head latent attention and sigmoid-routed experts with shared
experts (``repro_torch.models.mla``, kanana-2-30b-a3b's block) against the
benchmark's plain reference (``mars_bench/arch/mla.py``), and the pieces
the paged path changed for it.

On the CPU, in float32 at the reference's toy widths: ``lm_forward``
against ``forward_logits``; a paged prefill in chunks across page
boundaries, then decode steps through the latent pool, against the
reference's full forward at those positions (the reference given the
program's capacity groups); the absorbed attention of the plain kernels
against the published, expanded one; the sigmoid router; interleaved
RoPE against its formula; copy-on-write, swap-out, swap-in and the spool
of latent pages; the pool's bytes and the parameter counts at the
published widths; the device-side MoE tally. And pins of qwen3-coder's
toy ``moe_ffn`` and paged logits, recorded on commit aaa3ab9 (before MLA
existed), bit for bit: the shared MoE and paged code kept its arithmetic.

On the card (``card`` tests; ``python -m pytest tests/test_torch_mla.py
-m card`` there): the CUDA kernels against their plain versions at the
published widths (32 heads, 576/512, page 32) over lengths 1 to 32,768,
every output row compared, the fused latent write bit for bit, the
prefill's edges (1-token packs, partial blocks, tile edges, the cell's
2,048-token pack, the page sizes it takes and refuses) and its
repeatability, and a captured stage replayed
against eager. On the CPU, the source's kernel names and shape table
against the wrapper and the benchmark's metric. Tolerances: float32 paths
agree to 1e-4 of the logits' largest magnitude (the same sums in another
order); the bf16 kernels element by element to KERNEL_ATOL + KERNEL_RTOL
x the value, never above the repo's bf16 kernel tolerance of 3e-2 (the
reasons beside the constants), and each card test shows that planted
faults (a block table shifted by one page, a decode split left out)
depart from the plain version by more than that limit.
"""
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mars_bench import arch as bench_arch  # noqa: E402
from mars_bench import weights  # noqa: E402
from repro_torch.configs.qwen3_coder_30b import CONFIG as QWEN  # noqa: E402
from repro_torch.core.session import Round, make_session  # noqa: E402
from repro_torch.engine import torch_runner as tr  # noqa: E402
from repro_torch.engine.torch_runner import TorchBackend  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_mla  # noqa: E402
from repro_torch.models import layers, mla  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

CONFIG = os.path.join(ROOT, "mars_bench", "configs",
                      "kanana-2-30b-a3b-instruct-2601.json")
F32_TOL = 1e-4
# the bf16 kernels' limit, element by element: KERNEL_RTOL of the value
# (both sides round an f32 result to bf16, one unit in the last place apart
# being up to 2^-7 of it, and the kernels round the softmax weights to bf16
# for the tensor cores, up to 2^-9 of the largest value where a few keys
# carry the weight: 7.8e-3 at a value of 0.43 in the first prefill rows)
# plus KERNEL_ATOL, twice the kernels' largest error on chip_smoke's
# outputs of a few hundredths (4.9e-4); never above BF16_TOL, the repo's
# bf16 kernel tolerance
KERNEL_RTOL, KERNEL_ATOL, BF16_TOL = 2 ** -5, 1e-3, 3e-2
PAGE = 8
SEED = 1234567891


def published():
    with open(CONFIG) as f:
        return json.load(f)


REF = bench_arch.module(published())


def toy():
    cfg = REF.toy(published())
    return cfg, REF.program_config(cfg)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_model():
    cfg, pcfg = toy()
    return cfg, pcfg, weights.make_params(cfg, SEED, dtype=torch.float32,
                                          device="cpu")


def _tol(want):
    return F32_TOL * max(1.0, want.abs().max().item())


def _tokens(n, vocab, seed=5):
    return torch.randint(2, vocab, (n,), generator=torch.Generator()
                         .manual_seed(seed), dtype=torch.int32)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_lm_forward_equals_the_reference(toy_model, one_thread):
    cfg, pcfg, params = toy_model
    T = 40
    toks = _tokens(T, cfg["vocab_size"])
    got = tf.lm_forward(pcfg, params, toks[None])[0]
    want = REF.forward_logits(cfg, params, toks.tolist(), list(range(T)),
                              moe_groups=[(0, T, T)])
    assert (got - want).abs().max().item() <= _tol(want)


def _pack(start, seg, lease, C, Np, scratch):
    """``lm_prefill_paged``'s arrays for ``seg`` at ``start`` (padded to C
    rows parked on the scratch page), as ``run_mixed`` builds a pack."""
    n = len(seg)
    toks = torch.zeros((1, C), dtype=torch.int32)
    toks[0, :n] = torch.tensor(seg, dtype=torch.int32)
    pos = torch.full((1, C), Np * PAGE - 1, dtype=torch.int32)
    pos[0, :n] = torch.arange(start, start + n)
    table = torch.full((Np,), scratch, dtype=torch.int32)
    table[:len(lease)] = torch.tensor(lease)
    wp = torch.full((C,), scratch, dtype=torch.int32)
    wo = torch.arange(C, dtype=torch.int32) % PAGE
    for i in range(n):
        wp[i] = lease[(start + i) // PAGE]
        wo[i] = (start + i) % PAGE
    return toks, pos, table, wp, wo, torch.tensor([start + n],
                                                  dtype=torch.int32)


def test_paged_prefill_then_decode_equals_the_reference(toy_model,
                                                        one_thread):
    """Chunks of 13 and 11 rows (padded to 16) across pages of 8, then 5
    decode steps, each call's logits against the reference's forward over
    the stream so far, given the packs' capacity groups."""
    cfg, pcfg, params = toy_model
    P, lease, Np = 12, [5, 2, 9, 0, 7], 8
    scratch = P
    cache = tf.PagedKVCache.zeros(pcfg, P + 1, PAGE, torch.float32)
    assert isinstance(cache, mla.LatentPagedKVCache)
    stream = _tokens(29, cfg["vocab_size"], seed=9).tolist()
    groups, fed = [], []
    for start, n in ((0, 13), (13, 11)):
        seg = stream[start:start + n]
        args = _pack(start, seg, lease, 16, Np, scratch)
        logits, cache = tf.lm_prefill_paged(pcfg, params, cache, *args)
        fed += seg
        groups.append((start, n, 16))
        want = REF.forward_logits(cfg, params, fed,
                                  list(range(start, start + n)),
                                  moe_groups=groups)
        got = logits[0, :n]
        assert (got - want).abs().max().item() <= _tol(want)
    table = torch.tensor([lease], dtype=torch.int32)
    for p in range(24, 29):
        tok = torch.tensor([stream[p]], dtype=torch.int32)
        fed.append(stream[p])
        logits, cache = tf.lm_decode_paged(
            pcfg, params, cache, tok, torch.tensor([p], dtype=torch.int32),
            table, torch.tensor([p + 1], dtype=torch.int32),
            torch.tensor([lease[p // PAGE]], dtype=torch.int32),
            torch.tensor([p % PAGE], dtype=torch.int32))
        want = REF.forward_logits(cfg, params, fed, [p], moe_groups=groups)
        assert (logits - want).abs().max().item() <= _tol(want)


def _latent_case(gen, B, S, H, R, Dr, Dn, Dv, P, page):
    rows = torch.randn((B, S, R + Dr), generator=gen)
    q_nope = torch.randn((B, S, H, Dn), generator=gen)
    q_pe = torch.randn((B, S, H, Dr), generator=gen)
    w = torch.randn((R, H * (Dn + Dv)), generator=gen) * R ** -0.5
    Np = -(-S // page)
    perm = torch.randperm(P, generator=gen)[:B * Np].reshape(B, Np)
    pages = torch.randn((P + 1, page, R + Dr), generator=gen)
    for b in range(B):
        flat = pages[perm[b]].reshape(-1, R + Dr)
        flat[:S] = rows[b]
        pages[perm[b]] = flat.reshape(Np, page, R + Dr)
    return rows, q_nope, q_pe, w, pages, perm.int().contiguous()


def test_absorbed_attention_equals_the_expanded():
    """``paged_mla_prefill_ref`` and ``paged_mla_decode_ref`` over the
    absorbed queries, lifted by ``W_uv``, against ``mla_expanded_ref``."""
    gen = torch.Generator().manual_seed(3)
    B, S, H, R, Dr, Dn, Dv, page = 2, 21, 4, 32, 16, 24, 20, 8
    rows, q_nope, q_pe, w, pages, table = _latent_case(
        gen, B, S, H, R, Dr, Dn, Dv, 16, page)
    scale = (Dn + Dr) ** -0.5
    wkb = w.view(R, H, Dn + Dv)
    qa = torch.einsum("bshd,rhd->bshr", q_nope, wkb[..., :Dn])
    q = torch.cat([qa, q_pe], dim=-1)

    def lift(o):
        return torch.einsum("...hr,rhd->...hd", o, wkb[..., Dn:])

    start = 5
    kv_len = torch.full((B,), S, dtype=torch.int32)
    o = ref.paged_mla_prefill_ref(q[:, start:], pages, table, kv_len,
                                  torch.full((B,), start, dtype=torch.int32),
                                  scale=scale, rank=R)
    mask = (torch.arange(S)[None, :]
            <= torch.arange(start, S)[:, None]).expand(B, -1, -1)
    want = ref.mla_expanded_ref(q_nope[:, start:], q_pe[:, start:], rows, w,
                                mask, scale=scale)
    assert torch.allclose(lift(o), want, atol=1e-5, rtol=1e-5)
    lengths = torch.tensor([S, S - 6], dtype=torch.int32)
    last = (lengths - 1).long()
    o = ref.paged_mla_decode_ref(q[torch.arange(B), last], pages, table,
                                 lengths, scale=scale, rank=R)
    mask = torch.arange(S)[None, None, :] < lengths[:, None, None]
    want = ref.mla_expanded_ref(q_nope[torch.arange(B), last][:, None],
                                q_pe[torch.arange(B), last][:, None], rows,
                                w, mask, scale=scale)[:, 0]
    assert torch.allclose(lift(o), want, atol=1e-5, rtol=1e-5)


def test_the_decode_write_lands_then_is_read():
    """With a new row the plain decode writes it at its slot first, and
    the lane's last key is that row."""
    gen = torch.Generator().manual_seed(4)
    _, _, _, _, pages, table = _latent_case(gen, 1, 16, 4, 32, 16, 8, 8,
                                            8, PAGE)
    new = torch.randn((1, 48), generator=gen)
    q = torch.randn((1, 4, 48), generator=gen)
    slot = (table[0, 1].view(1), torch.tensor([3], dtype=torch.int32))
    before = pages.clone()
    o = ops.mla_decode_attention(q, pages, table, torch.tensor(
        [PAGE + 4], dtype=torch.int32), new, *slot, scale=0.2, rank=32)
    assert torch.equal(pages[table[0, 1], 3], new[0])
    before[table[0, 1], 3] = new[0]
    assert torch.equal(pages, before)
    want = ref.paged_mla_decode_ref(q, before, table, torch.tensor(
        [PAGE + 4], dtype=torch.int32), scale=0.2, rank=32)
    assert torch.equal(o, want)


# ---------------------------------------------------------------------------
# router, shared experts, RoPE
# ---------------------------------------------------------------------------

def test_the_bias_chooses_and_the_scores_weigh():
    _, pcfg = toy()
    m, cfg_mla = pcfg.moe, pcfg.mla
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, 0.2, 0.1, 0.0, -0.5]])
    bias = torch.zeros(8)
    idx, w = layers._route_sigmoid(m, cfg_mla, logits, bias)
    assert idx.tolist() == [[0, 1]]
    bias[3] = 2.0                          # expert 3 now outranks expert 1
    idx2, w2 = layers._route_sigmoid(m, cfg_mla, logits, bias)
    assert idx2.tolist() == [[3, 0]]
    s = torch.sigmoid(logits)[0]
    want = torch.stack([s[3], s[0]])
    want = want / want.sum() * cfg_mla.routed_scaling_factor
    assert torch.allclose(w2[0], want)     # weights from the scores alone
    assert math.isclose(w2.sum().item(), 2.448, rel_tol=1e-6)
    assert math.isclose(w.sum().item(), 2.448, rel_tol=1e-6)


def test_the_shared_expert_is_never_dropped(toy_model, one_thread):
    """Every token routed to experts 0 and 1: past the capacity of 8 a
    token's routed entries drop, and its output is the shared MLP's alone;
    the kept ones add the weighted routed experts to it."""
    cfg, pcfg, params = toy_model
    lp = mla.layer_params(pcfg, params, 1)["moe"]
    lp = dict(lp, bias=torch.tensor([9.0, 8.0] + [0.0] * 6))
    x = torch.randn((1, 24, pcfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    out = layers.moe_ffn(pcfg, lp, x)[0]
    shared = layers.mlp(pcfg, lp["shared"], x)[0]
    cap = layers._capacity(pcfg.moe, 24)
    assert cap == 8
    assert torch.equal(out[cap:], shared[cap:])
    assert not torch.allclose(out[:cap], shared[:cap])


def test_the_mesh_paths_refuse_an_mla_config(toy_model):
    """The sharded and expert-parallel MoE paths route by the softmax and
    add no shared MLP: given an MLA config they raise before any
    collective, on a stand-in mesh, and ``_moe_block`` takes the
    expert-parallel path under an ``ep`` axis."""
    cfg, pcfg, params = toy_model
    lp = mla.layer_params(pcfg, params, 1)
    x = torch.zeros((1, 4, pcfg.d_model))
    pctx = types.SimpleNamespace(mesh=object(), ep_axis="ep", tp_axis="tp",
                                 dp_axes=("data",))
    for call in (lambda: layers._moe_ffn_sharded(pcfg, lp["moe"], x, pctx,
                                                 False),
                 lambda: layers.moe_ffn_ep(pcfg, lp["moe"], x, pctx),
                 lambda: layers.moe_ffn_ep_local(pcfg, lp["moe"], x,
                                                 mesh=object(),
                                                 ep_axis="ep", tp_axis=None),
                 lambda: tf._moe_block(pcfg, lp, x, pctx)):
        with pytest.raises(NotImplementedError, match="MLA"):
            call()


def test_interleaved_rope_is_the_pair_rotation():
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((5, 3, 16), generator=gen)
    pos = torch.tensor([0, 1, 7, 300, 32000])
    theta = 1e6
    # the angles as both compute them, pos x freq in float32: at 32,000
    # the float32 product alone moves an angle by ~1e-3
    freq = theta ** (-torch.arange(0, 16, 2, dtype=torch.float32) / 16)
    assert torch.allclose(freq.double(), torch.tensor(
        [theta ** (-2 * i / 16) for i in range(8)], dtype=torch.float64),
        rtol=1e-6)
    want = torch.empty_like(x)
    for t in range(5):
        for i in range(8):
            a = (pos[t].float() * freq[i]).item()
            c, s = math.cos(a), math.sin(a)
            x0, x1 = x[t, :, 2 * i], x[t, :, 2 * i + 1]
            want[t, :, 2 * i] = x0 * c - x1 * s
            want[t, :, 2 * i + 1] = x0 * s + x1 * c
    for got in (mla.rope_interleaved(x, pos, theta),
                REF.rope_interleaved(x, pos, theta)):
        assert torch.allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# the latent pool on the paged path
# ---------------------------------------------------------------------------

def _backend(async_swap=False, spool=None):
    cfg, pcfg = toy()
    params = weights.make_params(cfg, SEED, dtype=torch.float32,
                                 device="cpu")
    return TorchBackend(pcfg, params=params, layout="paged", total_pages=16,
                        page_size=PAGE, max_slots=2, device="cpu",
                        dtype=torch.float32, async_swap=async_swap,
                        disk_spool=spool)


def test_copy_on_write_swap_and_spool_of_latent_pages(tmp_path):
    b = _backend(spool=str(tmp_path))
    impl = b._impl
    lat = impl.cache.latent
    assert impl.cache.planes == (lat,)
    lat.copy_(torch.randn(lat.shape, generator=torch.Generator()
                          .manual_seed(8)))
    impl.apply_cow([(0, 3, 11)])
    assert torch.equal(lat[:, 11], lat[:, 3])
    s = make_session(0.0, [Round(40, 4)], sid=77)
    s.meta["swap_pages"] = [(4, 0, True), (6, 0, False), (9, 0, True)]
    saved = lat[:, [4, 9]].clone()
    impl.swap_out(s)
    assert impl._host[77][0].shape == (3, 2, PAGE, 48)
    b.spill_host(77)                        # through the spool and back
    assert 77 not in impl._host
    b.fill_host(77)
    lat[:, [4, 9]] = 0.0
    s.meta["restore_positions"] = [0, 2]
    impl.swap_in(s, [12, 6, 13])
    assert torch.equal(lat[:, [12, 13]], saved)
    b.close()


def test_the_latent_pool_prices_its_bytes_at_the_published_widths():
    """55,296 B a token (48 layers x 576 bf16 values), counted on a pool
    of meta tensors: nothing is allocated."""
    pcfg = REF.program_config(published())
    cache = tf.PagedKVCache.zeros(pcfg, 7169, 32, torch.bfloat16, "meta")
    stand_in = types.SimpleNamespace(cache=cache)
    assert tr._PagedLayout.kv_bytes_per_token(stand_in) == 55296.0
    # weights alone; with the norm scales and the correction bias
    # (229,248) the checkpoint's 30,670,815,104
    assert pcfg.param_count() == 30_670_585_856
    assert REF.active_params(published()) == 3_088_842_752
    assert REF.kv_bytes_per_token_layer(published()) == 1152


def test_the_tally_counts_real_rows_and_changes_nothing(toy_model,
                                                        one_thread):
    """A pack of 13 real rows in 16 and two real lanes of four: routed
    entries (13 + 2) x top-2 x 2 MoE layers; tokens and pool as without
    the tally."""
    cfg, pcfg, params = toy_model
    P, scratch, Np = 12, 12, 4
    toks, pos, table, wp, wo, kvl = _pack(0, _tokens(13, 256).tolist(),
                                          [1, 2], 16, Np, scratch)
    d_table = torch.full((4, 2), scratch, dtype=torch.int32)
    d_table[0], d_table[1] = torch.tensor([5, 6]), torch.tensor([7, 8])
    d = [torch.tensor(a, dtype=torch.int32) for a in (
        [3, 4, 0, 0], [9, 3, 0, 0])] + [d_table] + [
        torch.tensor(a, dtype=torch.int32) for a in (
            [10, 4, 1, 1], [6, 7, scratch, scratch], [1, 3, 0, 0])]
    args = (toks[None], pos[None], table[None], wp[None], wo[None], kvl,
            torch.tensor([12], dtype=torch.int32), *d)
    outs = []
    for tally in (None, torch.zeros(2, dtype=torch.int64)):
        cache = tf.PagedKVCache.zeros(pcfg, P + 1, PAGE, torch.float32)
        p, dn, cache = tf.lm_mixed_paged(pcfg, params, cache, *args,
                                         moe_tally=tally)
        outs.append((p, dn, cache.latent))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2], outs[1][2])
    assert tally[0].item() == (13 + 2) * 2 * 2
    assert 0 < tally[1].item() <= tally[0].item()


# ---------------------------------------------------------------------------
# qwen's shared path, pinned on commit aaa3ab9
# ---------------------------------------------------------------------------

def _sums(t):
    x = t.detach().to(torch.float64).flatten()
    w = torch.arange(x.numel(), dtype=torch.float64) % 7 + 1
    return math.fsum(x.tolist()), math.fsum((x * w).tolist())


QWEN_PINS = {  # commit aaa3ab9, float32 on the CPU, one thread
    "moe": (6.540786999510601, 126.94946649833582),
    "prefill": (-149.02562654759367, -571.7164703970238),
    "decode": (5.772882713004947, -28.091746658086777),
}


def test_qwen_moe_and_paged_logits_hold_bit_for_bit(one_thread):
    cfg = QWEN.reduced()
    params = tf.init_lm(cfg, torch.Generator().manual_seed(20261018),
                        torch.float32)
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    out = layers.moe_ffn(cfg, tf.layer_params(params["layers"], 1)["moe"], x)
    P = 16
    cache = tf.PagedKVCache.zeros(cfg, P + 1, PAGE, torch.float32)
    toks = torch.randint(2, cfg.vocab_size, (1, 20), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    table = torch.tensor([3, 7, 1, P], dtype=torch.int32)
    pos = torch.arange(20, dtype=torch.int32)[None]
    logits, cache = tf.lm_prefill_paged(
        cfg, params, cache, toks, pos, table, table[pos[0] // PAGE],
        pos[0] % PAGE, torch.tensor([20], dtype=torch.int32),
        moe_tally=torch.zeros(2, dtype=torch.int64))
    lg, cache = tf.lm_decode_paged(
        cfg, params, cache, torch.tensor([9], dtype=torch.int32),
        torch.tensor([20], dtype=torch.int32), table[None, :3].contiguous(),
        torch.tensor([21], dtype=torch.int32),
        torch.tensor([1], dtype=torch.int32),
        torch.tensor([4], dtype=torch.int32))
    assert {"moe": _sums(out), "prefill": _sums(logits),
            "decode": _sums(lg)} == QWEN_PINS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    yield torch.device("cuda")
    torch.cuda.empty_cache()


H, R, DR = 32, 512, 64        # kanana's heads, latent and rope widths
CARD_PAGE = 32


def _card_pool(gen, dev, n_pages, page=CARD_PAGE):
    return (torch.randn((n_pages + 1, page, R + DR), generator=gen,
                        device=dev) * 0.5).to(torch.bfloat16)


def _shifted(table, n_pages):
    """A misaddressed table: every real page id replaced by the next one,
    the scratch entries kept."""
    return torch.where(table < n_pages, (table + 1) % n_pages, table)


def _decode_plain_without(q, pool, table, lens, lo, hi):
    """The plain decode with keys [lo, hi) of every lane left out: a
    skipped split."""
    kv = ref._mla_gather(pool, table)
    s = torch.einsum("bhd,bsd->bhs", q.float(), kv) * 0.072
    pos = torch.arange(kv.shape[1], device=q.device)
    see = (pos[None] < lens.long()[:, None]) & ~((pos >= lo) & (pos < hi))
    s = s.masked_fill(~see[:, None], float("-inf"))
    return torch.einsum("bhs,bsr->bhr", torch.softmax(s, -1),
                        kv[..., :R]).to(q.dtype)


def _excess(got, want):
    """The largest |got - want| over its limit: at most 1 passes."""
    g, w = got.float(), want.float()
    limit = (KERNEL_ATOL + KERNEL_RTOL * w.abs()).clamp(max=BF16_TOL)
    return ((g - w).abs() / limit).max().item()


def _tables(gen, dev, lengths, n_pages, maxp, page=CARD_PAGE):
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    table = torch.full((len(lengths), maxp), n_pages, dtype=torch.int32,
                       device=dev)
    at = 0
    for i, n in enumerate(lengths):
        k = -(-n // page)
        table[i, :k] = perm[at:at + k]
        at += k
    return table


@pytest.mark.card
def test_decode_kernel_against_its_plain_version(card):
    """Lengths 1 to 32,768: page edges, split edges of each call's plan,
    the longest context; then the fused write bit for bit, and every
    other page untouched. A shifted table and a skipped split (the plan's
    second) depart by more than the limit."""
    gen = torch.Generator(device=card).manual_seed(17)
    _, per = paged_mla.decode_splits(8, 1024 * CARD_PAGE)
    cases = [[1, 31, 32, 33, 63, 64, 65, 1000],
             [per - 1, per, per + 1, 2 * per + 1, 32768, 7, 12345, 20001],
             [32768]]
    for lengths in cases:
        B, maxp = len(lengths), 1024
        pool = _card_pool(gen, card, 3000)
        table = _tables(gen, card, lengths, 3000, maxp)
        lens = torch.tensor(lengths, dtype=torch.int32, device=card)
        q = torch.randn((B, H, R + DR), generator=gen,
                        device=card).to(torch.bfloat16)
        new = torch.randn((B, R + DR), generator=gen,
                          device=card).to(torch.bfloat16)
        last = (lens - 1).long()
        wp = table[torch.arange(B, device=card), last // CARD_PAGE]
        wo = (last % CARD_PAGE).int()
        plain = pool.clone()
        want = ref.paged_mla_decode_ref(q, plain, table, lens, scale=0.072,
                                        rank=R, latent_new=new,
                                        write_pages=wp, write_offsets=wo)
        got = paged_mla.paged_mla_decode(q, pool, table, lens, new, wp,
                                         wo.contiguous(), scale=0.072,
                                         rank=R)
        torch.cuda.synchronize()
        err = _excess(got, want)
        shifted = _excess(ref.paged_mla_decode_ref(
            q, plain, _shifted(table, 3000), lens, scale=0.072, rank=R),
            want)
        per_b = paged_mla.decode_splits(B, maxp * CARD_PAGE)[1]
        skipped = _excess(_decode_plain_without(q, plain, table, lens,
                                                per_b, 2 * per_b), want)
        print(f"decode {lengths}: over the limit x{err:.3f} (max abs "
              f"{(got.float() - want.float()).abs().max().item():.3e}); "
              f"shifted table x{shifted:.1f}, skipped split x{skipped:.1f}")
        assert err <= 1.0
        assert torch.equal(pool, plain)
        if max(lengths) > per_b:
            assert skipped > 1.0
        assert shifted > 1.0


def _prefill_plain(q, pool, table, kvl, q0):
    """The plain prefill, 128 tokens at a time (a 2,048-token pack's scores
    at 28,048 keys would take 7.3 GB at once)."""
    return torch.cat([ref.paged_mla_prefill_ref(
        q[:, i:i + 128], pool, table, kvl, q0 + i, scale=0.072, rank=R)
        for i in range(0, q.shape[1], 128)], 1)


@pytest.mark.card
def test_prefill_kernel_against_its_plain_version(card):
    """Packs at 0, mid-page and at the end of a 32,768-token context,
    ragged chunk lengths, two sequences in one call; 1-token packs; Sq x H
    ending partway through a 64-row block; key ranges ending one before,
    at and one after a tile edge; the cell's pack (2,048 tokens at
    26,000). Every row compared; a second call on the same inputs gives
    the same bits. A shifted table departs by more than the limit. Rows
    that see under about ten keys can exceed the limit in this kernel and
    the mma.sync kernel before it alike, at the same element (bf16 P moves
    a key's weight by up to 2^-9 of its value, not of the output's: 1.03
    times at a row of 9 keys, 1.33 on another draw of a pack at 0, both
    kernels): the first four packs, whose draws pass, keep their few-key
    rows; the cases after them see one key (a weight of exactly 1) or 71
    and more."""
    gen = torch.Generator(device=card).manual_seed(19)
    edge = 32 * paged_mla.PREFILL_KEYS
    for starts, Sq in (([0], 64), ([37, 500], 100), ([32640], 128),
                       ([3, 1000], 33), ([5000], 1), ([0, 70], 1),
                       ([100, 700], 3), ([edge - 65], 64), ([edge - 64], 64),
                       ([edge - 63], 64), ([26000], 2048)):
        kv = [s + Sq for s in starts]
        maxp = -(-max(kv) // CARD_PAGE) + 1
        pool = _card_pool(gen, card, 1100)
        table = _tables(gen, card, kv, 1100, maxp)
        q = torch.randn((len(starts), Sq, H, R + DR), generator=gen,
                        device=card).to(torch.bfloat16)
        kvl = torch.tensor(kv, dtype=torch.int32, device=card)
        q0 = torch.tensor(starts, dtype=torch.int32, device=card)
        want = _prefill_plain(q, pool, table, kvl, q0)
        got = paged_mla.paged_mla_prefill(q, pool, table, kvl, q0,
                                          scale=0.072, rank=R)
        again = paged_mla.paged_mla_prefill(q, pool, table, kvl, q0,
                                            scale=0.072, rank=R)
        torch.cuda.synchronize()
        err = _excess(got, want)
        shifted = _excess(_prefill_plain(q, pool, _shifted(table, 1100), kvl,
                                         q0), want)
        print(f"prefill {starts} + {Sq}: over the limit x{err:.3f} (max abs "
              f"{(got.float() - want.float()).abs().max().item():.3e}); "
              f"shifted table x{shifted:.1f}")
        assert err <= 1.0
        assert torch.equal(got, again)
        assert shifted > 1.0


@pytest.mark.card
def test_prefill_kernel_takes_the_page_sizes_its_boxes_fit(card):
    """A TMA box holds one page's rows of a key tile, so the prefill takes
    a page size that is a multiple of 8 and divides PREFILL_KEYS or is a
    multiple of it: pages of 8, 16, 64 and 128 agree with the plain
    version within the limit (two sequences, ragged, tiles spanning pages
    or within one); 12, 24 and 48 are refused before any launch."""
    gen = torch.Generator(device=card).manual_seed(23)
    starts, Sq = [37, 500], 100
    kv = [s + Sq for s in starts]
    for page in (8, 16, 64, 128):
        n_pages = 35200 // page
        maxp = -(-max(kv) // page) + 1
        pool = _card_pool(gen, card, n_pages, page)
        table = _tables(gen, card, kv, n_pages, maxp, page)
        q = torch.randn((len(starts), Sq, H, R + DR), generator=gen,
                        device=card).to(torch.bfloat16)
        kvl = torch.tensor(kv, dtype=torch.int32, device=card)
        q0 = torch.tensor(starts, dtype=torch.int32, device=card)
        got = paged_mla.paged_mla_prefill(q, pool, table, kvl, q0,
                                          scale=0.072, rank=R)
        err = _excess(got, _prefill_plain(q, pool, table, kvl, q0))
        print(f"prefill at page {page}: over the limit x{err:.3f}")
        assert err <= 1.0
    for page in (12, 24, 48):
        pool = torch.zeros((4, page, R + DR), dtype=torch.bfloat16,
                           device=card)
        with pytest.raises(ValueError, match="page size"):
            paged_mla.paged_mla_prefill(q, pool, table, kvl, q0, scale=0.072,
                                        rank=R)


def _card_config():
    """Kanana's attention widths (32 heads, 512 + 64 latent, 128 + 64
    query heads, 128 values), narrow everywhere else."""
    cfg = dict(published(), num_hidden_layers=3, hidden_size=256,
               intermediate_size=256, moe_intermediate_size=64,
               n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
               vocab_size=512)
    return cfg, REF.program_config(cfg)


@pytest.mark.card
def test_a_captured_stage_replays_equal_to_eager(card):
    """Three mixed iterations through ``run_mixed`` (eager, captured,
    replayed): each equals eager ``lm_mixed_paged`` over the same arrays
    on a copy of the pool, bit for bit but the scratch page, with the
    same launches of both MLA kernels."""
    cfg, pcfg = _card_config()
    params = weights.make_params(cfg, SEED, dtype=torch.bfloat16,
                                 device=card)
    b = TorchBackend(pcfg, params=params, layout="paged", total_pages=64,
                     page_size=CARD_PAGE, max_slots=4, device=card,
                     dtype=torch.bfloat16)
    impl = b._impl
    assert impl.graphs is not None
    built = []
    inner = impl._mixed_inputs

    def mixed_inputs(work):
        got = inner(work)
        built.append(got[-1])
        return got
    impl._mixed_inputs = mixed_inputs
    from repro_torch.engine.backend import BatchWork
    packs = [make_session(0.0, [Round(300, 4)], sid=i) for i in range(2)]
    leases = {0: tuple(range(0, 12)), 1: tuple(range(12, 24)),
              10: tuple(range(24, 30))}
    lane = make_session(0.0, [Round(90, 8)], sid=10)
    lane.resident_len, lane.meta["next_token"] = 90, 5
    for it in range(3):
        copy = mla.LatentPagedKVCache(impl.cache.latent.clone())
        work = BatchWork(decodes=[(lane, 1)], prefills=[(s, 100) for s in
                                                        packs], swapins=[],
                         mixed=True)
        work.leases.update(leases)
        before = [f.launches for f in tr._COUNTED]
        spans.enable()
        b.run_batch(work, 0.0)
        sp, _ = spans.drain()
        spans.disable()
        graphed = [f.launches - n for f, n in zip(tr._COUNTED, before)]
        p = [s.meta["next_token"] for s in packs]
        d = [lane.meta["generated"][-1]]
        before = [f.launches for f in tr._COUNTED]
        ep, ed, copy = tf.lm_mixed_paged(pcfg, b.params, copy, *built[-1])
        eager = [f.launches - n for f, n in zip(tr._COUNTED, before)]
        torch.cuda.synchronize()
        assert ep[:2].tolist() == p and ed[:1].tolist() == d
        keep = [i for i in range(65) if i != impl.scratch]
        assert torch.equal(copy.latent[:, keep], impl.cache.latent[:, keep])
        assert graphed == eager and graphed[2] > 0 and graphed[3] > 0
        counts = [s.counts for s in sp if s.name == "run_mixed"][0]
        assert counts["moe_entries_routed"] == (200 + 1) * 2 * 2
        for s in packs:
            s.resident_len += 100
        lane.resident_len += 1
    assert impl.graphs.counts[tr.REPLAYED] >= 2
    b.close()


def test_the_prefill_launches_carry_the_metric_s_name_and_shapes_agree():
    """``mla_prefill_roofline`` finds the prefill's device time by the
    substring ``paged_mla_prefill_kernel``: every kernel that
    ``paged_mla_prefill`` launches carries it. The wrapper's widths and
    block shapes equal ``paged_mla_shape``'s table in the source."""
    import re
    src_path = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                            "paged_mla.cu")
    with open(src_path) as f:
        src = f.read()
    kernels = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s+)?(\w+)\s*\(", src))
    body = src[src.index("int paged_mla_prefill("):]
    body = body[:body.index("\n}\n")]
    launched = re.findall(r"(\w+)\s*(?:<[^<>]*>)?\s*<<<", body)
    assert launched and set(launched) <= kernels
    assert all("paged_mla_prefill_kernel" in k for k in launched)
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    table = re.search(r"int paged_mla_shape\(int i\) \{\s*const int "
                      r"v\[(\d+)\] = \{([^}]*)\}", src)
    names = [n.strip() for n in table.group(2).split(",")]
    assert int(table.group(1)) == len(names)
    assert [consts[n] for n in names] == [
        paged_mla.RANK, paged_mla.ROPE, paged_mla.DECODE_HEADS,
        paged_mla.DECODE_KEYS, paged_mla.PREFILL_ROWS, paged_mla.PREFILL_KEYS]


def test_the_card_tests_name_the_published_widths():
    cfg, pcfg = _card_config()
    assert (pcfg.n_heads, pcfg.mla.kv_lora_rank,
            pcfg.mla.qk_rope_head_dim) == (H, R, DR)
    assert np.isclose(mla.scale(pcfg), 192 ** -0.5)
