"""Plain PyTorch versions of the Hopper kernels (attention, MLA attention
over a latent page pool, and WKV6).

They mirror ``repro.kernels.ref`` op for op (f32 einsum, scale applied
after the einsum, softcap before the mask, ``-1e30`` mask value, softmax;
the WKV6 recurrence step by step in f32) and are the ground truth the
Hopper kernels are held against: the CPU
tests compare them with the JAX oracles, and ``chip_smoke.py`` compares
each kernel with them on the card. On a CPU tensor the kernel wrappers
call these directly. ``wkv6_chunked`` is the JAX model's chunked form of
the recurrence: the ``wkv6`` kernel's backward recomputes it, since the
step-by-step ``wkv6_ref`` is too slow at training lengths. The MLA
versions (``paged_mla_*_ref``, and ``mla_expanded_ref``, the published
form they are held to) have no JAX counterpart: the CPU tests compare
them with ``mars_bench/arch/mla.py``'s reference.
"""
from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D). Returns (B, Hq, Sq, D).

    ``q_offset`` positions the queries at kv index ``q_offset + i``
    (chunked prefill: queries are the tail of the kv sequence).
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.to(F32).reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(F32)) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(F32))
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_table, lengths):
    """Decode attention over paged KV.

    q: (B, Hq, D); k_pages/v_pages: (P, page, Hkv, D);
    block_table: (B, max_pages) int32; lengths: (B,) int32 (valid kv tokens).
    Returns (B, Hq, D).
    """
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    max_pages = block_table.shape[1]
    G = Hq // Hkv
    tbl = block_table.long()
    k = k_pages[tbl].reshape(B, max_pages * page, Hkv, D)
    v = v_pages[tbl].reshape(B, max_pages * page, Hkv, D)
    qf = q.to(F32).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.to(F32)) * (D ** -0.5)
    pos = torch.arange(max_pages * page, device=q.device)
    valid = pos[None] < lengths.to(pos.device)[:, None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.to(F32))
    return o.reshape(B, Hq, D).to(q.dtype)


def paged_flash_attention_ref(q, k_pages, v_pages, block_table, kv_len,
                              q_offset):
    """Chunked-prefill attention over paged KV (plain version of
    ``paged_flash_attention``: this one gathers ``pages[table]``; it is the
    ground truth and the CPU path, not the hot path).

    q: (B, Hq, Sq, D); k/v_pages: (P, page, Hkv, D); block_table: (B, Np)
    int32; kv_len: (B,) int32 valid kv tokens; q_offset: (B,) int32 absolute
    position of each row's first query. Returns (B, Hq, Sq, D).

    Mask: ``kv_pos <= q_offset + i`` and ``kv_pos < kv_len``; masked scores
    take ``-1e30`` before the softmax, as in ``models.layers.mha``.
    """
    B, Hq, Sq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    Np = block_table.shape[1]
    G = Hq // Hkv
    S = Np * page
    tbl = block_table.long()
    k = k_pages[tbl].reshape(B, S, Hkv, D)          # model (B, Skv, Hkv, D)
    v = v_pages[tbl].reshape(B, S, Hkv, D)
    qm = q.transpose(1, 2)                           # model (B, Sq, Hq, D)
    qg = qm.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32),
                          k.to(F32)) * (D ** -0.5)
    dev = q.device
    q_pos = q_offset.to(dev).long()[:, None] + torch.arange(Sq, device=dev)
    kv_pos = torch.arange(S, device=dev)
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) & \
           (kv_pos[None, None, :] < kv_len.to(dev).long()[:, None, None])
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(F32))
    out = out.reshape(B, Sq, Hq, D).to(q.dtype)
    return out.transpose(1, 2)


def _mla_gather(latent_pages, block_table):
    """(B, Np * page, R + Dr) float32: each row's pages in token order."""
    B, Np = block_table.shape
    page = latent_pages.shape[1]
    return latent_pages[block_table.long()].reshape(B, Np * page, -1).to(F32)


def paged_mla_decode_ref(q, latent_pages, block_table, lengths, *, scale,
                         rank: int, latent_new=None, write_pages=None,
                         write_offsets=None):
    """Absorbed MLA decode over a latent page pool (plain version of
    ``paged_mla_decode``).

    q: (B, H, R + Dr) absorbed queries ``[q_nope W_uk^T | q_pe]``;
    latent_pages: (P, page, R + Dr) rows ``[c | k_pe]``; block_table:
    (B, max_pages) int32; lengths: (B,) valid keys. Every head scores
    every latent row over all R + Dr values and sums the rows' first
    ``rank`` values. With ``latent_new`` (B, R + Dr) and ``write_pages``/
    ``write_offsets`` (B,) the new rows are written first, in place.
    Returns (B, H, R) in q's dtype.
    """
    if latent_new is not None:
        latent_pages.index_put_((write_pages.long(), write_offsets.long()),
                                latent_new)
    kv = _mla_gather(latent_pages, block_table)             # (B, S, R+Dr)
    s = torch.einsum("bhd,bsd->bhs", q.to(F32), kv) * scale
    pos = torch.arange(kv.shape[1], device=q.device)
    valid = pos[None] < lengths.to(q.device).long()[:, None]
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1),
                     kv[..., :rank])
    return o.to(q.dtype)


def paged_mla_prefill_ref(q, latent_pages, block_table, kv_len, q_offset, *,
                          scale, rank: int):
    """Absorbed MLA chunked prefill over a latent page pool (plain version
    of ``paged_mla_prefill``).

    q: (B, Sq, H, R + Dr) absorbed queries; latent_pages, block_table as
    ``paged_mla_decode_ref``'s; kv_len/q_offset: (B,) int32. Mask: ``kv_pos
    <= q_offset + i`` and ``kv_pos < kv_len``. Returns (B, Sq, H, R).
    """
    B, Sq = q.shape[:2]
    kv = _mla_gather(latent_pages, block_table)
    s = torch.einsum("bqhd,bsd->bhqs", q.to(F32), kv) * scale
    dev = q.device
    q_pos = q_offset.to(dev).long()[:, None] + torch.arange(Sq, device=dev)
    kv_pos = torch.arange(kv.shape[1], device=dev)
    mask = (kv_pos[None, None] <= q_pos[:, :, None]) & \
           (kv_pos[None, None] < kv_len.to(dev).long()[:, None, None])
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bhqs,bsr->bqhr", torch.softmax(s, dim=-1),
                     kv[..., :rank])
    return o.to(q.dtype)


def mla_expanded_ref(q_nope, q_pe, rows, w_kv_b, mask, *, scale):
    """MLA attention as published, the oracle of the absorbed form:
    ``[k_nope | v] = c W_kv_b`` per head, scores ``q_nope . k_nope +
    q_pe . k_pe``, values ``v``.

    q_nope: (B, Sq, H, Dn); q_pe: (B, Sq, H, Dr); rows: (B, S, R + Dr)
    latent rows ``[c | k_pe]``; w_kv_b: (R, H * (Dn + Dv)); mask: (B, Sq,
    S) bool, True = attend. Returns (B, Sq, H, Dv) float32.
    """
    B, Sq, H, Dn = q_nope.shape
    Dr = q_pe.shape[-1]
    R = rows.shape[-1] - Dr
    kv = (rows[..., :R].to(F32) @ w_kv_b.to(F32)).reshape(B, -1, H,
                                                          w_kv_b.shape[1]
                                                          // H)
    s = (torch.einsum("bqhd,bshd->bhqs", q_nope.to(F32), kv[..., :Dn])
         + torch.einsum("bqhd,bsd->bhqs", q_pe.to(F32),
                        rows[..., R:].to(F32))) * scale
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    return torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, dim=-1),
                        kv[..., Dn:])


def wkv6_ref(r, k, v, w, u, state):
    """Sequential WKV6 recurrence (the mathematical definition).

    r/k/v/w: (B, T, H, K); u: (H, K); state: (B, H, K, K) f32.
    Returns (o (B, T, H, K) f32, final state (B, H, K, K) f32).
        o_t = r_t @ S_{t-1} + (r_t . (u*k_t)) v_t
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    rf, kf, vf, wf = (a.to(F32) for a in (r, k, v, w))
    uf = u.to(F32)
    S = state.to(F32)
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]   # (B, H, K)
        o = torch.einsum("bhk,bhkv->bhv", rt, S) + \
            torch.einsum("bhk,bhk->bh", rt, uf[None] * kt)[..., None] * vt
        S = wt[..., None] * S + torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(o)
    o = torch.stack(outs, dim=1) if outs else rf.new_zeros(r.shape)
    return o, S


def wkv6_chunked(r, k, v, w, u, state, chunk: int = 32):
    """r,k,v,w: (B, T, H, K) [w in (0,1)]; u: (H, K); state: (B, H, K, K)
    f32. Returns (o (B,T,H,K) f32, new state). T must be a multiple of
    ``chunk``.

    The chunked form of the JAX model, op for op: the intra-chunk term
    factors exp(cum_{t-1} - cum_i) into two factors, each centred by half
    the chunk's total log-decay, and the masked triangle is zeroed with
    ``where`` (an inf times 0 would give NaN)."""
    B, T, H, K = r.shape
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    n_chunks = T // chunk
    shp = (B, n_chunks, chunk, H, K)
    rs, ks_, vs = (a.to(F32).reshape(shp) for a in (r, k, v))
    lw = torch.log(torch.clamp(w.to(F32), 1e-12, 1.0)).reshape(shp)
    uf = u.to(F32)
    S = state.to(F32)
    ti = torch.arange(chunk, device=r.device)
    tri = ti[None, :] < ti[:, None]              # strictly lower triangular
    outs = []
    for c in range(n_chunks):
        rc, kc, vc, lwc = rs[:, c], ks_[:, c], vs[:, c], lw[:, c]
        cum = torch.cumsum(lwc, dim=1)           # inclusive decay logs
        r_dec = rc * torch.exp(cum - lwc)        # decay excludes current step
        o_inter = torch.einsum("bchk,bhkv->bchv", r_dec, S)
        half = 0.5 * cum[:, -1:]                 # centring offset (B,1,H,K)
        q_ = rc * torch.exp(cum - lwc - half)
        k_ = kc * torch.exp(half - cum)
        att = torch.einsum("bchk,bihk->bhci", q_, k_)
        att = torch.where(tri[None, None], att, torch.zeros_like(att))
        o_intra = torch.einsum("bhci,bihv->bchv", att, vc)
        bonus = torch.einsum("bchk,bchk->bch", rc, uf[None, None] * kc)
        outs.append(o_inter + o_intra + bonus[..., None] * vc)
        total = cum[:, -1]                       # (B, H, K)
        k_dec = kc * torch.exp(total[:, None] - cum)
        S = torch.exp(total)[..., None] * S + \
            torch.einsum("bchk,bchv->bhkv", k_dec, vc)
    o = torch.stack(outs, dim=1).reshape(B, T, H, K)
    return o, S
