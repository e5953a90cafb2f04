"""Plain PyTorch versions of the paged attention kernels.

They mirror ``repro.kernels.ref`` op for op (f32 einsum, scale applied
after the einsum, ``-1e30`` mask value, softmax) and are the ground truth
the Hopper kernels are held against: the CPU tests compare them with the
JAX oracles, and ``chip_smoke.py`` compares each kernel with them on the
card. On a CPU tensor the kernel wrappers call these directly.
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


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
