"""Shared functional layers of the serving paths: norms, RoPE, GQA
projections, (gated) MLP, the capacity-dispatched MoE FFN, the
position-driven dense attention of the JAX package and the attention kernel
calls.

Everything is a plain function of ``(params, inputs)``; parameters are
dicts of tensors, as in ``repro.models.layers``. Where the JAX package asks
XLA for float32 outputs of a matmul (``preferred_element_type=F32``) and
casts afterwards, these functions do the same through :func:`matmul_f32`,
so bf16 results round at the same places. The large projections stay
ordinary library matmuls, as the JAX package left them to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
F32 = torch.float32
NEG_INF = -1e30


def _product_f32(x, w):
    if x.is_cuda:
        mm = torch.mm if x.dim() == 2 else torch.bmm
        return mm(x, w, out_dtype=F32)
    return torch.matmul(x.to(F32), w.to(F32))


def _product(x, w):
    """Through the Function only where autograd records the product: the
    serving paths keep the plain call."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ProductF32.apply(x, w)
    return _product_f32(x, w)


class _ProductF32(torch.autograd.Function):
    """``x @ w`` (2-D, or batched 3-D) of low-precision operands with a
    float32 result and float32 accumulation. Forward on the card: one
    library product with ``out_dtype=float32``, which autograd cannot
    differentiate; on the CPU the operands are cast to float32 first.
    Backward, on both: the float32 cotangent times the other operand cast
    to float32 (library products), each gradient cast to its operand's
    dtype. That is JAX's transpose of a ``dot_general`` with
    ``preferred_element_type=F32``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, w.to(F32).transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.matmul(x.to(F32).transpose(-1, -2), g).to(w.dtype)
        return gx, gw


def matmul_f32(x, w):
    """``x @ w`` with a float32 result and float32 accumulation: the
    counterpart of ``jnp.einsum(..., preferred_element_type=F32)``.
    x: (..., K); w: (K, N)."""
    if x.dtype == F32 and w.dtype == F32:
        return x @ w
    out = _product(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def bmm_f32(x, w):
    """Batched ``x @ w`` with a float32 result and float32 accumulation:
    the counterpart of ``jnp.einsum("ecd,edf->ecf", ...,
    preferred_element_type=F32)``. x: (E, C, K); w: (E, K, N)."""
    if x.dtype == F32 and w.dtype == F32:
        return torch.bmm(x, w)
    return _product(x, w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with the ``(1 + scale)`` convention of the JAX package."""
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return ((1.0 + scale.to(F32)) * y).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Params, x):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Split-half rotation (not interleaved), computed in float32."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    angles = positions[..., None].to(F32) * freq          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.split(x.to(F32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window / softcap), dense-KV formulation.
# Plain PyTorch, as the JAX package keeps it plain jnp: the dense layout's
# decode step runs it (one row per slot, each at its own position, which
# the flash kernel's single q_offset does not cover).
# ---------------------------------------------------------------------------

def attention_scores_mask(q_pos, kv_pos, *, causal: bool,
                          window: Optional[int], kv_valid=None):
    """Boolean mask (..., Sq, Skv); True = attend."""
    m = torch.ones(q_pos.shape[-1:] + kv_pos.shape[-1:], dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m = m & (q_pos[..., :, None] - kv_pos[..., None, :] < window)
    if kv_valid is not None:
        m = m & kv_valid[..., None, :]
    return m


def mha(q, k, v, mask, *, softcap: Optional[float] = None,
        scale: Optional[float] = None):
    """Grouped-query attention without materializing repeated KV.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); mask: (B, Sq, Skv) or (Sq, Skv).
    """
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32),
                          k.to(F32)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if mask.dim() == 2:
        mask = mask[None]
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(F32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _block_mask(q_pos, kv_pos, kv_valid, *, causal: bool,
                window: Optional[int], is_local: Optional[bool]):
    """Mask for one q block, computed from positions. q_pos: (B, Cq);
    kv_pos: (B, Skv). ``is_local=False`` switches the window off (a global
    layer of the gemma2 alternation); None keeps it."""
    if causal:
        m = kv_pos[:, None, :] <= q_pos[..., None]
    else:
        m = torch.ones(q_pos.shape + kv_pos.shape[-1:], dtype=torch.bool,
                       device=q_pos.device)
    if window is not None and is_local is not False:
        m = m & (q_pos[..., None] - kv_pos[:, None, :] < window)
    if kv_valid is not None:
        m = m & kv_valid[:, None, :]
    return m


def attention(q, k, v, q_pos, kv_pos, *, kv_valid=None, causal: bool = True,
              window: Optional[int] = None, is_local: Optional[bool] = None,
              softcap: Optional[float] = None, q_chunk: int = 2048):
    """Position-driven GQA attention, blocked over the query dimension so
    the score/mask working set is O(q_chunk * Skv), not O(Sq * Skv).

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); q_pos: (B, Sq); kv_pos:
    (B, Skv). ``is_local``: the per-layer flag of the gemma2 alternation
    (a Python bool here; a traced 0/1 scalar in the JAX package).
    """
    B, Sq, H, D = q.shape
    if Sq <= q_chunk or Sq % q_chunk != 0:
        mask = _block_mask(q_pos, kv_pos, kv_valid, causal=causal,
                           window=window, is_local=is_local)
        return mha(q, k, v, mask, softcap=softcap)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        mask = _block_mask(q_pos[:, c0:c0 + q_chunk], kv_pos, kv_valid,
                           causal=causal, window=window, is_local=is_local)
        outs.append(mha(q[:, c0:c0 + q_chunk], k, v, mask, softcap=softcap))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Attention projections and the attention kernel calls
# ---------------------------------------------------------------------------

def dense_prefill_attention(q, k, v, *, window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            q_offset: int = 0, causal: bool = True):
    """Full-sequence or chunked-prefill attention of one batch whose rows
    all start at the host-side ``q_offset`` (row ``i`` at ``q_offset +
    i``): causal, or with ``causal=False`` every row over every key (an
    encoder, or a cross-attention with Sq != Skv).

    q: (B, Sq, Hq, D) **model layout**; k/v: (B, Skv, Hkv, D), e.g. a
    dense cache slot. Returns (B, Sq, Hq, D). All three reach the flash
    kernel as transposed views: nothing is copied."""
    from repro_torch.kernels import ops            # lazy: keeps layers cheap
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset)
    return o.transpose(1, 2)


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           k_new=None, v_new=None, write_pages=None,
                           write_offsets=None):
    """Single-token decode attention over a paged KV pool.

    q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); block_table: (B, max_pages)
    int32 device page ids in token order; lengths: (B,) valid kv tokens.
    Runs the Hopper ``paged_attention`` kernels on a CUDA tensor and their
    plain versions on a CPU tensor. No sliding window or softcap: the paged
    layout is gated on configs without them.

    With ``k_new/v_new (B, Hkv, D)`` + ``write_pages/write_offsets (B,)``
    the new token's KV write is fused into the call (slot contract:
    position ``lengths - 1``), the pools are updated in place, and the
    result is ``(o, k_pages, v_pages)``.
    """
    from repro_torch.kernels import ops            # lazy: keeps layers cheap
    return ops.decode_attention(q, k_pages, v_pages, block_table, lengths,
                                k_new=k_new, v_new=v_new,
                                write_pages=write_pages,
                                write_offsets=write_offsets)


def paged_prefill_attention(q, k_pages, v_pages, block_table, kv_len,
                            q_offset):
    """Gather-free chunked-prefill attention over a paged KV pool.

    q: (B, Sq, Hq, D) **model layout**; k/v_pages: (P, page, Hkv, D);
    block_table: (B, Np) int32 pool pages in token order (scratch-padded);
    kv_len: (B,) valid kv tokens (the chunk's own KV already scattered in);
    q_offset: (B,) absolute position of each row's first query. Returns
    (B, Sq, Hq, D). The kernel reads pages in place through the table.
    """
    from repro_torch.kernels import ops            # lazy: keeps layers cheap
    o = ops.prefill_attention(q.transpose(1, 2).contiguous(), k_pages,
                              v_pages, block_table, kv_len, q_offset)
    return o.transpose(1, 2)


def attn_qkv(cfg: ModelConfig, p: Params, x, positions, *, use_rope=True):
    B, S, D = x.shape
    q = matmul_f32(x, p["wq"])
    k = matmul_f32(x, p["wk"])
    v = matmul_f32(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(F32)
        k = k + p["bk"].to(F32)
        v = v + p["bv"].to(F32)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim_).to(x.dtype)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim_).to(x.dtype)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim_).to(x.dtype)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p: Params, o):
    B, S, H, Dh = o.shape
    return matmul_f32(o.reshape(B, S, H * Dh), p["wo"]).to(o.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(name: str):
    gelu = (lambda x: F.gelu(x, approximate="tanh"))
    return {"silu": F.silu, "gelu": gelu, "gelu_tanh": gelu,
            "relu": F.relu}[name]


def mlp(cfg: ModelConfig, p: Params, x):
    act = _act(cfg.act)
    up = matmul_f32(x, p["w_up"])
    if cfg.gated_mlp:
        gate = matmul_f32(x, p["w_gate"])
        h = act(gate) * up
    else:
        h = act(up)
    h = h.to(x.dtype)
    return matmul_f32(h, p["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE: capacity-based dispatch (GShard-style, scatter formulation), as in
# the JAX package. Every function is free of host syncs and of shapes that
# depend on the data: the capacity comes from shapes alone, overflowing
# entries go to a dump row instead of being filtered out.
# ---------------------------------------------------------------------------

def _route(moe, logits):
    """logits (T, E) -> (topk_idx (T, K) int64, topk_w (T, K) normalised).
    ``torch.topk`` sorted descending, as ``lax.top_k``."""
    probs = torch.softmax(logits.to(F32), dim=-1)
    w, idx = torch.topk(probs, moe.top_k, dim=-1, largest=True, sorted=True)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
    return idx, w


def _dispatch(x, idx, w, num_experts: int, capacity: int):
    """Scatter tokens into per-expert capacity buffers.

    x: (T, D); idx/w: (T, K). Returns buf (E, C, D) and the gather metadata
    (flat_e, pos_c, keep), each (T*K,). An entry's slot is its rank among
    the entries routed to its expert in token-major, k-minor order (the
    order of JAX's scan, which decides who overflows); entries ranked past
    ``capacity`` land in the dump row ``capacity`` and are dropped. The
    one-hot is held expert-major, (E, T*K), so that the rank scan runs
    along its contiguous rows: a scan down the columns of (T*K, E) is a
    slow kernel on the card.
    """
    T, D = x.shape
    K = idx.shape[1]
    flat_e = idx.reshape(-1)                                   # (T*K,)
    onehot = torch.zeros((num_experts, T * K), dtype=torch.int32,
                         device=x.device).scatter_(0, flat_e[None], 1)
    ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = ranks.gather(0, flat_e[None])[0].long() - 1          # (T*K,)
    keep = pos < capacity
    pos_c = torch.where(keep, pos, capacity)       # overflow -> dump row
    buf = torch.zeros((num_experts, capacity + 1, D), dtype=x.dtype,
                      device=x.device)
    src = x.repeat_interleave(K, dim=0)                        # (T*K, D)
    buf.index_put_((flat_e, pos_c), src, accumulate=True)
    return buf[:, :capacity], (flat_e, pos_c, keep)


def _combine(expert_out, meta, w, T: int):
    """expert_out (E, C, D) -> (T, D): each token's kept entries, weighted
    by their route weights and summed over its K choices."""
    flat_e, pos_c, keep = meta
    K = w.shape[1]
    E, C, D = expert_out.shape
    padded = torch.cat([expert_out, expert_out.new_zeros((E, 1, D))], dim=1)
    gathered = padded[flat_e, pos_c]                           # (T*K, D)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    gathered = gathered.reshape(T, K, D) * w[..., None].to(expert_out.dtype)
    return torch.sum(gathered, dim=1)


def _expert_ffn(cfg: ModelConfig, p: Params, buf):
    """buf (E, C, D) -> (E, C, D) through each expert's gated MLP."""
    act = _act(cfg.act)
    g = bmm_f32(buf, p["w_gate"])
    u = bmm_f32(buf, p["w_up"])
    h = (act(g) * u).to(buf.dtype)
    return bmm_f32(h, p["w_down"]).to(buf.dtype)


def moe_ffn(cfg: ModelConfig, p: Params, x):
    """Single-device MoE FFN. x: (B, S, D), every row of it routed, padded
    lanes included (they count towards the capacity, as in JAX). The
    sharding arguments of the JAX function (``pctx``, ``token_shard``)
    only act under a mesh and are not ported."""
    m = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    logits = matmul_f32(xt, p["router"])
    idx, w = _route(m, logits)
    capacity = max(8, int(B * S * m.top_k / m.num_experts
                          * m.capacity_factor))
    buf, meta = _dispatch(xt, idx, w, m.num_experts, capacity)
    out = _expert_ffn(cfg, p, buf)
    return _combine(out, meta, w, B * S).reshape(B, S, D)
