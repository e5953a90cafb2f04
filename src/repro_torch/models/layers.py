"""Shared functional layers of the paged serving path: norms, RoPE, GQA
projections, (gated) MLP and the paged attention calls.

Everything is a plain function of ``(params, inputs)``; parameters are
dicts of tensors, as in ``repro.models.layers``. Where the JAX package asks
XLA for float32 outputs of a matmul (``preferred_element_type=F32``) and
casts afterwards, these functions do the same through :func:`matmul_f32`,
so bf16 results round at the same places. The large projections stay
ordinary library matmuls, as the JAX package left them to XLA.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
F32 = torch.float32


def matmul_f32(x, w):
    """``x @ w`` with a float32 result and float32 accumulation: the
    counterpart of ``jnp.einsum(..., preferred_element_type=F32)``.
    x: (..., K); w: (K, N)."""
    if x.dtype == F32 and w.dtype == F32:
        return x @ w
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=F32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(F32) @ w.to(F32)


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
# Attention projections and the paged attention calls
# ---------------------------------------------------------------------------

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
