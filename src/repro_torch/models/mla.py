"""Multi-head latent attention (MLA) decoders with sigmoid-routed experts:
DeepSeek-V3's block as ``kanana-2-30b-a3b`` publishes it (``model_type``
``deepseek_v3``, no ``q_lora_rank``). The JAX package has no counterpart.

One MLA layer, per token ``h`` (D wide):

- ``q = h W_q``, (H, Dn + Dr): ``q_nope`` (Dn) and ``q_pe`` (Dr);
- ``[c | k_pe] = h W_kv_a``, (R + Dr); ``c = RMSNorm(c)``;
- ``[k_nope | v] = c W_kv_b``, (H, Dn + Dv);
- interleaved RoPE (pairs ``(2i, 2i + 1)`` at ``theta^(-2i / Dr)``) on
  ``q_pe`` and on the one ``k_pe`` head every query head shares;
- causal attention at scale ``(Dn + Dr)^-1/2`` over ``[k_nope | k_pe]``,
  values ``v``; then ``o W_o``.

The page pool holds one plane of ``R + Dr`` values a token and layer,
``[c | rope(k_pe)]`` (``LatentPagedKVCache``), in place of K and V per
head. Served attention runs the absorbed form over it: each head's query
``q~ = [q_nope W_uk^T | q_pe]`` (``W_uk``, ``W_uv``: the key and value
halves of ``W_kv_b``) scores the latent rows directly, the weighted sum of
the latent rows (R wide) is lifted by ``W_uv`` to Dv. The full-sequence
path (``lm_forward``) expands ``k_nope`` and ``v`` as published.

Layers ``0 .. first_k_dense_replace - 1`` carry a dense SiLU-gated MLP
(``params["dense"]``), the rest the MoE FFN (``params["moe"]``): a sigmoid
router whose choice adds a per-expert correction bias and whose weights do
not, renormalised and scaled by ``routed_scaling_factor``, the program's
capacity dispatch, and a shared MLP of ``n_shared_experts * d_ff_expert``
that every token runs (``layers.moe_ffn``). With ``n_group`` 1 the
published group selection keeps every expert, so none is made.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (F32, attn_out, bmm_f32, matmul_f32,
                                       rms_norm, split_heads)
from repro_torch.obs import spans


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """The latent attention, the leading dense layers, the shared experts
    and the router (the published ``deepseek_v3`` keys)."""
    kv_lora_rank: int = 512            # R: the latent's width
    qk_nope_head_dim: int = 128        # Dn
    qk_rope_head_dim: int = 64         # Dr
    v_head_dim: int = 128              # Dv
    first_k_dense_replace: int = 1     # leading dense layers
    n_shared_experts: int = 2          # one shared MLP of n * d_ff_expert
    routed_scaling_factor: float = 2.448
    norm_topk_prob: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values of one pool row: the normed latent, then the roped key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class MLAModelConfig(ModelConfig):
    """A ``moe`` decoder whose attention is MLA (``mla``). ``d_ff`` is the
    leading dense layers' width, ``head_dim`` the query head's
    (``Dn + Dr``)."""
    mla: Optional[MLAConfig] = None

    def param_count(self, active_only: bool = False) -> int:
        m, e = self.mla, self.moe
        D, H, L = self.d_model, self.n_heads, self.n_layers
        k = m.first_k_dense_replace
        attn = (D * H * m.qk_head_dim + D * m.latent_dim
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * D)
        expert = 3 * D * e.d_ff_expert
        moe = (D * e.num_experts + m.n_shared_experts * expert
               + (e.top_k if active_only else e.num_experts) * expert)
        embed = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        return embed + L * attn + k * 3 * D * self.d_ff + (L - k) * moe


def is_mla(cfg: ModelConfig) -> bool:
    return getattr(cfg, "mla", None) is not None


@dataclasses.dataclass
class LatentPagedKVCache:
    """The MLA page pool: ``latent`` (L, P+1, page, R + Dr), one row a
    token and layer, updated in place by the ``lm_*_paged`` functions.
    ``planes`` is ``(latent,)``, as a GQA pool's is ``(k, v)``."""
    latent: torch.Tensor

    @property
    def planes(self):
        return (self.latent,)

    @property
    def page_size(self) -> int:
        return self.latent.shape[2]

    @property
    def n_pages(self) -> int:
        return self.latent.shape[1]

    @classmethod
    def zeros(cls, cfg: MLAModelConfig, n_pages: int, page: int,
              dtype=torch.bfloat16, device="cpu"):
        return cls(torch.zeros((cfg.n_layers, n_pages, page,
                                cfg.mla.latent_dim), dtype=dtype,
                               device=device))


def init_params(cfg: MLAModelConfig, nrm, norm, dtype, device):
    """Random weights for ``transformer.init_lm``: ``nrm(shape, scale)``
    draws, ``norm(lead, dim)`` makes norm scales. Per-layer weights are
    stacked: attention and norms over every layer under ``"layers"``, the
    dense MLPs over the leading ``k`` under ``"dense"``, the MoE layers'
    router, correction bias, experts and shared MLP over the other
    ``L - k`` under ``"moe"``."""
    m, e = cfg.mla, cfg.moe
    D, H, L = cfg.d_model, cfg.n_heads, cfg.n_layers
    k, R = m.first_k_dense_replace, m.kv_lora_rank
    Lm, E, Fe = (L - k,), e.num_experts, e.d_ff_expert
    Fs = m.n_shared_experts * Fe
    hq, hv = H * m.qk_head_dim, H * m.v_head_dim
    attn = {"wq": nrm((L, D, hq), D ** -0.5),
            "wkv_a": nrm((L, D, m.latent_dim), D ** -0.5),
            "kv_norm": norm((L,), R),
            "wkv_b": nrm((L, R, H * (m.qk_nope_head_dim + m.v_head_dim)),
                         R ** -0.5),
            "wo": nrm((L, hv, D), hv ** -0.5)}
    params = {
        "embed": nrm((cfg.vocab_size, D), D ** -0.5),
        "layers": {"ln_attn": norm((L,), D), "attn": attn,
                   "ln_mlp": norm((L,), D)},
        "dense": {"w_gate": nrm((k, D, cfg.d_ff), D ** -0.5),
                  "w_up": nrm((k, D, cfg.d_ff), D ** -0.5),
                  "w_down": nrm((k, cfg.d_ff, D), cfg.d_ff ** -0.5)},
        "moe": {"router": nrm((*Lm, D, E), D ** -0.5),
                "bias": torch.zeros((*Lm, E), dtype=dtype, device=device),
                "w_gate": nrm((*Lm, E, D, Fe), D ** -0.5),
                "w_up": nrm((*Lm, E, D, Fe), D ** -0.5),
                "w_down": nrm((*Lm, E, Fe, D), Fe ** -0.5),
                "shared": {"w_gate": nrm((*Lm, D, Fs), D ** -0.5),
                           "w_up": nrm((*Lm, D, Fs), D ** -0.5),
                           "w_down": nrm((*Lm, Fs, D), Fs ** -0.5)}},
        "ln_final": norm((), D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = nrm((D, cfg.vocab_size), D ** -0.5)
    return params


def layer_params(cfg: MLAModelConfig, params, l: int):
    """Layer ``l``'s weights: its attention and norms, and ``"mlp"`` (a
    leading dense layer) or ``"moe"``."""
    def pick(tree, i):
        return ({n: pick(t, i) for n, t in tree.items()}
                if isinstance(tree, dict) else tree[i])
    lp = pick(params["layers"], l)
    k = cfg.mla.first_k_dense_replace
    if l < k:
        lp["mlp"] = pick(params["dense"], l)
    else:
        lp["moe"] = pick(params["moe"], l - k)
    return lp


# ---------------------------------------------------------------------------
# the block's pieces
# ---------------------------------------------------------------------------

def rope_interleaved(x, positions, theta: float):
    """x: (..., S, H, D), D even; positions broadcastable to (..., S).
    Rotates the pairs ``(2i, 2i + 1)`` in place at ``theta^(-2i / D)``,
    in float32."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=F32, device=x.device) / d)
    ang = positions[..., None].to(F32) * freq               # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf = x.to(F32)
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)


def queries(cfg: MLAModelConfig, p, h, positions):
    """h (B, S, D) -> (q_nope (B, S, H, Dn), roped q_pe (B, S, H, Dr)) in
    h's dtype."""
    m = cfg.mla
    q = split_heads(matmul_f32(h, p["wq"]), cfg.n_heads).to(h.dtype)
    q_pe = rope_interleaved(q[..., m.qk_nope_head_dim:], positions,
                            cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_pe


def latent_rows(cfg: MLAModelConfig, p, h, positions):
    """h (B, S, D) -> the pool rows (B, S, R + Dr): ``RMSNorm(c)`` then
    the roped key, in h's dtype."""
    R = cfg.mla.kv_lora_rank
    kv = matmul_f32(h, p["wkv_a"]).to(h.dtype)
    c = rms_norm(kv[..., :R], p["kv_norm"]["scale"], cfg.norm_eps)
    k_pe = rope_interleaved(kv[..., None, R:], positions, cfg.rope_theta)
    return torch.cat([c, k_pe[..., 0, :]], dim=-1)


def _kv_b(cfg: MLAModelConfig, p):
    """``W_kv_b`` as (R, H, Dn + Dv)."""
    m = cfg.mla
    return p["wkv_b"].view(m.kv_lora_rank, cfg.n_heads,
                           m.qk_nope_head_dim + m.v_head_dim)


def absorb(cfg: MLAModelConfig, p, q_nope, q_pe):
    """The absorbed queries (B, S, H, R + Dr): ``q_nope W_uk^T`` (f32
    accumulation, rounded to the queries' dtype), then ``q_pe``."""
    B, S, H, Dn = q_nope.shape
    wk = _kv_b(cfg, p)[..., :Dn].permute(1, 2, 0)           # (H, Dn, R)
    qa = bmm_f32(q_nope.reshape(B * S, H, Dn).transpose(0, 1), wk)
    qa = qa.to(q_nope.dtype).transpose(0, 1).reshape(B, S, H, -1)
    return torch.cat([qa, q_pe], dim=-1)


def lift(cfg: MLAModelConfig, p, o_lat):
    """o_lat (B, S, H, R) -> (B, S, H, Dv) through ``W_uv``."""
    B, S, H, R = o_lat.shape
    wv = _kv_b(cfg, p)[..., cfg.mla.qk_nope_head_dim:].transpose(0, 1)
    o = bmm_f32(o_lat.reshape(B * S, H, R).transpose(0, 1), wv)
    return o.to(o_lat.dtype).transpose(0, 1).reshape(B, S, H, -1)


def scale(cfg: MLAModelConfig) -> float:
    return cfg.mla.qk_head_dim ** -0.5


def expanded_attention(cfg: MLAModelConfig, p, q_nope, q_pe, rows,
                       q_chunk: int = 1024):
    """The published form over a whole stream from position 0: ``k_nope``
    and ``v`` expanded from the latent rows (B, S, R + Dr), causal, in
    float32 over blocks of ``q_chunk`` queries. Returns (B, S, H, Dv) in
    the queries' dtype."""
    m = cfg.mla
    B, S, H, Dn = q_nope.shape
    R = m.kv_lora_rank
    kv = matmul_f32(rows[..., :R], p["wkv_b"]).reshape(B, S, H, -1)
    k = torch.cat([kv[..., :Dn], rows[..., None, R:].to(F32).expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)               # (B, S, H, Dk)
    v = kv[..., Dn:]
    q = torch.cat([q_nope, q_pe], dim=-1).to(F32)
    out = []
    for c0 in range(0, S, q_chunk):
        c1 = min(S, c0 + q_chunk)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, c0:c1], k[:, :c1])
        s = s * scale(cfg)
        mask = (torch.arange(c1, device=q.device)[None, :]
                > torch.arange(c0, c1, device=q.device)[:, None])
        s = s.masked_fill(mask, float("-inf"))
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                                v[:, :c1]))
    return torch.cat(out, dim=1).to(q_nope.dtype)


# ---------------------------------------------------------------------------
# one layer's attention, projected by W_o, on each path
# ---------------------------------------------------------------------------

def full_attention(cfg: MLAModelConfig, p, h, positions):
    """The full-sequence block (rows at ``0 .. S-1``): (B, S, D)."""
    q_nope, q_pe = queries(cfg, p, h, positions)
    rows = latent_rows(cfg, p, h, positions)
    return attn_out(p, expanded_attention(cfg, p, q_nope, q_pe, rows))


def prefill_attention(cfg: MLAModelConfig, p, h, positions, pool,
                      write_pages, write_offsets, table, kv_len, q_offset):
    """One pack's block against the latent pool ``pool`` (P, page,
    R + Dr): the pack's rows are written into their pages first, then the
    absorbed queries attend over the pages in place (``ops``). Returns
    (1, C, D)."""
    from repro_torch.kernels import ops            # lazy: keeps layers cheap
    from repro_torch.models.layers import paged_write
    with spans.span("mla.q"):
        q = absorb(cfg, p, *queries(cfg, p, h, positions))
    with spans.span("mla.latent"):
        paged_write(pool, write_pages, write_offsets,
                    latent_rows(cfg, p, h, positions)[0])
    with spans.span("mla.attn"):
        o = ops.mla_prefill_attention(q.contiguous(), pool, table, kv_len,
                                      q_offset, scale=scale(cfg),
                                      rank=cfg.mla.kv_lora_rank)
    with spans.span("mla.out"):
        return attn_out(p, lift(cfg, p, o))


def decode_attention(cfg: MLAModelConfig, p, h, positions, pool,
                     block_tables, lengths, write_pages, write_offsets):
    """One decode step's block: h (B, 1, D) at ``positions`` (B, 1); the
    new latent row is written inside the attention call (slot contract of
    ``lm_decode_paged``). Returns (B, 1, D)."""
    from repro_torch.kernels import ops
    with spans.span("mla.q"):
        q = absorb(cfg, p, *queries(cfg, p, h, positions))
    with spans.span("mla.latent"):
        rows = latent_rows(cfg, p, h, positions)
    with spans.span("mla.attn"):
        o = ops.mla_decode_attention(
            q[:, 0].contiguous(), pool, block_tables, lengths,
            rows[:, 0].contiguous(), write_pages, write_offsets,
            scale=scale(cfg), rank=cfg.mla.kv_lora_rank)
    with spans.span("mla.out"):
        return attn_out(p, lift(cfg, p, o[:, None]))
