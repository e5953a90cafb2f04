"""Decoder-only LM on a paged KV pool: the serving path of
``repro.models.transformer`` (dense family) in PyTorch.

The layer ``scan`` of the JAX package becomes a loop over the stacked
per-layer weights, and the pack ``scan`` of ``lm_mixed_paged`` a loop over
packs. JAX's functional, donated cache updates become **in-place** writes
into the pool tensors: every ``lm_*_paged`` function mutates ``cache.k`` /
``cache.v`` and still returns the cache, so call sites read like the
reference. Only the ``dense`` family is ported; ``moe`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (F32, apply_norm, attn_out, attn_qkv,
                                       matmul_f32, mlp,
                                       paged_decode_attention,
                                       paged_prefill_attention)

_MOE_TODO = ("the MoE chain (_route/_dispatch/_combine/_expert_ffn) is not "
             "ported yet: ROADMAP.md, 'Modules still to port', item 6")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(shape, scale, generator, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=F32, device=device)
    return w.mul_(scale).to(dtype)


def _norm_params(cfg: ModelConfig, lead, dim, dtype, device):
    shape = (*lead, dim)
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.zeros(shape, dtype=dtype, device=device)}


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """Random weights with the shapes and scales of
    ``repro.models.transformer.init_lm`` (not its bits: torch draws
    differently). Per-layer weights are stacked under ``"layers"`` with a
    leading ``n_layers`` axis. ``generator`` must live on ``device``."""
    if cfg.family != "dense":
        raise NotImplementedError(_MOE_TODO if cfg.family == "moe"
                                  else f"family {cfg.family!r}")
    D, L = cfg.d_model, (cfg.n_layers,)
    Fd = cfg.d_ff

    def nrm(shape, scale):
        return _normal(shape, scale, generator, dtype, device)

    attn = {"wq": nrm((*L, D, cfg.q_dim), D ** -0.5),
            "wk": nrm((*L, D, cfg.kv_dim), D ** -0.5),
            "wv": nrm((*L, D, cfg.kv_dim), D ** -0.5),
            "wo": nrm((*L, cfg.q_dim, D), cfg.q_dim ** -0.5)}
    if cfg.qkv_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                          ("bv", cfg.kv_dim)):
            attn[name] = torch.zeros((*L, dim), dtype=dtype, device=device)
    mlp_p = {"w_up": nrm((*L, D, Fd), D ** -0.5),
             "w_down": nrm((*L, Fd, D), Fd ** -0.5)}
    if cfg.gated_mlp:
        mlp_p["w_gate"] = nrm((*L, D, Fd), D ** -0.5)
    layers = {"ln_attn": _norm_params(cfg, L, D, dtype, device), "attn": attn,
              "ln_mlp": _norm_params(cfg, L, D, dtype, device), "mlp": mlp_p}
    if cfg.post_sublayer_norm:
        layers["ln_post_attn"] = _norm_params(cfg, L, D, dtype, device)
        layers["ln_post_mlp"] = _norm_params(cfg, L, D, dtype, device)
    params = {"embed": nrm((cfg.vocab_size, D), D ** -0.5), "layers": layers,
              "ln_final": _norm_params(cfg, (), D, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = nrm((D, cfg.vocab_size), D ** -0.5)
    return params


def layer_params(layers, l: int):
    """Layer ``l``'s weights: views into the stacked tensors."""
    if isinstance(layers, dict):
        return {k: layer_params(v, l) for k, v in layers.items()}
    return layers[l]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _unembed(cfg: ModelConfig, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = matmul_f32(x, w)
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _ffn_residual(cfg: ModelConfig, lp, x, o):
    """Residual add of the attention output, then the MLP sublayer."""
    o = attn_out(lp["attn"], o)
    if cfg.post_sublayer_norm:
        o = apply_norm(cfg, lp["ln_post_attn"], o)
    x = x + o
    h2 = apply_norm(cfg, lp["ln_mlp"], x)
    if cfg.family == "moe":
        raise NotImplementedError(_MOE_TODO)
    f = mlp(cfg, lp["mlp"], h2)
    if cfg.post_sublayer_norm:
        f = apply_norm(cfg, lp["ln_post_mlp"], f)
    return x + f


# ---------------------------------------------------------------------------
# paged KV: the global page pool driven by BlockPool block tables. Page id P
# (one past the pool) is scratch: padded prefill lanes and idle decode lanes
# park their writes there.
# ---------------------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> bool:
    """The paged path covers plain causal GQA; sliding-window alternation
    and logit softcaps (gemma2) stay on the dense layout."""
    return (cfg.family in ("dense", "moe") and cfg.sliding_window is None
            and cfg.attn_logit_softcap is None)


@dataclasses.dataclass
class PagedKVCache:
    """Paged per-layer KV pool: k/v (L, P+1, page, Hkv, Dh), updated in
    place by the ``lm_*_paged`` functions."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @classmethod
    def zeros(cls, cfg: ModelConfig, n_pages: int, page: int,
              dtype=torch.bfloat16, device="cpu"):
        shp = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.head_dim_)
        return cls(torch.zeros(shp, dtype=dtype, device=device),
                   torch.zeros(shp, dtype=dtype, device=device))


def lm_decode_paged(cfg: ModelConfig, params, cache: PagedKVCache, tokens,
                    positions, block_tables, lengths, write_pages,
                    write_offsets):
    """One decode step against the global page pool.

    tokens/positions: (B,) int32 (absolute positions for RoPE);
    block_tables: (B, max_pages) int32 device page ids in token order;
    lengths: (B,) valid kv tokens AFTER this step's write (pos + 1);
    write_pages/write_offsets: (B,) the page/slot each lane's new KV lands
    in (idle lanes point at the scratch page). The slot must be the table
    position of sequence index ``lengths - 1``. The write happens inside
    the fused decode kernel, in place.
    Returns (logits (B, V) float32, cache).
    """
    if not supports_paged(cfg):
        raise ValueError("paged decode: unsupported attention variant")
    x = _embed(cfg, params, tokens[:, None])          # (B, 1, D)
    q_pos = positions[:, None]
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        h = apply_norm(cfg, lp["ln_attn"], x)
        q, k_new, v_new = attn_qkv(cfg, lp["attn"], h, q_pos)
        o, _, _ = paged_decode_attention(
            q[:, 0].contiguous(), cache.k[l], cache.v[l], block_tables,
            lengths, k_new=k_new[:, 0].contiguous(),
            v_new=v_new[:, 0].contiguous(), write_pages=write_pages,
            write_offsets=write_offsets)
        x = _ffn_residual(cfg, lp, x, o[:, None])
    x = apply_norm(cfg, params["ln_final"], x)
    return _unembed(cfg, params, x[:, 0]), cache


def lm_prefill_paged(cfg: ModelConfig, params, cache: PagedKVCache, tokens,
                     positions, table, write_pages, write_offsets, kv_len):
    """Chunked prefill of ONE sequence against the page pool, gather-free.

    tokens/positions: (1, C) absolute positions; padded lanes sit at
    ``Np*page - 1`` (which the table maps to the scratch page). table: (Np,)
    page ids covering the sequence's lease in token order, scratch-padded,
    the LAST entry always scratch. write_pages/write_offsets: (C,) the
    destination of each chunk token's KV (padded lanes: the scratch page).
    kv_len: 0-d or (1,) int32, valid kv tokens after this chunk; it stays
    on the device.

    Per layer the chunk's KV is scattered into its leased pages first (in
    place), then ``paged_prefill_attention`` reads every page in place
    through the table. Returns (logits (1, C, V) float32, cache).
    """
    if not supports_paged(cfg):
        raise ValueError("paged prefill: unsupported attention variant")
    x = _embed(cfg, params, tokens)                   # (1, C, D)
    q_pos = positions
    q_offset = positions[:, 0].to(torch.int32).contiguous()   # (1,)
    kv_len_b = torch.as_tensor(kv_len, dtype=torch.int32,
                               device=x.device).reshape(1)
    table_b = table.to(torch.int32).reshape(1, -1).contiguous()
    wp, wo = write_pages.long(), write_offsets.long()
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        h = apply_norm(cfg, lp["ln_attn"], x)
        q, k_new, v_new = attn_qkv(cfg, lp["attn"], h, q_pos)
        k_l, v_l = cache.k[l], cache.v[l]
        k_l.index_put_((wp, wo), k_new[0])
        v_l.index_put_((wp, wo), v_new[0])
        o = paged_prefill_attention(q, k_l, v_l, table_b, kv_len_b, q_offset)
        x = _ffn_residual(cfg, lp, x, o)
    x = apply_norm(cfg, params["ln_final"], x)
    return _unembed(cfg, params, x), cache


def lm_mixed_paged(cfg: ModelConfig, params, cache: PagedKVCache,
                   p_tokens, p_positions, p_tables, p_write_pages,
                   p_write_offsets, p_kv_lens, p_last_idx,
                   d_tokens, d_positions, d_tables, d_lengths,
                   d_write_pages, d_write_offsets):
    """ONE mixed continuous-batching iteration against the page pool:
    ``P`` chunked-prefill packs (in order, each updating the pool in place)
    followed by ``B`` one-token decode lanes.

    Prefill pack arrays carry a leading ``P`` axis over the per-pack
    ``lm_prefill_paged`` arguments: p_tokens (P, 1, C), p_positions
    (P, 1, C), p_tables (P, Np), p_write_pages/p_write_offsets (P, C),
    p_kv_lens (P,), p_last_idx (P,), the index of each pack's last real
    chunk token, whose greedy argmax seeds the session's decoding. Decode
    arrays are ``lm_decode_paged``'s: d_tokens/d_positions/d_lengths/
    d_write_pages/d_write_offsets (B,), d_tables (B, max_pages). ``P == 0``
    or ``B == 0`` skips that stage.

    The pack-then-decode order is safe by the pool's write exclusivity: a
    pack writes KV only into its session's exclusively owned pages.
    Returns (p_next (P,) int32, d_next (B,) int32, cache).
    """
    if not supports_paged(cfg):
        raise ValueError("mixed paged: unsupported attention variant")
    dev = cache.k.device
    nxt = []
    for j in range(p_tokens.shape[0]):
        logits, cache = lm_prefill_paged(
            cfg, params, cache, p_tokens[j], p_positions[j], p_tables[j],
            p_write_pages[j], p_write_offsets[j], p_kv_lens[j])
        nxt.append(torch.argmax(logits[0, p_last_idx[j].long()], dim=-1))
    p_next = (torch.stack(nxt).to(torch.int32) if nxt
              else torch.zeros((0,), dtype=torch.int32, device=dev))
    if d_tokens.shape[0] > 0:
        logits, cache = lm_decode_paged(cfg, params, cache, d_tokens,
                                        d_positions, d_tables, d_lengths,
                                        d_write_pages, d_write_offsets)
        d_next = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        d_next = torch.zeros((0,), dtype=torch.int32, device=dev)
    return p_next, d_next, cache
