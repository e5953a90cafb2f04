"""Whisper: ``repro.models.whisper`` in PyTorch, an encoder-decoder
backbone. The audio front end is a stub, as in JAX: the convolutional
feature extractor is replaced by frame embeddings (B, T_enc, D) supplied
by the caller.

Encoder: bidirectional pre-LN transformer over the frames plus sinusoidal
positions. Decoder: causal self-attention (cached) and cross-attention
over the encoder output (its K/V computed once, at prefill), learned
positions; the output projection is the token embedding, tied, in f32.

Every full-sequence attention goes through ``ops.attention``: on the card
the hand-written ``flash_attention`` kernel, non-causal in the encoder and
in the cross-attention (Sq = T_dec over Skv = T_enc), causal in the
decoder's self-attention; on the CPU its plain version. The decode step
stays on the plain ``layers.attention``: its self-attention runs per row
at each row's own position over the cache, as ``lm_decode`` does, and its
one-row cross-attention goes the same way. ``whisper_decode`` writes the
new token's K/V into the self cache **in place** (a position past the
cache's end, which JAX drops, raises here or trips a device assert, so
callers pad the cache). The layer ``scan`` becomes a loop over the
stacked weights. Every function takes the parallel context ``pctx``:
under its mesh the flash kernel runs on each rank's shard
(``layers.dense_prefill_attention``) and the self K/V writes go through
``layers.write_kv``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    F32, ParallelCtx, apply_norm, attention, attn_out, attn_qkv, constrain,
    dense_prefill_attention, dp_for, embed_lookup, matmul, matmul_f32, mlp,
    replicated_like, split_heads, write_kv)
from repro_torch.models.transformer import (TensorSpec, _attn_params,
                                            _mlp_params, _norm_params,
                                            _normal, layer_params)


@dataclasses.dataclass
class EncDecCache:
    """self_k/self_v: (L, B, T_dec_max, H, Dh), written in place by
    ``whisper_decode``; cross_k/cross_v: (L, B, T_enc, H, Dh)."""
    self_k: Any
    self_v: Any
    cross_k: Any
    cross_v: Any

    @classmethod
    def specs(cls, cfg: ModelConfig, batch: int, dec_len: int, enc_len: int,
              dtype=torch.bfloat16):
        s = TensorSpec((cfg.n_layers, batch, dec_len, cfg.n_kv_heads,
                        cfg.head_dim_), dtype)
        c = TensorSpec((cfg.n_layers, batch, enc_len, cfg.n_kv_heads,
                        cfg.head_dim_), dtype)
        return cls(s, s, c, c)


def _sinusoid(length: int, dim: int, device="cpu"):
    pos = torch.arange(length, dtype=F32, device=device)[:, None]
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, dim, 2, dtype=F32, device=device) / dim)
    pe = torch.zeros((length, dim), dtype=F32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def init_whisper(cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """Random weights with the shapes, scales and dtypes of
    ``repro.models.whisper.init_whisper`` (not its bits); the per-layer
    weights stacked under ``enc_layers`` and ``dec_layers``.
    ``generator`` must live on ``device``."""
    D = cfg.d_model

    def nrm(shape, scale):
        return _normal(shape, scale, generator, dtype, device)

    def norm(lead):
        return _norm_params(cfg, lead, D, dtype, device)

    E, L = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": nrm((cfg.vocab_size, D), D ** -0.5),
        "dec_pos": nrm((cfg.max_target_len, D), 0.01),
        "enc_layers": {"ln_attn": norm(E),
                       "attn": _attn_params(cfg, E, nrm, dtype, device),
                       "ln_mlp": norm(E), "mlp": _mlp_params(cfg, E, nrm)},
        "dec_layers": {"ln_self": norm(L),
                       "self_attn": _attn_params(cfg, L, nrm, dtype, device),
                       "ln_cross": norm(L),
                       "cross_attn": _attn_params(cfg, L, nrm, dtype,
                                                  device),
                       "ln_mlp": norm(L), "mlp": _mlp_params(cfg, L, nrm)},
        "ln_enc_final": norm(()),
        "ln_dec_final": norm(()),
    }


def encode(cfg: ModelConfig, params, frames, *,
           pctx: Optional[ParallelCtx] = None):
    """frames: (B, T_enc, D) precomputed frame embeddings (the stub front
    end) -> the encoder output (B, T_enc, D)."""
    B, T, D = frames.shape
    x = frames + replicated_like(frames, _sinusoid(
        T, D, frames.device).to(frames.dtype)[None])
    x = constrain(x, pctx, dp_for(pctx, x.shape[0]), None, None)
    for l in range(cfg.n_enc_layers):
        lp = layer_params(params["enc_layers"], l)
        h = apply_norm(cfg, lp["ln_attn"], x)
        q, k, v = attn_qkv(cfg, lp["attn"], h, None, use_rope=False)
        x = x + attn_out(lp["attn"], dense_prefill_attention(
            q, k, v, causal=False, pctx=pctx))
        x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln_mlp"], x), pctx)
    return apply_norm(cfg, params["ln_enc_final"], x)


def _query(cfg: ModelConfig, p, x):
    """The query projection of ``attn_qkv`` alone (the cross-attention's
    K/V come from the encoder output)."""
    B, S, _ = x.shape
    q = matmul_f32(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(F32)
    return split_heads(q, cfg.n_heads).to(x.dtype)


def _dec_layer(cfg: ModelConfig, lp, x, positions, self_kv, cross_kv, *,
               pos_write=None, kv_pos=None, kv_valid=None, pctx=None):
    """One decoder layer; ``self_kv``/``cross_kv`` are (k, v) pairs. Without
    ``pos_write`` (full sequence) the self K/V are the layer's own and
    every attention runs through the flash kernel; with it (decode, one
    row) the new K/V is written into ``self_kv`` at ``pos_write`` and both
    attentions run plain, by position. Returns (x, (k, v))."""
    B = x.shape[0]
    h = apply_norm(cfg, lp["ln_self"], x)
    q, k_new, v_new = attn_qkv(cfg, lp["self_attn"], h, None, use_rope=False)
    if pos_write is None:
        k_c, v_c = k_new, v_new
        o = dense_prefill_attention(q, k_c, v_c, pctx=pctx)
    else:
        k_c = write_kv(self_kv[0], pos_write[:, None], k_new)
        v_c = write_kv(self_kv[1], pos_write[:, None], v_new)
        o = attention(q, k_c, v_c, positions, kv_pos, kv_valid=kv_valid,
                      causal=True)
    x = x + attn_out(lp["self_attn"], o)
    hc = apply_norm(cfg, lp["ln_cross"], x)
    qc = _query(cfg, lp["cross_attn"], hc)
    ck, cv = cross_kv
    if pos_write is None:
        o = dense_prefill_attention(qc, ck, cv, causal=False, pctx=pctx)
    else:
        enc_pos = replicated_like(x, torch.arange(
            ck.shape[1], dtype=positions.dtype,
            device=x.device).expand(B, ck.shape[1]))
        o = attention(qc, ck, cv, positions, enc_pos, causal=False)
    x = x + attn_out(lp["cross_attn"], o)
    x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln_mlp"], x))
    return x, (k_c, v_c)


def _cross_kv(cfg: ModelConfig, lp, enc_out):
    """One layer's cross K/V from the encoder output (plain products in the
    model dtype, as JAX's einsums)."""
    B, T, _ = enc_out.shape
    return split_heads(matmul(enc_out, lp["cross_attn"]["wk"]),
                       cfg.n_kv_heads), \
        split_heads(matmul(enc_out, lp["cross_attn"]["wv"]),
                    cfg.n_kv_heads)


def _dec_body(cfg: ModelConfig, lp, x, enc_out, pctx=None):
    ck, cv = _cross_kv(cfg, lp, enc_out)
    x, (k, v) = _dec_layer(cfg, lp, x, None, None, (ck, cv), pctx=pctx)
    return x, (k, v, ck, cv)


def whisper_forward(cfg: ModelConfig, params, dec_tokens, frames, *,
                    pctx: Optional[ParallelCtx] = None,
                    return_cache: bool = False, remat: bool = False):
    """Teacher-forced forward: frames (B, T_enc, D), dec_tokens (B, T_dec)
    with T_dec <= ``max_target_len`` -> logits (B, T_dec, V) float32;
    optionally the ``EncDecCache`` (self K/V of length T_dec). ``remat``
    recomputes each decoder layer in the backward, as JAX checkpoints its
    decoder body."""
    enc_out = encode(cfg, params, frames, pctx=pctx)
    B, Tdec = dec_tokens.shape
    x = embed_lookup(dec_tokens, params["embed"]) + \
        params["dec_pos"][:Tdec][None]
    ks, vs, cks, cvs = [], [], [], []
    for l in range(cfg.n_layers):
        args = (cfg, layer_params(params["dec_layers"], l), x, enc_out, pctx)
        if remat:
            x, (k, v, ck, cv) = checkpoint(_dec_body, *args,
                                           use_reentrant=False)
        else:
            x, (k, v, ck, cv) = _dec_body(*args)
        if return_cache:
            ks.append(k)
            vs.append(v)
            cks.append(ck)
            cvs.append(cv)
    x = apply_norm(cfg, params["ln_dec_final"], x)
    logits = matmul_f32(x, params["embed"].T)
    if return_cache:
        return logits, EncDecCache(torch.stack(ks), torch.stack(vs),
                                   torch.stack(cks), torch.stack(cvs))
    return logits


def whisper_prefill(cfg: ModelConfig, params, dec_tokens, frames, *,
                    pctx: Optional[ParallelCtx] = None):
    """-> (last-position logits (B, V), cache with self K/V of length
    T_dec)."""
    logits, cache = whisper_forward(cfg, params, dec_tokens, frames,
                                    pctx=pctx, return_cache=True)
    return logits[:, -1], cache


def whisper_decode(cfg: ModelConfig, params, cache: EncDecCache, tokens,
                   positions, *, pctx: Optional[ParallelCtx] = None):
    """tokens (B,), positions (B,) -> (logits (B, V) float32, cache). The
    learned position is clipped to ``max_target_len - 1``, as in JAX; the
    cross K/V are static."""
    B = tokens.shape[0]
    Smax = cache.self_k.shape[2]
    pos_emb = params["dec_pos"][positions.long().clamp(
        0, cfg.max_target_len - 1)]
    x = (embed_lookup(tokens, params["embed"]) + pos_emb)[:, None]
    kv_pos = replicated_like(x, torch.arange(
        Smax, dtype=positions.dtype, device=x.device).expand(B, Smax))
    kv_valid = kv_pos <= positions[:, None]
    for l in range(cfg.n_layers):
        x, _ = _dec_layer(cfg, layer_params(params["dec_layers"], l), x,
                          positions[:, None],
                          (cache.self_k[l], cache.self_v[l]),
                          (cache.cross_k[l], cache.cross_v[l]),
                          pos_write=positions, kv_pos=kv_pos,
                          kv_valid=kv_valid, pctx=pctx)
    x = apply_norm(cfg, params["ln_dec_final"], x[:, 0])
    return matmul_f32(x, params["embed"].T), cache
