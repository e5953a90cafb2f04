"""Zamba2: ``repro.models.zamba2`` in PyTorch. A Mamba2 backbone plus one
*shared* transformer block applied after every ``shared_attn_every``
Mamba layers. The shared block's weights are reused at each application,
but each application keeps its own KV cache; its input is
``in_proj(concat(hidden, original embedding))``, as in the Zamba papers.

The full-sequence attention of the shared block (train, prefill) goes
through ``ops.attention``: on the card the hand-written ``flash_attention``
kernel (causal, ``q_offset`` 0, G 1), on the CPU its plain version. The
decode step attends per row at each row's own position, so it stays on
the plain ``layers.attention`` over the cache, as ``lm_decode`` does.

As in the reference, the residual adds the shared block's whole output
``h`` (which includes ``in_proj(concat(x, x0))``), not a delta over it
(ROADMAP.md section 3). The layer ``scan`` becomes a loop over the
stacked Mamba weights. ``zamba_decode`` writes the new token's K/V into
the cache **in place** (JAX returns a fresh cache; a position past the
cache's end, which JAX's ``.at[].set`` drops, raises here or trips a
device assert, so callers pad the cache) and returns fresh Mamba states.
Every function takes the parallel context ``pctx``: under its mesh the
flash kernel and the SSD scan run on each rank's shard and the K/V writes
go through ``layers.write_kv``. Not ported: ``zamba_forward``'s ``cache``
(no caller passes one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import mamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParallelCtx, apply_norm, attention, attn_out, attn_qkv, constrain,
    dense_prefill_attention, dp_for, embed_lookup, matmul, mlp,
    replicated_like, rms_norm, write_kv)
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.transformer import (TensorSpec, _attn_params,
                                            _mlp_params, _norm_params,
                                            _normal, _unembed, layer_params)


def shared_positions(cfg: ModelConfig) -> Tuple[int, ...]:
    """Mamba-layer indices after which the shared attention block runs."""
    return tuple(i for i in range(cfg.n_layers)
                 if (i + 1) % cfg.shared_attn_every == 0)


def _segments(cfg: ModelConfig, spos) -> Tuple[Tuple[int, int], ...]:
    """Contiguous Mamba-layer ranges split at the shared-block
    positions."""
    segs = []
    start = 0
    for p in spos:
        segs.append((start, p + 1))
        start = p + 1
    if start < cfg.n_layers:
        segs.append((start, cfg.n_layers))
    return tuple(segs)


@dataclasses.dataclass
class ZambaCache:
    """mamba: ``MambaState`` with a leading L axis; k/v: (n_apps, B, Smax,
    Hkv, Dh), written in place by ``zamba_decode``."""
    mamba: MambaState
    k: Any
    v: Any

    @classmethod
    def specs(cls, cfg: ModelConfig, batch: int, max_len: int,
              dtype=torch.bfloat16):
        n_apps = len(shared_positions(cfg))
        kv = TensorSpec((n_apps, batch, max_len, cfg.n_kv_heads,
                         cfg.head_dim_), dtype)
        return cls(mamba2.state_specs(cfg, cfg.n_layers, batch, dtype), kv,
                   kv)


def init_zamba(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """Random weights with the shapes, scales and per-leaf dtypes of
    ``repro.models.zamba2.init_zamba`` (not its bits). ``generator`` must
    live on ``device``."""
    D = cfg.d_model

    def nrm(shape, scale):
        return _normal(shape, scale, generator, dtype, device)

    shared = {"in_proj": nrm((2 * D, D), (2 * D) ** -0.5),
              "ln_attn": _norm_params(cfg, (), D, dtype, device),
              "attn": _attn_params(cfg, (), nrm, dtype, device),
              "ln_mlp": _norm_params(cfg, (), D, dtype, device),
              "mlp": _mlp_params(cfg, (), nrm)}
    return {
        "embed": nrm((cfg.vocab_size, D), D ** -0.5),
        "mamba_layers": mamba2.init_mamba_layers(cfg, cfg.n_layers,
                                                 generator, dtype, device),
        "shared": shared,
        "ln_final": torch.zeros((D,), dtype=dtype, device=device),
        "lm_head": nrm((D, cfg.vocab_size), D ** -0.5),
    }


def _shared_block_full(cfg: ModelConfig, sp, x, x0, positions, *,
                       kv_pos=None, kv_valid=None, k_cache=None,
                       v_cache=None, pos_write=None, pctx=None):
    """The shared attention + MLP block; returns (h, k, v). Without a cache
    the rows are the sequence 0..S-1 and attend causally through the flash
    kernel; with one (decode, S == 1) the new K/V is written into it at
    ``pos_write`` and the row attends over it by position."""
    h = matmul(torch.cat([x, x0], dim=-1), sp["in_proj"])
    a_in = apply_norm(cfg, sp["ln_attn"], h)
    q, k, v = attn_qkv(cfg, sp["attn"], a_in, positions)
    if k_cache is None:
        o = dense_prefill_attention(q, k, v, pctx=pctx)
    else:
        k = write_kv(k_cache, pos_write[:, None], k)
        v = write_kv(v_cache, pos_write[:, None], v)
        o = attention(q, k, v, positions, kv_pos, kv_valid=kv_valid,
                      causal=True)
    h = h + attn_out(sp["attn"], o)
    m_in = apply_norm(cfg, sp["ln_mlp"], h)
    h = h + mlp(cfg, sp["mlp"], m_in)
    return h, k, v


def _mamba_layer(cfg: ModelConfig, lp, x, conv, ssm, pctx=None):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    out, new = mamba2.mamba_block_full(cfg, lp, h, conv, ssm, pctx)
    return x + out, new


def _zero_state(cfg: ModelConfig, B: int, x, pctx) -> MambaState:
    """One layer's zero Mamba state; under a mesh, DTensors with the
    placements of ``sharding.cache_specs``."""
    if pctx is None or pctx.mesh is None:
        return mamba2.state_zeros(cfg, 1, B, x.dtype, x.device)
    from repro_torch.distributed import sharding as sh
    return sh.zeros(mamba2.state_specs(cfg, 1, B, x.dtype), pctx.mesh,
                    sh.cache_specs(cfg, pctx.mesh, B).mamba)


def zamba_forward(cfg: ModelConfig, params, tokens, *,
                  pctx: Optional[ParallelCtx] = None,
                  return_cache: bool = False, remat: bool = False):
    """tokens (B, T) -> logits (B, T, V) float32; optionally the
    ``ZambaCache`` of length T. T must be at most the SSD chunk or a
    multiple of it. ``remat`` recomputes each Mamba layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), as JAX checkpoints its
    layer body."""
    B, T = tokens.shape
    x = embed_lookup(tokens, params["embed"])   # see tf._embed
    x = constrain(x, pctx, dp_for(pctx, x.shape[0]), None, None)
    x0 = x
    positions = replicated_like(x, torch.arange(
        T, dtype=torch.int32, device=x.device).expand(B, T))
    zero = _zero_state(cfg, B, x, pctx)
    spos = shared_positions(cfg)
    convs, ssms, ks, vs = [], [], [], []
    for app_i, (lo, hi) in enumerate(_segments(cfg, spos)):
        for l in range(lo, hi):
            args = (cfg, layer_params(params["mamba_layers"], l), x,
                    zero.conv[0], zero.ssm[0], pctx)
            if remat:
                x, (nc, ns) = checkpoint(_mamba_layer, *args,
                                         use_reentrant=False)
            else:
                x, (nc, ns) = _mamba_layer(*args)
            if return_cache:
                convs.append(nc)
                ssms.append(ns)
        if app_i < len(spos):
            delta, k, v = _shared_block_full(cfg, params["shared"], x, x0,
                                             positions, pctx=pctx)
            x = x + delta
            if return_cache:
                ks.append(k)
                vs.append(v)
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = _unembed(cfg, params, x)
    if return_cache:
        return logits, ZambaCache(
            MambaState(torch.stack(convs), torch.stack(ssms)),
            torch.stack(ks), torch.stack(vs))
    return logits


def zamba_prefill(cfg: ModelConfig, params, tokens, *,
                  pctx: Optional[ParallelCtx] = None):
    """tokens (B, T) -> (last-position logits (B, V), cache of length
    T)."""
    logits, cache = zamba_forward(cfg, params, tokens, pctx=pctx,
                                  return_cache=True)
    return logits[:, -1], cache


def zamba_decode(cfg: ModelConfig, params, cache: ZambaCache, tokens,
                 positions, *, pctx: Optional[ParallelCtx] = None):
    """tokens (B,), positions (B,) -> (logits (B, V) float32, cache): the
    K/V written into ``cache`` in place, the Mamba states fresh."""
    B = tokens.shape[0]
    Smax = cache.k.shape[2]
    x = embed_lookup(tokens, params["embed"])  # (B, D)
    x0 = x
    kv_pos = replicated_like(x, torch.arange(
        Smax, dtype=positions.dtype, device=x.device).expand(B, Smax))
    kv_valid = kv_pos <= positions[:, None]
    spos = shared_positions(cfg)
    convs, ssms = [], []
    for app_i, (lo, hi) in enumerate(_segments(cfg, spos)):
        for l in range(lo, hi):
            lp = layer_params(params["mamba_layers"], l)
            h = rms_norm(x, lp["ln"], cfg.norm_eps)
            out, (nc, ns) = mamba2.mamba_block_step(
                cfg, lp, h, cache.mamba.conv[l], cache.mamba.ssm[l], pctx)
            x = x + out
            convs.append(nc)
            ssms.append(ns)
        if app_i < len(spos):
            delta, _, _ = _shared_block_full(
                cfg, params["shared"], x[:, None], x0[:, None],
                positions[:, None], kv_pos=kv_pos, kv_valid=kv_valid,
                k_cache=cache.k[app_i], v_cache=cache.v[app_i],
                pos_write=positions, pctx=pctx)
            x = x + delta[:, 0]
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = _unembed(cfg, params, x)
    return logits, ZambaCache(
        MambaState(torch.stack(convs), torch.stack(ssms)), cache.k, cache.v)
