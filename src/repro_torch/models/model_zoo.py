"""Family dispatcher: the uniform API of ``repro.models.model_zoo`` over all
the families of the assigned architectures (``dense``, ``moe``, ``rwkv6``,
``zamba2`` and ``whisper``).

    init(cfg, seed, dtype, device)              -> params
    forward(cfg, params, batch, pctx, remat)    -> logits   (full sequence)
    prefill(cfg, params, batch, pctx)           -> (last_logits, cache)
    decode(cfg, params, cache, tok, pos, pctx)  -> (logits, cache)
    cache_specs(cfg, batch, max_len, dtype, enc_len=0)
                                                -> TensorSpec per cache field
    cache_zeros(cfg, batch, max_len, dtype, enc_len=0, device)

``batch`` is a dict with ``'tokens'`` (B, S) and, for the LM families,
optional ``'embeds'`` (B, N, D): the image-patch front end's stub tokens,
prepended (rwkv6 and zamba2 ignore them, as in JAX); whisper reads
``'frames'`` (B, T_enc, D), its audio front end's stub frame embeddings,
and decodes ``'tokens'``. Other entries (``'targets'``) are not read.
``cache_specs``' ``enc_len`` is whisper's encoder length; 0 takes the
config's ``n_frontend_tokens``, as in JAX. These are entry points: the
device defaults to ``"cuda"`` and a run without a card raises; the CPU is
asked for by name. ``forward``/``prefill``/``decode`` run where their
tensors lie. The ``seed`` takes the place of JAX's ``PRNGKey``: torch
draws other bits from it. ``pctx`` is the parallel context: under its
mesh the params, batch and caches are DTensors (``distributed/
sharding.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models import rwkv6, whisper, zamba2
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParallelCtx
from repro_torch.models.transformer import TensorSpec


def _family(cfg: ModelConfig) -> str:
    """``"lm"`` for the decoder-only transformers (dense and moe, as in
    JAX's model_zoo), else the family's own name."""
    if cfg.family in ("dense", "moe"):
        return "lm"
    if cfg.family in ("rwkv6", "zamba2", "whisper"):
        return cfg.family
    raise ValueError(cfg.family)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


_INIT = {"lm": tf.init_lm, "rwkv6": rwkv6.init_rwkv,
         "zamba2": zamba2.init_zamba, "whisper": whisper.init_whisper}


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
         device="cuda"):
    family = _family(cfg)
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _INIT[family](cfg, gen, dtype, dev)


def forward(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            pctx: Optional[ParallelCtx] = None, remat: bool = False):
    family = _family(cfg)
    if family == "lm":
        return tf.lm_forward(cfg, params, batch["tokens"], pctx=pctx,
                             embeds=batch.get("embeds"), remat=remat)
    if family == "rwkv6":
        return rwkv6.rwkv_forward(cfg, params, batch["tokens"], pctx=pctx,
                                  remat=remat)
    if family == "zamba2":
        return zamba2.zamba_forward(cfg, params, batch["tokens"], pctx=pctx,
                                    remat=remat)
    return whisper.whisper_forward(cfg, params, batch["tokens"],
                                   batch["frames"], pctx=pctx, remat=remat)


def prefill(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            pctx: Optional[ParallelCtx] = None):
    family = _family(cfg)
    if family == "lm":
        return tf.lm_prefill(cfg, params, batch["tokens"], pctx=pctx,
                             embeds=batch.get("embeds"))
    if family == "rwkv6":
        return rwkv6.rwkv_prefill(cfg, params, batch["tokens"], pctx=pctx)
    if family == "zamba2":
        return zamba2.zamba_prefill(cfg, params, batch["tokens"], pctx=pctx)
    return whisper.whisper_prefill(cfg, params, batch["tokens"],
                                   batch["frames"], pctx=pctx)


_DECODE = {"lm": tf.lm_decode, "rwkv6": rwkv6.rwkv_decode,
           "zamba2": zamba2.zamba_decode, "whisper": whisper.whisper_decode}


def decode(cfg: ModelConfig, params, cache, tokens, positions, *,
           pctx: Optional[ParallelCtx] = None):
    return _DECODE[_family(cfg)](cfg, params, cache, tokens, positions,
                                 pctx=pctx)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, enc_len: int = 0):
    family = _family(cfg)
    if family == "lm":
        shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
        return tf.KVCache(TensorSpec(shp, dtype), TensorSpec(shp, dtype))
    if family == "rwkv6":
        return rwkv6.RWKVState.specs(cfg, batch, dtype)
    if family == "zamba2":
        return zamba2.ZambaCache.specs(cfg, batch, max_len, dtype)
    return whisper.EncDecCache.specs(cfg, batch, max_len,
                                     enc_len or cfg.n_frontend_tokens, dtype)


def _zeros(spec, dev):
    """Zeros for every ``TensorSpec`` of a (nested) cache of specs."""
    if isinstance(spec, TensorSpec):
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    return type(spec)(**{f.name: _zeros(getattr(spec, f.name), dev)
                         for f in dataclasses.fields(spec)})


def cache_zeros(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, enc_len: int = 0, device="cuda"):
    return _zeros(cache_specs(cfg, batch, max_len, dtype, enc_len),
                  _device(device))
