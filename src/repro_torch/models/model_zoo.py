"""Family dispatcher: the uniform API of ``repro.models.model_zoo`` over the
families the port serves and trains so far (``dense``, ``moe`` and
``rwkv6``).

    init(cfg, seed, dtype, device)              -> params
    forward(cfg, params, batch, remat=False)    -> logits   (full sequence)
    prefill(cfg, params, batch)                 -> (last_logits, cache)
    decode(cfg, params, cache, tok, pos)        -> (logits, cache)
    cache_specs(cfg, batch, max_len, dtype)     -> TensorSpec per cache field
    cache_zeros(cfg, batch, max_len, dtype, device)

``batch`` is a dict with ``'tokens'`` (B, S) and, for the LM families,
optional ``'embeds'`` (B, N, D): the image-patch front end's stub tokens,
prepended (rwkv6 ignores them, as in JAX); other entries (``'targets'``)
are not read. ``'frames'`` (whisper's audio front end) raises
``NotImplementedError``. These are entry points: the device defaults to
``"cuda"`` and a run without a card raises; the CPU is asked for by name.
``forward``/``prefill``/``decode`` run where their tensors lie. The
``seed`` takes the place of JAX's ``PRNGKey``: torch draws other bits
from it. The sharding argument ``pctx`` is not ported. The other families
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import rwkv6
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TensorSpec

_TODO = {
    "zamba2": "zamba2 is not ported yet: ROADMAP.md, 'Modules still to "
              "port', 'Other families'",
    "whisper": "whisper is not ported yet: ROADMAP.md, 'Modules still to "
               "port', 'Other families'",
}


def _family(cfg: ModelConfig) -> str:
    """``"lm"`` for the decoder-only transformers (dense and moe, as in
    JAX's model_zoo), ``"rwkv6"``; the families still to port raise."""
    if cfg.family in ("dense", "moe"):
        return "lm"
    if cfg.family == "rwkv6":
        return cfg.family
    if cfg.family in _TODO:
        raise NotImplementedError(_TODO[cfg.family])
    raise ValueError(cfg.family)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def _tokens(batch: Dict[str, Any]):
    if "frames" in batch:
        raise NotImplementedError("batch['frames'] (the audio front end) is "
                                  "not ported: " + _TODO["whisper"])
    return batch["tokens"]


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
         device="cuda"):
    family = _family(cfg)
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if family == "lm":
        return tf.init_lm(cfg, gen, dtype, dev)
    return rwkv6.init_rwkv(cfg, gen, dtype, dev)


def forward(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            remat: bool = False):
    if _family(cfg) == "lm":
        return tf.lm_forward(cfg, params, _tokens(batch),
                             embeds=batch.get("embeds"), remat=remat)
    return rwkv6.rwkv_forward(cfg, params, _tokens(batch), remat=remat)


def prefill(cfg: ModelConfig, params, batch: Dict[str, Any]):
    if _family(cfg) == "lm":
        return tf.lm_prefill(cfg, params, _tokens(batch),
                             embeds=batch.get("embeds"))
    return rwkv6.rwkv_prefill(cfg, params, _tokens(batch))


def decode(cfg: ModelConfig, params, cache, tokens, positions):
    if _family(cfg) == "lm":
        return tf.lm_decode(cfg, params, cache, tokens, positions)
    return rwkv6.rwkv_decode(cfg, params, cache, tokens, positions)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    if _family(cfg) == "lm":
        shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
        return tf.KVCache(TensorSpec(shp, dtype), TensorSpec(shp, dtype))
    return rwkv6.RWKVState.specs(cfg, batch, dtype)


def cache_zeros(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda"):
    specs = cache_specs(cfg, batch, max_len, dtype)
    dev = _device(device)
    fields = {name: torch.zeros(s.shape, dtype=s.dtype, device=dev)
              for name, s in vars(specs).items()}
    return type(specs)(**fields)
