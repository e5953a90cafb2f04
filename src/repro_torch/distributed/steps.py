"""Step builders of ``repro.distributed.steps`` without a mesh: the train,
prefill and decode steps on one device, and the training losses.

    build_train_step(cfg, opt, remat, chunked_ce) -> train_step(params,
                                                     opt_state, batch)
    build_prefill_step(cfg)                       -> prefill_step(params,
                                                                  batch)
    build_decode_step(cfg, windowed)              -> serve_step(params,
                                                     cache, tokens, positions)

The train step runs the forward, the loss, autograd's backward and
``adamw_update`` (in place). On the card its forward runs the kernels
(``flash_attention`` for every full-sequence attention of the dense, moe,
zamba2 and whisper families, ``wkv6`` for rwkv6) and its backward their
autograd Functions (``kernels/_grad.py``). The
sharded half of the reference (the ``ShapeDtypeStruct`` stand-ins,
``build_cell``, ``perf_opts`` and the parallel context) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import model_zoo
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         tree_leaves, tree_map)

F32 = torch.float32


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _ce_sum(logits, targets):
    """Sum over rows of ``logsumexp - target logit``, in f32."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.sum(lse - tgt)


def cross_entropy(logits, targets):
    """Mean token cross-entropy of (..., V) logits against (...) targets.
    The target logit is gathered; JAX's iota-compare masked sum (a form
    for a vocabulary sharded by GSPMD) adds the same single value."""
    return _ce_sum(logits, targets) / targets.numel()


def _chunk_ce(cfg: ModelConfig, params, h, t):
    return _ce_sum(tf._unembed(cfg, params, h), t)


def chunked_cross_entropy(cfg: ModelConfig, params, hidden, targets,
                          chunk: int = 512):
    """The same loss as ``cross_entropy(_unembed(hidden))``, computed by
    running sequence chunks of the final hidden states through the
    unembedding, so the (B, S, V) f32 logits never exist whole: each
    chunk's share is recomputed in the backward
    (``torch.utils.checkpoint``), the counterpart of JAX's ``lax.scan``.
    Exact same math; an S that ``chunk`` does not divide takes the whole
    logits, as in JAX."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk != 0:
        return cross_entropy(tf._unembed(cfg, params, hidden), targets)
    total = torch.zeros((), dtype=F32, device=hidden.device)
    for c0 in range(0, S, chunk):
        total = total + checkpoint(_chunk_ce, cfg, params,
                                   hidden[:, c0:c0 + chunk],
                                   targets[:, c0:c0 + chunk],
                                   use_reentrant=False)
    return total / (B * S)


def _pad_targets(tgt, length: int):
    """VLM: the front end's tokens are prepended, so the targets are
    left-padded with zeros to the model's sequence, as in JAX."""
    if tgt.shape[1] != length:
        tgt = F.pad(tgt, (length - tgt.shape[1], 0))
    return tgt


def train_loss(cfg: ModelConfig, params, batch: Dict[str, Any], *,
               remat: bool = True, chunked_ce: bool = False):
    """The train step's loss: ``cross_entropy`` of ``model_zoo.forward``
    (every family; whisper reads ``batch['frames']``) against
    ``batch['targets']``, or, with ``chunked_ce`` on the dense and moe
    families, ``chunked_cross_entropy`` of ``lm_forward``'s hidden states
    (the other families take the whole logits, as in JAX)."""
    if chunked_ce and cfg.family in ("dense", "moe"):
        hidden = tf.lm_forward(cfg, params, batch["tokens"],
                               embeds=batch.get("embeds"), remat=remat,
                               return_hidden=True)
        tgt = _pad_targets(batch["targets"], hidden.shape[1])
        return chunked_cross_entropy(cfg, params, hidden, tgt)
    logits = model_zoo.forward(cfg, params, batch, remat=remat)
    return cross_entropy(logits, _pad_targets(batch["targets"],
                                              logits.shape[1]))


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, Any], *,
                   remat: bool = True, chunked_ce: bool = False):
    """(loss, grads): ``train_loss`` and its gradient with respect to every
    param leaf, a tree like ``params`` (zeros where a leaf does not reach
    the loss, as in JAX). The params require grad only inside the call."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = train_loss(cfg, params, batch, remat=remat,
                              chunked_ce=chunked_ce)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    by_id = {id(p): g if g is not None else torch.zeros_like(p)
             for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], params)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, *, opt: Optional[OptConfig] = None,
                     remat: bool = True, chunked_ce: bool = False):
    opt = opt or OptConfig()

    def train_step(params, opt_state: OptState, batch):
        loss, grads = loss_and_grads(cfg, params, batch, remat=remat,
                                     chunked_ce=chunked_ce)
        params, opt_state, metrics = adamw_update(opt, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        last_logits, cache = model_zoo.prefill(cfg, params, batch)
        return torch.argmax(last_logits, dim=-1).to(torch.int32), cache

    return prefill_step


def build_decode_step(cfg: ModelConfig, *, windowed: bool = False):
    if windowed:
        @torch.no_grad()
        def serve_step_w(params, cache, tokens, positions):
            logits, cache = tf.lm_decode_windowed(cfg, params, cache, tokens,
                                                  positions)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        return serve_step_w

    @torch.no_grad()
    def serve_step(params, cache, tokens, positions):
        logits, cache = model_zoo.decode(cfg, params, cache, tokens,
                                         positions)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
