"""Distributed step builders: the port of ``repro.distributed.steps``.

    build_train_step(cfg, mesh, opt, remat, chunked_ce) -> train_step(
                                             params, opt_state, batch)
    build_prefill_step(cfg, mesh)                       -> prefill_step(
                                             params, batch)
    build_decode_step(cfg, mesh, windowed)              -> serve_step(
                                             params, cache, tokens, positions)
    build_cell(cfg, spec, mesh)     -> (step_fn, stand-in args) of one
                                       dry-run (arch x shape) cell

The train step runs the forward, the loss, autograd's backward and
``adamw_update`` (in place). On the card its forward runs the kernels
(``flash_attention`` for every full-sequence attention of the dense, moe,
zamba2 and whisper families, ``wkv6`` for rwkv6) and its backward their
autograd Functions (``kernels/_grad.py``).

``mesh`` (a ``DeviceMesh``, or None for one device) gives the steps their
parallel context (``sharding.make_pctx``). Under a mesh the params, the
optimizer state and the caches are DTensors (``shard_params``,
``shard_opt_state``, ``sharding.distribute``); a batch or a decode input
given as whole tensors is distributed over the data axes by the step
itself, each rank's shard cut from rank 0's tensor. The train step's
gradients come back in their params' placements and its metrics whole.

The stand-ins of a cell (``_param_sds`` and the rest) are DTensors whose
local shards are fake tensors (``FakeTensorMode``): the shapes and
placements of the reference's sharded ``ShapeDtypeStruct``s, no memory.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models import model_zoo
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParallelCtx
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         tree_leaves, tree_map)

F32 = torch.float32
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# placing the train state and the inputs on a mesh
# ---------------------------------------------------------------------------

def shard_params(cfg: ModelConfig, mesh, params):
    """The params as DTensors with ``sharding.param_specs``' placements."""
    return sh.distribute(params, mesh, sh.param_specs(cfg, mesh, params))


def shard_opt_state(cfg: ModelConfig, mesh, opt_state: OptState) -> OptState:
    """The moments as DTensors with ``opt_moment_spec``'s placements (ZeRO-1:
    their largest free dimension also over 'data'); the step stays whole."""
    specs = sh.param_specs(cfg, mesh, opt_state.mu)

    def place(moments):
        return sh._zip_map(lambda t, s: _place(t, mesh, sh.opt_moment_spec(
            s, tuple(t.shape), mesh)), moments, specs)
    return OptState(opt_state.step, place(opt_state.mu),
                    place(opt_state.nu))


def _place(x, mesh, spec):
    if isinstance(x, DTensor) or mesh is None:
        return x
    return distribute_tensor(x, mesh, sh.placements(mesh, spec))


def _batch_spec(mesh, ndim: int) -> P:
    return P(*sh.batch_spec(mesh)[:1], *(None,) * (ndim - 1))


def shard_batch(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Every tensor of ``batch`` split over the data axes on its first
    (batch) dimension."""
    return {k: _place(v, mesh, _batch_spec(mesh, v.dim()))
            for k, v in batch.items()}


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _greedy(logits):
    """argmax over the vocabulary, int32; a vocabulary split over the
    model axis is gathered first (DTensor has no argmax across shards)."""
    if isinstance(logits, DTensor):
        last = logits.dim() - 1
        logits = logits.redistribute(logits.device_mesh, tuple(
            Replicate() if p.is_shard(last) else p
            for p in logits.placements))
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _ce_sum(logits, targets):
    """Sum over rows of ``logsumexp - target logit``, in f32. The target
    logit is gathered on one device; on a DTensor it is JAX's
    iota-compare masked sum (elementwise on a vocabulary split over the
    model axis, then a sum over it), which adds the same single value."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    if isinstance(lf, DTensor):
        from repro_torch.models.layers import replicated_like
        iota = replicated_like(lf, torch.arange(lf.shape[-1],
                                                device=lf.device))
        tgt = torch.sum(torch.where(iota == targets.long()[..., None], lf,
                                    0.0), dim=-1)
    else:
        tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.sum(lse - tgt)


def cross_entropy(logits, targets):
    """Mean token cross-entropy of (..., V) logits against (...) targets
    (see ``_ce_sum``)."""
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
    total = 0.0
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
               pctx: Optional[ParallelCtx] = None, remat: bool = True,
               chunked_ce: bool = False):
    """The train step's loss: ``cross_entropy`` of ``model_zoo.forward``
    (every family; whisper reads ``batch['frames']``) against
    ``batch['targets']``, or, with ``chunked_ce`` on the dense and moe
    families, ``chunked_cross_entropy`` of ``lm_forward``'s hidden states
    (the other families take the whole logits, as in JAX)."""
    if chunked_ce and cfg.family in ("dense", "moe"):
        hidden = tf.lm_forward(cfg, params, batch["tokens"], pctx=pctx,
                               embeds=batch.get("embeds"), remat=remat,
                               return_hidden=True)
        tgt = _pad_targets(batch["targets"], hidden.shape[1])
        return chunked_cross_entropy(cfg, params, hidden, tgt)
    logits = model_zoo.forward(cfg, params, batch, pctx=pctx, remat=remat)
    return cross_entropy(logits, _pad_targets(batch["targets"],
                                              logits.shape[1]))


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, Any], *,
                   pctx: Optional[ParallelCtx] = None, remat: bool = True,
                   chunked_ce: bool = False):
    """(loss, grads): ``train_loss`` and its gradient with respect to every
    param leaf, a tree like ``params`` (zeros where a leaf does not reach
    the loss, as in JAX). The params require grad only inside the call.
    A DTensor gradient is redistributed to its param's placements (a
    partial sum over the data axes is reduced)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = train_loss(cfg, params, batch, pctx=pctx, remat=remat,
                              chunked_ce=chunked_ce)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    by_id = {id(p): _in_placements(g, p) if g is not None
             else torch.zeros_like(p) for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], params)


def _in_placements(g, p):
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, mesh=None, *,
                     opt: Optional[OptConfig] = None, remat: bool = True,
                     chunked_ce: bool = False):
    opt = opt or OptConfig()
    pctx = sh.make_pctx(cfg, mesh)

    def train_step(params, opt_state: OptState, batch):
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        loss, grads = loss_and_grads(cfg, params, batch, pctx=pctx,
                                     remat=remat, chunked_ce=chunked_ce)
        params, opt_state, metrics = adamw_update(opt, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, {k: _whole(v) for k, v in metrics.items()}

    return train_step


def build_prefill_step(cfg: ModelConfig, mesh=None):
    pctx = sh.make_pctx(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        last_logits, cache = model_zoo.prefill(cfg, params, batch, pctx=pctx)
        return _greedy(last_logits), cache

    return prefill_step


def build_decode_step(cfg: ModelConfig, mesh=None, *,
                      windowed: bool = False):
    pctx = sh.make_pctx(cfg, mesh)
    decode = tf.lm_decode_windowed if windowed else model_zoo.decode

    @torch.no_grad()
    def serve_step(params, cache, tokens, positions):
        if mesh is not None:
            tokens = _place(tokens, mesh, _decode_spec(mesh, tokens.shape[0]))
            positions = _place(positions, mesh,
                               _decode_spec(mesh, positions.shape[0]))
        logits, cache = decode(cfg, params, cache, tokens, positions,
                               pctx=pctx)
        return _greedy(logits), cache

    return serve_step


def _decode_spec(mesh, B: int) -> P:
    """Decode tokens and positions: over the data axes where B divides."""
    dp = sh.batch_spec(mesh)[0]
    return P(dp if B % sh._dp_size(mesh) == 0 and B >= sh._dp_size(mesh)
             else None)


# ---------------------------------------------------------------------------
# cell assembly: (step_fn, stand-in args)
# ---------------------------------------------------------------------------

def _sds(shape, dtype, mesh, spec: P):
    """A DTensor stand-in: ``shape`` with ``spec``'s placements, its local
    shard a fake tensor (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import empty
    return empty(tuple(shape), dtype=dtype, device_mesh=mesh,
                 placements=sh.placements(mesh, spec))


def _param_sds(cfg: ModelConfig, mesh, dtype=BF16):
    params = model_zoo.init(cfg, 0, dtype, device="cpu")   # fake: no memory
    specs = sh.param_specs(cfg, mesh, params)

    def place(p, s):
        if isinstance(p, dict):
            return {k: place(v, s[k]) for k, v in p.items()}
        return _sds(p.shape, p.dtype, mesh, s)
    return place(params, specs)


def _opt_sds(param_sds, cfg=None, mesh=None) -> OptState:
    def moment(s):
        spec = P(*(None,) * s.dim())
        if mesh is not None:
            spec = sh.opt_moment_spec(sh.spec_of(s), tuple(s.shape), mesh)
        return _sds(s.shape, F32, mesh or s.device_mesh, spec)

    return OptState(torch.zeros((), dtype=torch.int32),
                    tree_map(moment, param_sds), tree_map(moment, param_sds))


def _batch_sds(cfg: ModelConfig, spec: ShapeSpec, mesh,
               with_targets: bool) -> Dict[str, Any]:
    dp = sh.batch_spec(mesh)[0]
    B, S = spec.global_batch, spec.seq_len
    bsp = P(dp, None)
    batch: Dict[str, Any] = {}
    if cfg.family == "whisper":
        enc_len = S // 4                      # conv-stub downsampling
        dec_len = min(cfg.max_target_len, S)
        batch["frames"] = _sds((B, enc_len, cfg.d_model), BF16, mesh,
                               P(dp, None, None))
        batch["tokens"] = _sds((B, dec_len), torch.int32, mesh, bsp)
        if with_targets:
            batch["targets"] = _sds((B, dec_len), torch.int32, mesh, bsp)
        return batch
    n_text = S
    if cfg.frontend == "image_patches":
        n_text = S - cfg.n_frontend_tokens
        batch["embeds"] = _sds((B, cfg.n_frontend_tokens, cfg.d_model), BF16,
                               mesh, P(dp, None, None))
    batch["tokens"] = _sds((B, n_text), torch.int32, mesh, bsp)
    if with_targets:
        batch["targets"] = _sds((B, S), torch.int32, mesh, bsp)
    return batch


def _sds_tree(shapes, specs, mesh):
    """Stand-ins for a cache of ``TensorSpec``s with its tree of ``P``."""
    return sh._zip_map(lambda s, p: _sds(s.shape, s.dtype, mesh, p),
                       shapes, specs)


def _cache_sds(cfg: ModelConfig, spec: ShapeSpec, mesh):
    B, S = spec.global_batch, spec.seq_len
    seq_shard = B < sh._dp_size(mesh)
    enc_len = S // 4 if cfg.family == "whisper" else 0
    max_len = min(cfg.max_target_len, S) if cfg.family == "whisper" else S
    shapes = model_zoo.cache_specs(cfg, B, max_len, BF16, enc_len=enc_len)
    specs = sh.cache_specs(cfg, mesh, B, seq_shard=seq_shard)
    return _sds_tree(shapes, specs, mesh)


def _windowed_cache_sds(cfg: ModelConfig, spec: ShapeSpec, mesh):
    B, S = spec.global_batch, spec.seq_len
    shapes = tf.WindowedKVCache.specs(cfg, B, S, BF16)
    h_ax, d_ax = sh.kv_head_axis(cfg, mesh)
    seq_shard = B < sh._dp_size(mesh)
    b_ax: Any = sh.batch_spec(mesh)[0] if not seq_shard else None
    loc = P(None, b_ax, None, h_ax, d_ax)              # ring stays unsharded in W
    glob = P(None, b_ax, "data" if seq_shard else None, h_ax, d_ax)
    return _sds_tree(shapes, tf.WindowedKVCache(loc, loc, glob, glob), mesh)


def perf_opts() -> set:
    """Beyond-paper perf-iteration toggles:
    REPRO_OPT=chunked_ce,moe_replicated,windowed_kv (comma-separated)."""
    return set(filter(None, os.environ.get("REPRO_OPT", "").split(",")))


def build_cell(cfg: ModelConfig, spec: ShapeSpec, mesh) -> Tuple[Any, Tuple]:
    """(step_fn, stand-in args) for one dry-run cell. Call under
    ``FakeTensorMode`` with ``mesh`` over the current process group."""
    opts = perf_opts()
    if spec.kind == "train":
        params = _param_sds(cfg, mesh)
        opt_state = _opt_sds(params, cfg, mesh)
        batch = _batch_sds(cfg, spec, mesh, with_targets=True)
        fn = build_train_step(cfg, mesh, chunked_ce="chunked_ce" in opts)
        return fn, (params, opt_state, batch)
    if spec.kind == "prefill":
        params = _param_sds(cfg, mesh)
        batch = _batch_sds(cfg, spec, mesh, with_targets=False)
        return build_prefill_step(cfg, mesh), (params, batch)
    if spec.kind == "decode":
        params = _param_sds(cfg, mesh)
        windowed = ("windowed_kv" in opts
                    and cfg.layer_pattern == ("local", "global")
                    and cfg.family == "dense")
        cache = (_windowed_cache_sds if windowed else _cache_sds)(
            cfg, spec, mesh)
        B = spec.global_batch
        tokens = _sds((B,), torch.int32, mesh, _decode_spec(mesh, B))
        positions = _sds((B,), torch.int32, mesh, _decode_spec(mesh, B))
        fn = build_decode_step(cfg, mesh, windowed=windowed)
        return fn, (params, cache, tokens, positions)
    raise ValueError(spec.kind)
