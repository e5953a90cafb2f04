"""Decoder-only LM: ``repro.models.transformer`` (dense and MoE families)
in PyTorch: the serving paths on a paged KV pool and on the dense slot
cache, the training forward (``lm_forward`` with ``embeds``, ``remat``
and ``return_hidden``) and the windowed decode.

The layer ``scan`` of the JAX package becomes a loop over the stacked
per-layer weights, and the pack ``scan`` of ``lm_mixed_paged`` a loop over
packs; the gemma2 local/global alternation is a per-layer Python flag. JAX's
functional, donated cache updates become **in-place** writes into the
cache tensors: ``lm_step`` and every ``lm_*_paged`` function mutate
``cache.k`` / ``cache.v`` and still return the cache, so call sites read
like the reference. An ``moe`` layer's FFN is ``layers.moe_ffn`` over the
layer's own (padded) token set, as in JAX.

Every function takes the parallel context ``pctx`` and makes the JAX
package's ``constrain`` calls. Under its mesh the params, tokens and
caches are DTensors (``distributed/sharding.py`` places them), the
kernels run on local shards (``layers.dense_prefill_attention``,
``layers.paged_*``), an ``ep`` MoE layer runs ``moe_ffn_ep_local`` in
``local_map`` and the KV writes go through ``layers.write_kv``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    F32, ParallelCtx, apply_norm, attention, attn_out, attn_qkv, constrain,
    dense_prefill_attention, dp_for, embed_lookup, matmul_f32, mlp, moe_ffn,
    moe_ffn_ep, paged_decode_attention, paged_prefill_attention, paged_write,
    replicated_like, write_kv)
from repro_torch.obs import spans

class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (the port's
    counterpart of ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_DRAW_ELEMS = 1 << 27       # f32 values drawn at once (512 MiB)


def _normal(shape, scale, generator, dtype, device):
    """``scale * N(0, 1)`` in ``dtype``, drawn in f32 slices along the
    leading axis: a whole stacked full-width tensor in f32 (gemma2-27b's
    46 x 4608 x 36864 MLP weights: 31 GB) would not fit beside the model."""
    w = torch.empty(shape, dtype=dtype, device=device)
    rows = w.reshape(shape[0], -1)
    step = max(1, _DRAW_ELEMS // max(1, rows.shape[1]))
    for r0 in range(0, shape[0], step):
        part = torch.randn(rows[r0:r0 + step].shape, generator=generator,
                           dtype=F32, device=device)
        rows[r0:r0 + step] = part.mul_(scale)
    return w


def _norm_params(cfg: ModelConfig, lead, dim, dtype, device):
    shape = (*lead, dim)
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_params(cfg: ModelConfig, lead, nrm, dtype, device):
    """An attention block's weights (``init_attn`` of the JAX package),
    with ``lead`` stacking axes; ``nrm(shape, scale)`` draws."""
    D = cfg.d_model
    attn = {"wq": nrm((*lead, D, cfg.q_dim), D ** -0.5),
            "wk": nrm((*lead, D, cfg.kv_dim), D ** -0.5),
            "wv": nrm((*lead, D, cfg.kv_dim), D ** -0.5),
            "wo": nrm((*lead, cfg.q_dim, D), cfg.q_dim ** -0.5)}
    if cfg.qkv_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                          ("bv", cfg.kv_dim)):
            attn[name] = torch.zeros((*lead, dim), dtype=dtype,
                                     device=device)
    return attn


def _mlp_params(cfg: ModelConfig, lead, nrm):
    """A dense MLP's weights (``init_mlp`` of the JAX package)."""
    D, Fd = cfg.d_model, cfg.d_ff
    mlp = {"w_up": nrm((*lead, D, Fd), D ** -0.5),
           "w_down": nrm((*lead, Fd, D), Fd ** -0.5)}
    if cfg.gated_mlp:
        mlp["w_gate"] = nrm((*lead, D, Fd), D ** -0.5)
    return mlp


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """Random weights with the shapes and scales of
    ``repro.models.transformer.init_lm`` (not its bits: torch draws
    differently). Per-layer weights are stacked under ``"layers"`` with a
    leading ``n_layers`` axis; an ``moe`` layer carries ``"moe"`` (the
    router and the stacked experts of JAX's ``init_moe``) where a dense one
    carries ``"mlp"``. ``generator`` must live on ``device``."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"family {cfg.family!r} is not a transformer LM")
    D, L = cfg.d_model, (cfg.n_layers,)

    def nrm(shape, scale):
        return _normal(shape, scale, generator, dtype, device)

    layers = {"ln_attn": _norm_params(cfg, L, D, dtype, device),
              "attn": _attn_params(cfg, L, nrm, dtype, device),
              "ln_mlp": _norm_params(cfg, L, D, dtype, device)}
    if cfg.family == "moe":
        E, Fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        layers["moe"] = {"router": nrm((*L, D, E), D ** -0.5),
                         "w_gate": nrm((*L, E, D, Fe), D ** -0.5),
                         "w_up": nrm((*L, E, D, Fe), D ** -0.5),
                         "w_down": nrm((*L, E, Fe, D), Fe ** -0.5)}
    else:
        layers["mlp"] = _mlp_params(cfg, L, nrm)
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


def layer_kind_flags(cfg: ModelConfig) -> Tuple[bool, ...]:
    """(L,) Python flags: True where the layer uses local (sliding-window)
    attention. The JAX package carries them as a float array through its
    layer scan; the port's layer loop reads them as plain bools."""
    return tuple(k == "local" for k in cfg.layer_kinds())


def _window(cfg: ModelConfig, is_local: bool) -> Optional[int]:
    return cfg.sliding_window if is_local else None


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens, embeds=None):
    # F.embedding (in embed_lookup), not indexing: its backward sums a
    # token's rows in a fixed order (indexing's accumulating scatter does
    # not on the CPU), so a resumed training run repeats the uninterrupted
    # one bit for bit
    x = embed_lookup(tokens, params["embed"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if embeds is not None:   # modality-stub tokens are prepended
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def _unembed(cfg: ModelConfig, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = matmul_f32(x, w)
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _moe_block(cfg: ModelConfig, lp, h, pctx: Optional[ParallelCtx]):
    if pctx is not None and pctx.ep_axis is not None and pctx.mesh is not None:
        return moe_ffn_ep(cfg, lp["moe"], h, pctx)
    token_shard = "moe_replicated" in os.environ.get("REPRO_OPT", "")
    return moe_ffn(cfg, lp["moe"], h, pctx, token_shard=token_shard)


def _ffn_residual(cfg: ModelConfig, lp, x, o, pctx=None, pin: bool = False):
    """Residual add of the attention output, then the MLP (or MoE)
    sublayer. ``pin``: constrain the residual stream to the data axes
    after each add (the full-sequence layer's ``constrain`` calls)."""
    o = attn_out(lp["attn"], o)
    if cfg.post_sublayer_norm:
        o = apply_norm(cfg, lp["ln_post_attn"], o)
    x = x + o
    if pin:
        x = constrain(x, pctx, dp_for(pctx, x.shape[0]), None, None)
    h2 = apply_norm(cfg, lp["ln_mlp"], x)
    if cfg.family == "moe":
        f = _moe_block(cfg, lp, h2, pctx)
    else:
        f = mlp(cfg, lp["mlp"], h2, pctx)
    if cfg.post_sublayer_norm:
        f = apply_norm(cfg, lp["ln_post_mlp"], f)
    x = x + f
    if pin:
        x = constrain(x, pctx, dp_for(pctx, x.shape[0]), None, None)
    return x


# ---------------------------------------------------------------------------
# dense KV: one max_len region per batch row (the slot-dense layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Dense per-layer KV cache: k/v (L, B, Smax, Hkv, Dh), updated in
    place by ``lm_step``."""
    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device="cpu"):
        shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
        return cls(torch.zeros(shp, dtype=dtype, device=device),
                   torch.zeros(shp, dtype=dtype, device=device))


def _layer_full(cfg: ModelConfig, x, lp, is_local: bool, positions, pctx,
                given: bool):
    """Full-sequence layer (train / prefill). Returns (x, (k, v)). Rows at
    ``0..S-1`` (``given`` False) attend through the flash kernel; rows at
    ``given`` positions through the plain ``layers.attention``."""
    h = apply_norm(cfg, lp["ln_attn"], x)
    q, k, v = attn_qkv(cfg, lp["attn"], h, positions)
    if given:
        o = attention(q, k, v, positions, positions, causal=True,
                      window=cfg.sliding_window, is_local=is_local,
                      softcap=cfg.attn_logit_softcap)
    else:
        o = dense_prefill_attention(q, k, v, window=_window(cfg, is_local),
                                    softcap=cfg.attn_logit_softcap,
                                    q_offset=0, pctx=pctx)
    return _ffn_residual(cfg, lp, x, o, pctx, pin=True), (k, v)


def lm_forward(cfg: ModelConfig, params, tokens, *,
               pctx: Optional[ParallelCtx] = None, embeds=None,
               positions=None, return_cache: bool = False,
               remat: bool = False, return_hidden: bool = False):
    """tokens (B, S) -> logits (B, S_total, V) float32; optionally the
    per-layer KV as a ``KVCache`` of length S_total.

    ``embeds`` (B, N, D) are prepended to the token embeddings (the
    multimodal front end's stub tokens), so S_total = N + S. Without
    ``positions`` every row runs at ``0..S_total-1`` through the flash
    attention (``q_offset`` 0, the kernel on the card). With
    ``positions`` (B, S_total) int32, RoPE and the causal mask read them
    and the attention is the plain ``layers.attention`` (the JAX
    package's own function), since the kernel takes one host offset for
    all rows; no serving path passes them. ``remat`` recomputes each layer
    in the backward (``torch.utils.checkpoint``, non-reentrant: the
    counterpart of ``jax.checkpoint(policy=nothing_saveable)``),
    ``return_hidden`` returns the final-norm hidden states (B, S_total, D)
    instead of the logits."""
    x = _embed(cfg, params, tokens, embeds)
    B, S, _ = x.shape
    given = positions is not None
    if not given:
        positions = replicated_like(x, torch.arange(
            S, dtype=torch.int32, device=x.device).expand(B, S))
    x = constrain(x, pctx, dp_for(pctx, B), None, None)
    ks, vs = [], []
    for l, is_local in enumerate(layer_kind_flags(cfg)):
        lp = layer_params(params["layers"], l)
        if remat:
            x, (k, v) = checkpoint(_layer_full, cfg, x, lp, is_local,
                                   positions, pctx, given,
                                   use_reentrant=False)
        else:
            x, (k, v) = _layer_full(cfg, x, lp, is_local, positions, pctx,
                                    given)
        if return_cache:
            ks.append(k)
            vs.append(v)
    x = apply_norm(cfg, params["ln_final"], x)
    if return_hidden:
        return x
    logits = _unembed(cfg, params, x)
    logits = constrain(logits, pctx, dp_for(pctx, B), None,
                       pctx.tp_axis if pctx else None)
    if return_cache:
        return logits, KVCache(torch.stack(ks), torch.stack(vs))
    return logits


def lm_prefill(cfg: ModelConfig, params, tokens, *,
               pctx: Optional[ParallelCtx] = None, embeds=None,
               positions=None):
    """tokens (B, S) -> (last-position logits (B, V), KVCache of length
    S_total)."""
    logits, cache = lm_forward(cfg, params, tokens, pctx=pctx, embeds=embeds,
                               positions=positions, return_cache=True)
    return logits[:, -1], cache


def lm_step(cfg: ModelConfig, params, cache: KVCache, tokens,
            positions=None, *, q_offset: Optional[int] = None,
            n_real: Optional[int] = None,
            pctx: Optional[ParallelCtx] = None, return_hidden: bool = False):
    """An incremental step against the dense cache, written in place.
    tokens: (B, C) int32. Every layer writes its new KV at the step's
    positions (also its RoPE positions) and then attends over the cache
    (plus the sliding window on local layers). Returns (logits (B, C, V)
    float32, cache).

    Decode: ``positions`` (B, 1) int32, every row at its own position;
    plain ``layers.attention`` over the whole cache with ``kv_pos <=
    position``, as in the JAX package.

    Chunked prefill: ``q_offset`` (host int) instead of ``positions``, one
    sequence (B == 1) whose first ``n_real`` rows (default C) sit at
    ``q_offset, q_offset + 1, ...``; the rest are padded lanes parked at
    the scratch position ``Smax - 1``, their outputs garbage. The host
    start is the only source of the chunk's positions: it drives RoPE, the
    KV writes and the flash attention's mask. Anything else raises.

    ``return_hidden`` returns the final-norm hidden states (B, C, D) in
    place of the logits."""
    B, C = tokens.shape
    Smax = cache.k.shape[2]
    if q_offset is None:
        if positions is None or C != 1:
            raise ValueError("lm_step takes decode positions (B, 1), or a "
                             "chunk's host-side q_offset")
    else:
        if positions is not None or B != 1:
            raise ValueError("lm_step with q_offset is the chunked prefill "
                             "of one sequence: B == 1 and no positions")
        q_offset = int(q_offset)
        n_real = C if n_real is None else int(n_real)
        end = Smax if n_real == C else Smax - 1   # padded lanes: scratch
        if not 0 < n_real <= C or q_offset + n_real > end:
            raise ValueError(f"{n_real} real rows of a {C}-row chunk at "
                             f"{q_offset} do not fit below {end}")
        positions = torch.full((1, C), Smax - 1, dtype=torch.int32,
                               device=tokens.device)
        positions[0, :n_real] = torch.arange(q_offset, q_offset + n_real,
                                             dtype=torch.int32,
                                             device=tokens.device)
        positions = replicated_like(tokens, positions)
    x = _embed(cfg, params, tokens)                   # (B, C, D)
    x = constrain(x, pctx, dp_for(pctx, B), None, None)
    q_pos = positions
    if q_offset is None:
        kv_pos = replicated_like(x, torch.arange(
            Smax, dtype=positions.dtype, device=x.device).expand(B, Smax))
        kv_valid = kv_pos <= positions.max(dim=1, keepdim=True).values
    for l, is_local in enumerate(layer_kind_flags(cfg)):
        lp = layer_params(params["layers"], l)
        h = apply_norm(cfg, lp["ln_attn"], x)
        q, k_new, v_new = attn_qkv(cfg, lp["attn"], h, q_pos)
        k_l = write_kv(cache.k[l], positions, k_new)  # (B, Smax, Hkv, D)
        v_l = write_kv(cache.v[l], positions, v_new)
        if q_offset is None:
            o = attention(q, k_l, v_l, q_pos, kv_pos, kv_valid=kv_valid,
                          causal=True, window=cfg.sliding_window,
                          is_local=is_local, softcap=cfg.attn_logit_softcap)
        else:
            o = dense_prefill_attention(q, k_l, v_l,
                                        window=_window(cfg, is_local),
                                        softcap=cfg.attn_logit_softcap,
                                        q_offset=q_offset, pctx=pctx)
        x = _ffn_residual(cfg, lp, x, o, pctx)
    x = apply_norm(cfg, params["ln_final"], x)
    if return_hidden:
        return x, cache
    return _unembed(cfg, params, x), cache


def lm_decode(cfg: ModelConfig, params, cache: KVCache, tokens, positions,
              *, pctx: Optional[ParallelCtx] = None):
    """tokens (B,), positions (B,) -> (logits (B, V) float32, cache)."""
    logits, cache = lm_step(cfg, params, cache, tokens[:, None],
                            positions[:, None], pctx=pctx)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# windowed decode: local (sliding-window) layers keep a ring buffer of
# ``window`` KV slots instead of the full sequence, which halves the KV of a
# gemma2-style local/global alternation exactly. Plain attention over the
# ring, as the JAX package computes it outside any Pallas kernel.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WindowedKVCache:
    """k/v_loc: (Lp, B, W, Hkv, Dh) ring buffers (local layers); k/v_glob:
    (Lp, B, Smax, Hkv, Dh), Lp = n_layers / 2. The layer pattern must be
    ('local', 'global'). Updated in place by ``lm_decode_windowed``."""
    k_loc: Any
    v_loc: Any
    k_glob: Any
    v_glob: Any

    @classmethod
    def specs(cls, cfg: ModelConfig, batch: int, max_len: int,
              dtype=torch.bfloat16):
        if cfg.layer_pattern != ("local", "global"):
            raise ValueError("windowed KV needs the ('local', 'global') "
                             f"layer pattern, not {cfg.layer_pattern}")
        Lp = cfg.n_layers // 2
        loc = TensorSpec((Lp, batch, cfg.sliding_window, cfg.n_kv_heads,
                          cfg.head_dim_), dtype)
        glob = TensorSpec((Lp, batch, max_len, cfg.n_kv_heads,
                           cfg.head_dim_), dtype)
        return cls(loc, loc, glob, glob)

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device="cpu"):
        specs = cls.specs(cfg, batch, max_len, dtype)
        return cls(*(torch.zeros(sp.shape, dtype=dtype, device=device)
                     for sp in (specs.k_loc, specs.v_loc, specs.k_glob,
                                specs.v_glob)))


def lm_decode_windowed(cfg: ModelConfig, params, cache: WindowedKVCache,
                       tokens, positions, *,
                       pctx: Optional[ParallelCtx] = None):
    """Single-token decode with ring-buffered local layers: tokens (B,),
    positions (B,) -> (logits (B, V) float32, cache). Exact semantics:
    slot i of the ring holds the most recent position p <= pos with
    p = i (mod W), which is precisely the sliding-window attention set."""
    if cfg.layer_pattern != ("local", "global"):
        raise ValueError("windowed decode needs the ('local', 'global') "
                         f"layer pattern, not {cfg.layer_pattern}")
    B = tokens.shape[0]
    W = cfg.sliding_window
    Smax = cache.k_glob.shape[2]
    x = _embed(cfg, params, tokens[:, None])
    dev = x.device
    q_pos = positions[:, None]
    slot = replicated_like(x, torch.arange(W, dtype=positions.dtype,
                                           device=dev))
    ring_pos = q_pos - ((q_pos - slot[None]) % W)      # floor mod, as jnp's
    ring_valid = ring_pos >= 0
    kv_pos_g = replicated_like(x, torch.arange(
        Smax, dtype=positions.dtype, device=dev).expand(B, Smax))
    kv_valid_g = kv_pos_g <= q_pos

    def sublayer(x, lp, k_l, v_l, kv_pos, kv_valid, write_pos):
        h = apply_norm(cfg, lp["ln_attn"], x)
        q, k_new, v_new = attn_qkv(cfg, lp["attn"], h, q_pos)
        write_kv(k_l, write_pos[:, None], k_new)
        write_kv(v_l, write_pos[:, None], v_new)
        o = attention(q, k_l, v_l, q_pos, kv_pos, kv_valid=kv_valid,
                      causal=True, softcap=cfg.attn_logit_softcap)
        return _ffn_residual(cfg, lp, x, o, pctx)

    for i in range(cfg.n_layers // 2):
        x = sublayer(x, layer_params(params["layers"], 2 * i),
                     cache.k_loc[i], cache.v_loc[i], ring_pos, ring_valid,
                     positions % W)
        x = sublayer(x, layer_params(params["layers"], 2 * i + 1),
                     cache.k_glob[i], cache.v_glob[i], kv_pos_g, kv_valid_g,
                     positions)
    x = apply_norm(cfg, params["ln_final"], x)
    return _unembed(cfg, params, x[:, 0]), cache


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
                    write_offsets, *, pctx: Optional[ParallelCtx] = None):
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
    x = constrain(x, pctx, dp_for(pctx, tokens.shape[0]), None, None)
    q_pos = positions[:, None]
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        with spans.span("layer.attn"):
            h = apply_norm(cfg, lp["ln_attn"], x)
            q, k_new, v_new = attn_qkv(cfg, lp["attn"], h, q_pos)
            o, _, _ = paged_decode_attention(
                q[:, 0].contiguous(), cache.k[l], cache.v[l], block_tables,
                lengths, k_new=k_new[:, 0].contiguous(),
                v_new=v_new[:, 0].contiguous(), write_pages=write_pages,
                write_offsets=write_offsets, pctx=pctx)
        with spans.span("layer.ffn"):
            x = _ffn_residual(cfg, lp, x, o[:, None], pctx)
    x = apply_norm(cfg, params["ln_final"], x)
    return _unembed(cfg, params, x[:, 0]), cache


def lm_prefill_paged(cfg: ModelConfig, params, cache: PagedKVCache, tokens,
                     positions, table, write_pages, write_offsets, kv_len,
                     *, pctx: Optional[ParallelCtx] = None,
                     return_hidden: bool = False):
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
    through the table. Returns (logits (1, C, V) float32, cache), or with
    ``return_hidden`` the final-norm hidden states (1, C, D) in place of
    the logits.
    """
    if not supports_paged(cfg):
        raise ValueError("paged prefill: unsupported attention variant")
    x = _embed(cfg, params, tokens)                   # (1, C, D)
    x = constrain(x, pctx, dp_for(pctx, 1), None, None)
    q_pos = positions
    q_offset = positions[:, 0].to(torch.int32).contiguous()   # (1,)
    kv_len_b = replicated_like(x, torch.as_tensor(
        kv_len, dtype=torch.int32, device=x.device)).reshape(1)
    table_b = table.to(torch.int32).reshape(1, -1).contiguous()
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        with spans.span("layer.attn"):
            h = apply_norm(cfg, lp["ln_attn"], x)
            q, k_new, v_new = attn_qkv(cfg, lp["attn"], h, q_pos)
            k_l = paged_write(cache.k[l], write_pages, write_offsets,
                              k_new[0])
            v_l = paged_write(cache.v[l], write_pages, write_offsets,
                              v_new[0])
            o = paged_prefill_attention(q, k_l, v_l, table_b, kv_len_b,
                                        q_offset, pctx)
        with spans.span("layer.ffn"):
            x = _ffn_residual(cfg, lp, x, o, pctx)
    x = apply_norm(cfg, params["ln_final"], x)
    if return_hidden:
        return x, cache
    return _unembed(cfg, params, x), cache


def lm_mixed_paged(cfg: ModelConfig, params, cache: PagedKVCache,
                   p_tokens, p_positions, p_tables, p_write_pages,
                   p_write_offsets, p_kv_lens, p_last_idx,
                   d_tokens, d_positions, d_tables, d_lengths,
                   d_write_pages, d_write_offsets, *,
                   pctx: Optional[ParallelCtx] = None):
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
        with spans.span("step.pack"):
            hidden, cache = lm_prefill_paged(
                cfg, params, cache, p_tokens[j], p_positions[j],
                p_tables[j], p_write_pages[j], p_write_offsets[j],
                p_kv_lens[j], pctx=pctx, return_hidden=True)
            # logits at the pack's last token only (a whole chunk's would
            # be C x V floats). A one-element index tensor, not a 0-d one:
            # indexing with a 0-d CUDA tensor reads it back to the host (a
            # sync per pack)
            last = p_last_idx[j:j + 1].long()
            logits = _unembed(cfg, params, hidden[0, last])
            nxt.append(torch.argmax(logits, dim=-1)[0])
    p_next = (torch.stack(nxt).to(torch.int32) if nxt
              else torch.zeros((0,), dtype=torch.int32, device=dev))
    if d_tokens.shape[0] > 0:
        with spans.span("step.decode"):
            logits, cache = lm_decode_paged(cfg, params, cache, d_tokens,
                                            d_positions, d_tables,
                                            d_lengths, d_write_pages,
                                            d_write_offsets, pctx=pctx)
            d_next = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        d_next = torch.zeros((0,), dtype=torch.int32, device=dev)
    return p_next, d_next, cache


def lm_prefill_paged_gather(cfg: ModelConfig, params, cache: PagedKVCache,
                            tokens, positions, table, write_pages,
                            write_offsets, *,
                            pctx: Optional[ParallelCtx] = None):
    """Legacy chunked prefill: gather the lease into a dense view, run the
    dense ``lm_step`` on it, scatter the chunk's KV back.

    The exactness baseline for ``lm_prefill_paged``: the same argument
    layout minus ``kv_len``. Its attention is the dense ``flash_attention``
    (through ``lm_step``) where ``lm_prefill_paged`` runs
    ``paged_flash_attention``. ``lm_step`` takes the chunk's start on the
    host, so the positions are read back (one sync) and must have
    ``lm_step``'s form: the real rows at ``start, start + 1, ...``, the
    padded lanes at ``Np*page - 1``; anything else raises. Each chunk
    row's KV is read back from the dense view at its own position (JAX
    slices C rows from the start; the two agree wherever the chunk fits
    the view). Returns (logits (1, C, V) float32, cache), the pool updated
    in place.
    """
    if not supports_paged(cfg):
        raise ValueError("paged prefill: unsupported attention variant")
    L, _, page, Hkv, D = cache.k.shape
    tbl = table.long()
    S = tbl.shape[0] * page
    dense = KVCache(cache.k[:, tbl].reshape(L, 1, S, Hkv, D),
                    cache.v[:, tbl].reshape(L, 1, S, Hkv, D))
    pos = positions[0].tolist()
    start = pos[0]
    n_real = next((i for i, p in enumerate(pos) if p != start + i), len(pos))
    if any(p != S - 1 for p in pos[n_real:]):
        raise ValueError("positions must run from the chunk's start, the "
                         f"padded lanes at {S - 1}: {pos}")
    logits, dense = lm_step(cfg, params, dense, tokens, q_offset=start,
                            n_real=n_real, pctx=pctx)
    rows = positions[0].long()
    wp, wo = write_pages.long(), write_offsets.long()
    cache.k[:, wp, wo] = dense.k[:, 0, rows]
    cache.v[:, wp, wo] = dense.v[:, 0, rows]
    return logits, cache
