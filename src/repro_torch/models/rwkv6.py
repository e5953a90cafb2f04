"""RWKV6 ("Finch"): the serving paths of ``repro.models.rwkv6`` in PyTorch.

An attention-free LM with data-dependent per-channel decay. Every time mix
runs the WKV6 recurrence through ``ops.wkv``: on the card the hand-written
``wkv6`` kernel, on the CPU its plain sequential version. The JAX model
runs its own jnp ``wkv6_chunked`` there instead and reaches the Pallas
kernel only through its ``ops.wkv``; the port puts the kernel on the
path, a deliberate difference (ROADMAP.md section 3). ``wkv6_step`` stays
here and ``wkv6_chunked`` in ``kernels/ref.py`` (imported here), plain
functions held against JAX's.

The layer ``scan`` becomes a Python loop over the stacked per-layer
weights. ``rwkv_forward`` takes the serving arguments (``state``,
``return_state``), the training one, ``remat``, and the parallel context
``pctx``: under its mesh the recurrence runs ``ops.wkv`` on each rank's
batch and heads inside ``local_map`` (``_wkv``). Not ported: the JAX
package's ``REPRO_PROBE_CHUNK`` override (a knob of its roofline probe).
Training on the card differentiates through the kernel: ``ops.wkv``'s
autograd Function recomputes the chunked plain form in its backward
(``kernels/wkv6.py``). Dtypes follow the JAX model point for point: the
mixing and decay LoRAs accumulate in f32, r/k/v stay in the model dtype,
the gate, the decay and the recurrence's output are f32, and ``w_base``,
``u`` and ``ln_x_scale`` are f32 leaves under a bf16 model.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import wkv6_chunked  # noqa: F401  (re-export)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParallelCtx, constrain, dp_for, embed_lookup, head_placements,
    local_map, matmul, matmul_f32, rms_norm, split_heads)
from repro_torch.models.transformer import TensorSpec, _normal, layer_params

F32 = torch.float32
MIX_NAMES = ("w", "k", "v", "r", "g")


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(H, K): the head count follows from d_model / head_size, whatever
    ``cfg.n_heads`` says (the reduced config has n_heads 4 and H 4 only by
    coincidence of 128 / 32)."""
    K = cfg.rwkv.head_size
    return cfg.d_model // K, K


@dataclasses.dataclass
class RWKVState:
    """att_shift/ffn_shift: (L, B, D) in the model dtype; wkv:
    (L, B, H, K, K) float32."""
    att_shift: Any
    ffn_shift: Any
    wkv: Any

    @classmethod
    def specs(cls, cfg: ModelConfig, batch: int, dtype=torch.bfloat16):
        H, K = _heads(cfg)
        shift = TensorSpec((cfg.n_layers, batch, cfg.d_model), dtype)
        return cls(shift, shift,
                   TensorSpec((cfg.n_layers, batch, H, K, K), F32))

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
              device="cpu"):
        specs = cls.specs(cfg, batch, dtype)
        return cls(*(torch.zeros(s.shape, dtype=s.dtype, device=device)
                     for s in (specs.att_shift, specs.ffn_shift, specs.wkv)))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_rwkv(cfg: ModelConfig, generator: torch.Generator,
              dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """Random weights with the shapes, scales and per-leaf dtypes of
    ``repro.models.rwkv6.init_rwkv`` (not its bits: torch draws
    differently). Per-layer weights are stacked under ``"layers"`` with a
    leading ``n_layers`` axis, drawn slice by slice. ``generator`` must
    live on ``device``."""
    D, L = cfg.d_model, cfg.n_layers
    r, dl, Fd = cfg.rwkv.mix_lora, cfg.rwkv.decay_lora, cfg.d_ff
    s = D ** -0.5

    def nrm(shape, scale, dt=dtype):
        return _normal((L, *shape), scale, generator, dt, device)

    def full(shape, value, dt=dtype):
        return torch.full((L, *shape), value, dtype=dt, device=device)

    layers = {
        "mu_x": full((D,), 0.5),
        "mu": full((5, D), 0.5),
        "mix_A": nrm((D, 5 * r), s),
        "mix_B": nrm((5, r, D), r ** -0.5),
        "w_base": full((D,), -6.0, F32),
        "decay_A": nrm((D, dl), s),
        "decay_B": nrm((dl, D), dl ** -0.5),
        "u": nrm((D,), 0.1, F32),
        "wr": nrm((D, D), s),
        "wk": nrm((D, D), s),
        "wv": nrm((D, D), s),
        "wg": nrm((D, D), s),
        "wo": nrm((D, D), s),
        "ln_x_scale": full((D,), 1.0, F32),
        "ln1": full((D,), 0.0),
        "ln2": full((D,), 0.0),
        "cm_mu_k": full((D,), 0.5),
        "cm_mu_r": full((D,), 0.5),
        "cm_wk": nrm((D, Fd), s),
        "cm_wv": nrm((Fd, D), Fd ** -0.5),
        "cm_wr": nrm((D, D), s),
    }
    return {
        "embed": _normal((cfg.vocab_size, D), s, generator, dtype, device),
        "layers": layers,
        "ln_final": torch.zeros((D,), dtype=dtype, device=device),
        "lm_head": _normal((D, cfg.vocab_size), s, generator, dtype, device),
    }


# ---------------------------------------------------------------------------
# WKV6 plain forms (held against JAX's; the model path runs ops.wkv).
# ``wkv6_chunked`` lives in kernels/ref.py, where the wkv6 kernel's
# backward recomputes it.
#   S_t = diag(w_t) S_{t-1} + k_t v_t^T
#   o_t = r_t @ S_{t-1} + (r_t . (u*k_t)) v_t
# ---------------------------------------------------------------------------

def wkv6_step(r, k, v, w, u, state):
    """Single-token recurrence. r,k,v,w: (B, H, K); state (B, H, K, K) f32."""
    rf, kf, vf, wf = (a.to(F32) for a in (r, k, v, w))
    o = torch.einsum("bhk,bhkv->bhv", rf, state) + \
        torch.einsum("bhk,bhk->bh", rf, u.to(F32)[None] * kf)[..., None] * vf
    state = wf[..., None] * state + torch.einsum("bhk,bhv->bhkv", kf, vf)
    return o, state


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _shifted(x, shift_in):
    """dx = x_{t-1} - x_t, with ``shift_in`` (B, D) as x_{-1}."""
    x_prev = torch.cat([shift_in[:, None], x[:, :-1]], dim=1)
    return x_prev - x


def _dyn_mix(p, x, dx):
    """5-way data-dependent token-shift mix -> dict of mixed inputs."""
    base = x + dx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(matmul_f32(base, p["mix_A"]))
    r5 = split_heads(lora, 5)
    offs = torch.einsum("btnr,nrd->nbtd", r5, p["mix_B"].to(F32))
    xf, dxf = x.to(F32), dx.to(F32)
    return {name: (xf + dxf * (p["mu"][i].to(F32) + offs[i])).to(x.dtype)
            for i, name in enumerate(MIX_NAMES)}


def _decay(p, xw):
    """Data-dependent decay w in (0,1): exp(-exp(base + lora(xw))), the
    pre-decay exponent clipped to [-20, 0.35] as in the JAX model."""
    lora = matmul(torch.tanh(matmul_f32(xw, p["decay_A"])),
                  p["decay_B"].to(F32))
    return torch.exp(-torch.exp(torch.clamp(p["w_base"] + lora, -20.0,
                                            0.35)))


def _group_norm(o, scale, H):
    """Per-head normalisation of (..., H, K) flattened to (..., D). The
    variance is the population one (``jnp.var``), not torch's default."""
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, correction=0)
    o = (o - mu) * torch.rsqrt(var + 1e-5)
    return o.reshape(*o.shape[:-2], -1) * scale


def _wkv(pctx: Optional[ParallelCtx], r, k, v, w, u, state, chunk):
    """``ops.wkv``; under a mesh on each rank's shard of the batch (data
    axes, where it divides) and the heads (model axis, where H divides),
    inside ``local_map``: the recurrence is independent per (b, h)."""
    if not isinstance(r, DTensor):
        return ops.wkv(r, k, v, w, u, state, chunk=chunk)
    B, _, H, _ = r.shape
    x_pl = head_placements(pctx, B, H, H)[0]              # (B, T, H, K)
    s_pl = tuple(Shard(1) if p == Shard(2) else p for p in x_pl)  # (B,H,..)
    u_pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in x_pl)
    # u is shared by the batch: each data rank's gradient covers its rows
    u_grad = tuple(Partial() if p == Shard(0) else q
                   for p, q in zip(x_pl, u_pl))
    fn = local_map(partial(ops.wkv, chunk=chunk),
                   out_placements=(x_pl, s_pl),
                   in_placements=(x_pl, x_pl, x_pl, x_pl, u_pl, s_pl),
                   in_grad_placements=(x_pl, x_pl, x_pl, x_pl, u_grad, s_pl),
                   device_mesh=pctx.mesh, redistribute_inputs=True)
    return fn(r, k, v, w, u, state)


def time_mix_full(cfg: ModelConfig, p, x, shift_in, wkv_state, chunk=32,
                  pctx: Optional[ParallelCtx] = None):
    """Full-sequence time mix. x (B,T,D). Returns (out, last_x, new_state).
    T must be at most ``chunk`` or a multiple of it (the reference's
    contract); the recurrence runs in ``ops.wkv``."""
    B, T, D = x.shape
    H, K = _heads(cfg)
    m = _dyn_mix(p, x, _shifted(x, shift_in))
    r = split_heads(matmul(m["r"], p["wr"]), H)
    k = split_heads(matmul(m["k"], p["wk"]), H)
    v = split_heads(matmul(m["v"], p["wv"]), H)
    g = F.silu(matmul(m["g"], p["wg"]).to(F32))
    w = split_heads(_decay(p, m["w"]), H)
    u = p["u"].reshape(H, K)
    o, new_state = _wkv(pctx, r, k, v, w, u, wkv_state, min(chunk, T))
    o = _group_norm(o, p["ln_x_scale"], H) * g
    out = matmul(o.to(x.dtype), p["wo"])
    return out, x[:, -1], new_state


def time_mix_step(cfg: ModelConfig, p, x, shift_in, wkv_state):
    """Single-token time mix. x (B, D)."""
    out, last, state = time_mix_full(cfg, p, x[:, None], shift_in,
                                     wkv_state, chunk=1)
    return out[:, 0], last, state


def channel_mix(p, x, shift_in):
    """x (B,T,D) or (B,D) with matching shift_in (B,D)."""
    single = x.dim() == 2
    if single:
        x = x[:, None]
    dx = _shifted(x, shift_in)
    xk = x + dx * p["cm_mu_k"].to(x.dtype)
    xr = x + dx * p["cm_mu_r"].to(x.dtype)
    k = torch.square(torch.relu(matmul_f32(xk, p["cm_wk"])))
    kv = matmul(k.to(x.dtype), p["cm_wv"])
    out = torch.sigmoid(matmul_f32(xr, p["cm_wr"])).to(x.dtype) * kv
    last = x[:, -1]
    return (out[:, 0], last) if single else (out, last)


# ---------------------------------------------------------------------------
# model-level forward
# ---------------------------------------------------------------------------

def _layer(cfg: ModelConfig, lp, x, att_shift, ffn_shift, wkv_state,
           pctx=None):
    """One block: time mix, then channel mix, each a residual. Returns
    (x, att_last, ffn_last, wkv_new)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    att, att_last, wkv_new = time_mix_full(cfg, lp, h, att_shift, wkv_state,
                                           pctx=pctx)
    x = x + att
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    ffn, ffn_last = channel_mix(lp, h2, ffn_shift)
    return x + ffn, att_last, ffn_last, wkv_new


def _zero_state(cfg: ModelConfig, B: int, x, pctx) -> RWKVState:
    """Zeros of the carried state; under a mesh, DTensors with the
    placements of ``sharding.cache_specs``."""
    if pctx is None or pctx.mesh is None:
        return RWKVState.zeros(cfg, B, x.dtype, x.device)
    from repro_torch.distributed import sharding as sh
    return sh.zeros(RWKVState.specs(cfg, B, x.dtype), pctx.mesh,
                    sh.cache_specs(cfg, pctx.mesh, B))


def rwkv_forward(cfg: ModelConfig, params, tokens, *,
                 pctx: Optional[ParallelCtx] = None,
                 state: Optional[RWKVState] = None,
                 return_state: bool = False, remat: bool = False):
    """tokens (B, T) -> logits (B, T, V) float32; optionally the carried
    ``RWKVState``. A ``state`` resumes the sequences where it left them
    (decode, or a later round's prompt). ``remat`` recomputes each layer
    in the backward (``torch.utils.checkpoint``, non-reentrant: the
    counterpart of ``jax.checkpoint``)."""
    B, T = tokens.shape
    x = embed_lookup(tokens, params["embed"])   # see tf._embed
    x = constrain(x, pctx, dp_for(pctx, x.shape[0]), None, None)
    if state is None:
        state = _zero_state(cfg, B, x, pctx)
    att_s, ffn_s, wkv_s = [], [], []
    for l in range(cfg.n_layers):
        args = (cfg, layer_params(params["layers"], l), x, state.att_shift[l],
                state.ffn_shift[l], state.wkv[l], pctx)
        if remat:
            x, att_last, ffn_last, wkv_new = checkpoint(
                _layer, *args, use_reentrant=False)
        else:
            x, att_last, ffn_last, wkv_new = _layer(*args)
        att_s.append(att_last)
        ffn_s.append(ffn_last)
        wkv_s.append(wkv_new)
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = matmul_f32(x, params["lm_head"])
    if return_state:
        return logits, RWKVState(torch.stack(att_s), torch.stack(ffn_s),
                                 torch.stack(wkv_s))
    return logits


def rwkv_prefill(cfg: ModelConfig, params, tokens, *,
                 pctx: Optional[ParallelCtx] = None):
    """tokens (B, T) -> (last-position logits (B, V), state)."""
    logits, st = rwkv_forward(cfg, params, tokens, pctx=pctx,
                              return_state=True)
    return logits[:, -1], st


def rwkv_decode(cfg: ModelConfig, params, state: RWKVState, tokens,
                positions=None, *, pctx: Optional[ParallelCtx] = None):
    """tokens (B,) -> (logits (B,V), new state). positions unused (the
    state carries the sequence)."""
    logits, st = rwkv_forward(cfg, params, tokens[:, None], pctx=pctx,
                              state=state, return_state=True)
    return logits[:, -1], st
