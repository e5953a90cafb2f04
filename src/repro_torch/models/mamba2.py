"""Mamba2 (SSD): ``repro.models.mamba2`` in PyTorch.

Recurrence (per head h, head dim P, state dim N):
    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t
    y_t = S_t @ C_t + D_h * x_t
Train and prefill run the chunked form (block products within a chunk, a
scan over chunks); decode runs the one-step recurrence on the carried
(conv, ssm) state.

The SSD scan is plain PyTorch, as the JAX package keeps it plain jnp
outside any Pallas kernel: the chunk ``scan`` becomes a Python loop over
chunks of batched products. Dtypes follow the JAX model point for point:
the projections accumulate in f32 and are cast to the model dtype, the
scan and the gated norm run in f32, the ssm state is f32, and ``A_log``,
``dt_bias``, ``D_skip`` and ``gn_scale`` are f32 leaves under a bf16
model. ``F.softplus`` returns x above 20 where JAX's has no threshold
(they differ by below 2e-9 there). Not ported: the JAX package's
``REPRO_PROBE_CHUNK`` override (a knob of its roofline probe).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (head_placements, local_map, matmul,
                                       matmul_f32, split_heads)
from repro_torch.models.transformer import TensorSpec, _normal

F32 = torch.float32
_SECTIONS = ("w_z", "w_x", "w_B", "w_C", "w_dt")


@dataclasses.dataclass
class MambaState:
    """conv: (..., B, conv_ch, d_conv - 1) in the model dtype; ssm:
    (..., B, H, P, N) float32."""
    conv: Any
    ssm: Any


def conv_channels(cfg: ModelConfig) -> int:
    di = cfg.ssm.d_inner(cfg.d_model)
    return di + 2 * cfg.ssm.d_state


def state_specs(cfg: ModelConfig, n_layers: int, batch: int,
                dtype=torch.bfloat16) -> MambaState:
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    return MambaState(
        TensorSpec((n_layers, batch, conv_channels(cfg), s.d_conv - 1),
                   dtype),
        TensorSpec((n_layers, batch, H, P, N), F32))


def state_zeros(cfg: ModelConfig, n_layers: int, batch: int,
                dtype=torch.bfloat16, device="cpu") -> MambaState:
    specs = state_specs(cfg, n_layers, batch, dtype)
    return MambaState(*(torch.zeros(sp.shape, dtype=sp.dtype, device=device)
                        for sp in (specs.conv, specs.ssm)))


def init_mamba_layers(cfg: ModelConfig, n_layers: int,
                      generator: torch.Generator, dtype=torch.bfloat16,
                      device="cpu") -> Dict[str, Any]:
    """``n_layers`` layers of ``repro.models.mamba2.init_mamba_layer``'s
    shapes, scales and per-leaf dtypes (not its bits), stacked along a
    leading axis. The projections are kept per section (z, x, B, C, dt),
    as in JAX. ``generator`` must live on ``device``."""
    D, L = cfg.d_model, n_layers
    s = cfg.ssm
    di, H = s.d_inner(D), s.n_heads(D)
    sd = D ** -0.5

    def nrm(shape, scale):
        return _normal((L, *shape), scale, generator, dtype, device)

    def full(shape, value, dt=dtype):
        return torch.full((L, *shape), value, dtype=dt, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                     device=device))
    return {
        "ln": full((D,), 0.0),
        "w_z": nrm((D, di), sd),
        "w_x": nrm((D, di), sd),
        "w_B": nrm((D, s.d_state), sd),
        "w_C": nrm((D, s.d_state), sd),
        "w_dt": nrm((D, H), sd),
        "conv_x_w": nrm((di, s.d_conv), 0.2),
        "conv_x_b": full((di,), 0.0),
        "conv_bc_w": nrm((2 * s.d_state, s.d_conv), 0.2),
        "conv_bc_b": full((2 * s.d_state,), 0.0),
        "A_log": a_log.repeat(L, 1),                  # A = -exp(A_log)
        "dt_bias": full((H,), -4.0, F32),
        "D_skip": full((H,), 1.0, F32),
        "w_out": nrm((di, D), di ** -0.5),
        "gn_scale": full((di,), 1.0, F32),
    }


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, Bm, Cm, state, chunk: int):
    """x: (B, T, H, P); dt: (B, T, H); A: (H,) negative; Bm/Cm: (B, T, N);
    state: (B, H, P, N) f32; ``chunk`` divides T. Returns (y (B, T, H, P)
    f32, new state).

    Within a chunk the weight of step i at step t >= i is exp(cum_t -
    cum_i), taken here as the exp of the difference masked to -inf above
    the diagonal: at most 1, finite for any decay, and so is its gradient.
    JAX takes it as exp(cum_t - half) * exp(half - cum_i), ``half`` half
    the chunk's total log decay: the same values while the factors stay
    inside f32's exp range, but a chunk with ``|sum dt * A|`` past ~177
    overflows its forward, and past ~88.7 its gradient (the masked
    product above the diagonal overflows and its mask, applied after the
    product with C.B, leaves 0 * inf in C.B's gradient). A full-width
    zamba2 training run passes both within two AdamW steps (ROADMAP.md
    section 3)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = T // chunk
    xs = x.to(F32).reshape(B, nc, chunk, H, P)
    dts = dt.to(F32).reshape(B, nc, chunk, H)
    Bs = Bm.to(F32).reshape(B, nc, chunk, N)
    Cs = Cm.to(F32).reshape(B, nc, chunk, N)
    Af = A.to(F32)
    ci = torch.arange(chunk, device=x.device)
    tri = ci[None, :] <= ci[:, None]             # inclusive lower triangular
    S = state.to(F32)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xs[:, c], dts[:, c], Bs[:, c], Cs[:, c]
        la = dtc * Af[None, None]                # per-step log decay (<= 0)
        cum = torch.cumsum(la, dim=1)            # (B, C, H)
        # inter-chunk: y_t += exp(cum_t) * C_t @ S^T
        y_inter = torch.exp(cum)[..., None] * \
            torch.einsum("bhpn,bcn->bchp", S, Cc)
        # intra-chunk: y_t += sum_{i<=t} exp(cum_t-cum_i) dt_i (C_t.B_i) x_i
        # with exp(cum_t - cum_i) <= 1 taken of the masked difference (see
        # the docstring for JAX's centred form)
        cum_h = cum.transpose(1, 2)                          # (B, H, C)
        seg = cum_h[..., :, None] - cum_h[..., None, :]      # cum_t - cum_i
        decay = torch.exp(torch.where(tri, seg, float("-inf")))
        cb = torch.einsum("bcn,bin->bci", Cc, Bc)
        att = cb[:, None] * decay * dtc.transpose(1, 2)[..., None, :]
        y_intra = torch.einsum("bhci,bihp->bchp", att, xc)
        # state update
        total = cum[:, -1]                       # (B, H)
        k_dec = torch.exp(total[:, None] - cum) * dtc
        S = torch.exp(total)[..., None, None] * S + \
            torch.einsum("bch,bchp,bcn->bhpn", k_dec, xc, Bc)
        ys.append(y_inter + y_intra)
    return torch.stack(ys, dim=1).reshape(B, T, H, P), S


def ssd_step(x, dt, A, Bm, Cm, state):
    """One token: x (B, H, P); dt (B, H); Bm/Cm (B, N); state (B, H, P, N)
    f32."""
    xf, dtf, Bf, Cf = (a.to(F32) for a in (x, dt, Bm, Cm))
    decay = torch.exp(dtf * A.to(F32)[None])                  # (B, H)
    state = decay[..., None, None] * state + \
        torch.einsum("bh,bhp,bn->bhpn", dtf, xf, Bf)
    y = torch.einsum("bhpn,bn->bhp", state, Cf)
    return y, state


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------

def _project(p, x):
    """x (..., D) -> (z, xc, Bc, Cc, dt), each an f32-accumulated product
    cast to the model dtype."""
    return tuple(matmul_f32(x, p[name]).to(x.dtype) for name in _SECTIONS)


def _rmsnorm_gated(y, z, scale):
    yf = y.to(F32) * F.silu(z.to(F32))
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + 1e-6) * scale


def _causal_conv(u, state, w, b, d_conv: int, T: int):
    """u (B, T, ch); state (B, ch, d_conv - 1) -> (silu(conv(u)), new
    state)."""
    pad = state.to(u.dtype).movedim(-1, 1)              # (B, d_conv-1, ch)
    up = torch.cat([pad, u], dim=1)
    new_state = up[:, -(d_conv - 1):].movedim(1, -1)
    wf = w.to(F32)
    out = sum(up[:, i:i + T].to(F32) * wf[:, i] for i in range(d_conv))
    return F.silu(out + b.to(F32)).to(u.dtype), new_state


def _causal_conv_step(u, state, w, b):
    """u (B, ch); state (B, ch, d_conv - 1)."""
    window = torch.cat([state.to(F32), u.to(F32)[..., None]], dim=-1)
    new_state = window[..., 1:].to(state.dtype)
    out = torch.einsum("bcw,cw->bc", window, w.to(F32))
    return F.silu(out + b.to(F32)).to(u.dtype), new_state


def _conv_and_gates(cfg: ModelConfig, p, x, conv_state, conv):
    """The shared front half of both blocks: the projections, the causal
    convolution of each section (``conv``: the full or the one-step form)
    and the discretisation. Returns (z, xc, Bc, Cc, dt f32, A, new
    conv state)."""
    s = cfg.ssm
    di, N = s.d_inner(x.shape[-1]), s.d_state
    z, xc, Bc, Cc, dt = _project(p, x)
    bc = torch.cat([Bc, Cc], dim=-1)
    xc, new_conv_x = conv(xc, conv_state[..., :di, :], p["conv_x_w"],
                          p["conv_x_b"])
    bc, new_conv_bc = conv(bc, conv_state[..., di:, :], p["conv_bc_w"],
                           p["conv_bc_b"])
    new_conv = torch.cat([new_conv_x, new_conv_bc], dim=-2)
    Bc, Cc = torch.split(bc, [N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, xc, Bc, Cc, dt, A, new_conv


def _ssd(pctx, fn, args, **kw):
    """``fn`` (the chunked scan or the one-token step) of (x, dt, A, B, C,
    state); under a mesh on each rank's shard of the batch (data axes,
    where it divides) and the heads (model axis, where H divides) inside
    ``local_map``: the recurrence is independent per (b, h), B and C are
    shared by the heads (their gradient a partial sum over the model
    axis)."""
    x = args[0]
    if not isinstance(x, DTensor):
        return fn(*args, **kw)
    H = x.shape[-2]
    hp = head_placements(pctx, x.shape[0], H, H)[0]        # (B, T, H, P)
    hd = x.dim() - 2                                         # the head dim
    x_pl = tuple(Shard(hd) if p == Shard(2) else p for p in hp)  # dt too
    a_pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in hp)
    bc_pl = tuple(Replicate() if p == Shard(2) else p for p in hp)
    bc_grad = tuple(Partial() if p == Shard(2) else p for p in hp)
    s_pl = tuple(Shard(1) if p == Shard(2) else p for p in hp)
    a_grad = tuple(Partial() if p == Shard(0) else q
                   for p, q in zip(hp, a_pl))
    lm = local_map(partial(fn, **kw), out_placements=(x_pl, s_pl),
                   in_placements=(x_pl, x_pl, a_pl, bc_pl, bc_pl, s_pl),
                   in_grad_placements=(x_pl, x_pl, a_grad, bc_grad,
                                       bc_grad, s_pl),
                   device_mesh=pctx.mesh, redistribute_inputs=True)
    return lm(*args)


def mamba_block_full(cfg: ModelConfig, p, x, conv_state, ssm_state,
                     pctx=None):
    """x (B, T, D) -> (out, (new_conv_state, new_ssm_state)). The chunk is
    ``min(chunk_size, T)`` and must divide T: a ragged T raises
    ``ValueError`` (JAX asserts)."""
    s = cfg.ssm
    B, T, D = x.shape
    di, H, P = s.d_inner(D), s.n_heads(D), s.head_dim
    chunk = min(s.chunk_size, T)
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of the SSD chunk "
                         f"{chunk}")
    z, xc, Bc, Cc, dt, A, new_conv = _conv_and_gates(
        cfg, p, x, conv_state,
        lambda u, st, w, b: _causal_conv(u, st, w, b, s.d_conv, T))
    xh = split_heads(xc, H)
    y, new_ssm = _ssd(pctx, ssd_chunked, (xh, dt, A, Bc, Cc, ssm_state),
                      chunk=chunk)
    y = y + p["D_skip"][None, None, :, None] * xh.to(F32)
    y = _rmsnorm_gated(y.reshape(B, T, di), z, p["gn_scale"])
    return matmul(y.to(x.dtype), p["w_out"]), (new_conv, new_ssm)


def mamba_block_step(cfg: ModelConfig, p, x, conv_state, ssm_state,
                     pctx=None):
    """One-token decode. x (B, D) -> (out, (new_conv_state,
    new_ssm_state))."""
    s = cfg.ssm
    B, D = x.shape
    di, H, P = s.d_inner(D), s.n_heads(D), s.head_dim
    z, xc, Bc, Cc, dt, A, new_conv = _conv_and_gates(
        cfg, p, x, conv_state, _causal_conv_step)
    xh = split_heads(xc, H)
    y, new_ssm = _ssd(pctx, ssd_step, (xh, dt, A, Bc, Cc, ssm_state))
    y = y + p["D_skip"][None, :, None] * xh.to(F32)
    y = _rmsnorm_gated(y.reshape(B, di), z, p["gn_scale"])
    return matmul(y.to(x.dtype), p["w_out"]), (new_conv, new_ssm)
