"""Shared functional layers of the serving paths: norms, RoPE, GQA
projections, (gated) MLP, the capacity-dispatched MoE FFN (single device,
tensor-parallel and expert-parallel), the position-driven dense attention
of the JAX package, the attention kernel calls and the parallel context.

Everything is a plain function of ``(params, inputs)``; parameters are
dicts of tensors, as in ``repro.models.layers``. Where the JAX package asks
XLA for float32 outputs of a matmul (``preferred_element_type=F32``) and
casts afterwards, these functions do the same through :func:`matmul_f32`,
so bf16 results round at the same places. The large projections stay
ordinary library matmuls, as the JAX package left them to XLA.

Under a mesh (``ParallelCtx.mesh``, a ``DeviceMesh``) the same functions
take ``DTensor`` params and activations: DTensor's sharding propagation
stands in for GSPMD, ``constrain`` redistributes where the JAX package
calls ``with_sharding_constraint``, and every hand-written kernel, the
MoE bodies and the KV writes run on local shards inside ``local_map`` (the
counterpart of ``shard_map``), with explicit collectives.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig
from repro_torch.obs import spans

Params = Dict[str, Any]
F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parallel context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Mesh axis names for the distributed step builders.

    ``None`` mesh means single-device execution (the serving engine, the
    CPU tests). ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
    whose dimension names are the axis names below.
    """
    mesh: Any = None
    dp_axes: Tuple[str, ...] = ()     # batch axes, e.g. ('pod', 'data')
    tp_axis: Optional[str] = None     # tensor-parallel axis ('model')
    ep_axis: Optional[str] = None     # expert-parallel axis ('data')
    sp_axis: Optional[str] = None     # KV-sequence-parallel axis for long decode

    @property
    def dp_spec(self):
        return self.dp_axes if self.dp_axes else None


def constrain(x, pctx: Optional[ParallelCtx], *spec):
    """``x`` redistributed to the placements of ``spec`` (one entry per
    leading dimension: an axis name, a tuple of them, or None) if running
    under a mesh, else ``x`` itself."""
    if pctx is None or pctx.mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError("constrain under a mesh takes a DTensor, not "
                        f"{type(x).__name__}")
    from repro_torch.distributed.sharding import placements
    return x.redistribute(pctx.mesh, placements(pctx.mesh, spec))


def dp_for(pctx: Optional[ParallelCtx], batch: int):
    """The data axes for a batch of ``batch`` rows where it divides over
    them, else None. The JAX package names them whatever the batch (XLA
    pads an uneven split); DTensor cannot flatten an uneven split of the
    batch (B 1 over 16 ranks) with the sequence."""
    if pctx is None or pctx.mesh is None or not pctx.dp_axes:
        return None
    return pctx.dp_spec if batch % _axis_size(pctx.mesh, pctx.dp_axes) == 0 \
        else None


def replicated_like(ref, t):
    """``t`` as a DTensor replicated over ``ref``'s mesh when ``ref`` is a
    DTensor (a constant built inside a model function, such as positions
    or a mask, meeting sharded activations), else ``t``."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def _axis_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _dim(mesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def _wait(t):
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_reduce(t, mesh, axes):
    for a in axes:
        t = _wait(funcol.all_reduce(t, "sum", (mesh, _dim(mesh, a))))
    return t


class _SumForward(torch.autograd.Function):
    """Sum over ``axes`` forward, identity backward: the exit of a
    tensor-parallel region (``lax.psum`` of partial products), whose
    cotangent every rank already holds whole."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, sum over ``axes`` backward: the entry of a
    tensor-parallel region, where each rank's backward yields the part of
    the gradient that its shard of the weights contributes."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


_MM_DTYPE_REGISTERED = []


def _register_mm_dtype():
    """DTensor has no sharding strategy for ``aten.mm.dtype`` (``torch.mm``
    with ``out_dtype``); give it ``aten.mm``'s: rows, columns, the
    contraction (a partial sum) or nothing sharded."""
    if _MM_DTYPE_REGISTERED:
        return
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.mm.dtype)
    def _mm_dtype(x, w, out_dtype):
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]
    _MM_DTYPE_REGISTERED.append(True)


def _product_f32(x, w):
    if isinstance(x, DTensor) and x.dim() == 2:
        _register_mm_dtype()
    if x.is_cuda:
        mm = torch.mm if x.dim() == 2 else torch.bmm
        return mm(x, w, out_dtype=F32)
    return torch.matmul(x.to(F32), w.to(F32))


def _product(x, w):
    """Through the Function only where autograd records the product: the
    serving paths keep the plain call."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ProductF32.apply(x, w)
    return _product_f32(x, w)


class _ProductF32(torch.autograd.Function):
    """``x @ w`` (2-D, or batched 3-D) of low-precision operands with a
    float32 result and float32 accumulation. Forward on the card: one
    library product with ``out_dtype=float32``, which autograd cannot
    differentiate; on the CPU the operands are cast to float32 first.
    Backward, on both: the float32 cotangent times the other operand cast
    to float32 (library products), each gradient cast to its operand's
    dtype. That is JAX's transpose of a ``dot_general`` with
    ``preferred_element_type=F32``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if isinstance(g, DTensor) and any(p.is_partial() for p in
                                          g.placements):
            # a partial cotangent would have DTensor gather the weight and
            # multiply it whole on every rank; sum the cotangent instead
            g = g.redistribute(g.device_mesh, tuple(
                Replicate() if p.is_partial() else p for p in g.placements))
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, w.to(F32).transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.matmul(x.to(F32).transpose(-1, -2), g).to(w.dtype)
        return gx, gw


def _rows_ready(x):
    """A DTensor split only on its first and last dimensions: a split
    middle dimension is gathered first. Flattening the leading dimensions
    then keeps a plain split of the rows (a split middle dimension would
    flatten into a strided one, which DTensor's shape propagation on fake
    tensors cannot take)."""
    if isinstance(x, DTensor) and x.dim() > 2:
        last = x.dim() - 1
        mid = tuple(Replicate() if p.is_shard() and p.dim not in (0, last)
                    else p for p in x.placements)
        if mid != tuple(x.placements):
            x = x.redistribute(x.device_mesh, mid)
    return x


class _GradAsInput(torch.autograd.Function):
    """Identity whose backward gives the gradient its input's placements:
    a flattened (…, H * Dh) gradient split where H does not divide must
    not be viewed back into heads split."""

    @staticmethod
    def forward(ctx, t):
        ctx.placements = t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def matmul(x, w):
    """``x @ w`` in the operands' dtype (the products the JAX package
    leaves in the model dtype); a DTensor ``x`` is first split only on its
    first and last dimensions (``_rows_ready``)."""
    return _rows_ready(x) @ w


def matmul_f32(x, w):
    """``x @ w`` with a float32 result and float32 accumulation: the
    counterpart of ``jnp.einsum(..., preferred_element_type=F32)``.
    x: (..., K); w: (K, N)."""
    x = _rows_ready(x)
    if x.dtype == F32 and w.dtype == F32:
        return x @ w
    out = _product(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def bmm_f32(x, w):
    """Batched ``x @ w`` with a float32 result and float32 accumulation:
    the counterpart of ``jnp.einsum("ecd,edf->ecf", ...,
    preferred_element_type=F32)``. x: (E, C, K); w: (E, K, N)."""
    if x.dtype == F32 and w.dtype == F32:
        return torch.bmm(x, w)
    return _product(x, w)


def _vocab_local(mesh, axes, tokens, table):
    start = 0
    for a in axes:                     # the table's rows, split major first
        start = start * mesh.size(_dim(mesh, a)) + mesh.get_local_rank(a)
    t = tokens.long() - start * table.shape[0]
    inside = (t >= 0) & (t < table.shape[0])
    x = F.embedding(torch.where(inside, t, 0), table)
    return _SumForward.apply(x * inside[..., None].to(x.dtype), mesh, axes)


def embed_lookup(tokens, table):
    """``F.embedding(tokens, table)``. A DTensor table split on its rows
    (the vocabulary, over the model axis) is looked up on each rank's rows,
    the others' tokens zero, and summed over that axis (the vocab-parallel
    embedding): exactly one rank adds each row, and each rank's gradient
    covers its own rows."""
    if not (isinstance(table, DTensor) and Shard(0) in table.placements):
        return F.embedding(tokens.long(), table)
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    axes = tuple(n for n, p in zip(names, table.placements) if p == Shard(0))
    t_pl = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in tokens.placements)
    grad = tuple(Partial() if t == Shard(0) and w != Shard(0) else w
                 for t, w in zip(t_pl, table.placements))
    fn = local_map(partial(_vocab_local, mesh, axes),
                   out_placements=list(t_pl),
                   in_placements=(t_pl, table.placements),
                   in_grad_placements=(t_pl, grad), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(tokens, table)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with the ``(1 + scale)`` convention of the JAX package."""
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return ((1.0 + scale.to(F32)) * y).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Params, x):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Split-half rotation (not interleaved), computed in float32."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    freq = replicated_like(positions, freq)
    angles = positions[..., None].to(F32) * freq          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.split(x.to(F32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window / softcap), dense-KV formulation.
# Plain PyTorch, as the JAX package keeps it plain jnp: the dense layout's
# decode step runs it (one row per slot, each at its own position, which
# the flash kernel's single q_offset does not cover).
# ---------------------------------------------------------------------------

def attention_scores_mask(q_pos, kv_pos, *, causal: bool,
                          window: Optional[int], kv_valid=None):
    """Boolean mask (..., Sq, Skv); True = attend."""
    m = replicated_like(q_pos, torch.ones(
        q_pos.shape[-1:] + kv_pos.shape[-1:], dtype=torch.bool,
        device=q_pos.device))
    if causal:
        m = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m = m & (q_pos[..., :, None] - kv_pos[..., None, :] < window)
    if kv_valid is not None:
        m = m & kv_valid[..., None, :]
    return m


def mha(q, k, v, mask, *, softcap: Optional[float] = None,
        scale: Optional[float] = None):
    """Grouped-query attention without materializing repeated KV.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); mask: (B, Sq, Skv) or (Sq, Skv).
    """
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32),
                          k.to(F32)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if mask.dim() == 2:
        mask = mask[None]
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(F32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _block_mask(q_pos, kv_pos, kv_valid, *, causal: bool,
                window: Optional[int], is_local: Optional[bool]):
    """Mask for one q block, computed from positions. q_pos: (B, Cq);
    kv_pos: (B, Skv). ``is_local=False`` switches the window off (a global
    layer of the gemma2 alternation); None keeps it."""
    if causal:
        m = kv_pos[:, None, :] <= q_pos[..., None]
    else:
        m = replicated_like(q_pos, torch.ones(
            q_pos.shape + kv_pos.shape[-1:], dtype=torch.bool,
            device=q_pos.device))
    if window is not None and is_local is not False:
        m = m & (q_pos[..., None] - kv_pos[:, None, :] < window)
    if kv_valid is not None:
        m = m & kv_valid[:, None, :]
    return m


def attention(q, k, v, q_pos, kv_pos, *, kv_valid=None, causal: bool = True,
              window: Optional[int] = None, is_local: Optional[bool] = None,
              softcap: Optional[float] = None, q_chunk: int = 2048):
    """Position-driven GQA attention, blocked over the query dimension so
    the score/mask working set is O(q_chunk * Skv), not O(Sq * Skv).

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); q_pos: (B, Sq); kv_pos:
    (B, Skv). ``is_local``: the per-layer flag of the gemma2 alternation
    (a Python bool here; a traced 0/1 scalar in the JAX package).
    """
    if isinstance(k, DTensor):
        return _attention_sharded(q, k, v, q_pos, kv_pos, kv_valid=kv_valid,
                                  causal=causal, window=window,
                                  is_local=is_local, softcap=softcap,
                                  q_chunk=q_chunk)
    B, Sq, H, D = q.shape
    if Sq <= q_chunk or Sq % q_chunk != 0:
        mask = _block_mask(q_pos, kv_pos, kv_valid, causal=causal,
                           window=window, is_local=is_local)
        return mha(q, k, v, mask, softcap=softcap)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        mask = _block_mask(q_pos[:, c0:c0 + q_chunk], kv_pos, kv_valid,
                           causal=causal, window=window, is_local=is_local)
        outs.append(mha(q[:, c0:c0 + q_chunk], k, v, mask, softcap=softcap))
    return torch.cat(outs, dim=1)


def _attention_local(mesh, dh_axes, seq_axes, q, k, v, q_pos, kv_pos,
                     kv_valid, *, causal, window, is_local, softcap,
                     q_chunk, head_dim):
    """``attention`` on local shards. Nothing split but the batch and the
    heads: ``attention`` itself. Head dim split (``dh_axes``): the scores
    are summed over those axes. Key sequence split (``seq_axes``): the
    softmax is taken over every shard's keys (max and sum reduced over
    those axes, then the weighted values)."""
    if not dh_axes and not seq_axes:
        return attention(q, k, v, q_pos, kv_pos, kv_valid=kv_valid,
                         causal=causal, window=window, is_local=is_local,
                         softcap=softcap, q_chunk=q_chunk)
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    mask = _block_mask(q_pos, kv_pos, kv_valid, causal=causal,
                       window=window, is_local=is_local)
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32), k.to(F32))
    scores = _all_reduce(scores, mesh, dh_axes) * head_dim ** -0.5
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    top = scores.amax(dim=-1, keepdim=True)
    for a in seq_axes:
        top = _wait(funcol.all_reduce(top, "max", (mesh, _dim(mesh, a))))
    e = torch.exp(scores - top)
    total = _all_reduce(e.sum(dim=-1, keepdim=True), mesh, seq_axes)
    out = _all_reduce(torch.einsum("bhgqk,bkhd->bqhgd", e, v.to(F32)), mesh,
                      seq_axes)
    out = out / total.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _attention_sharded(q, k, v, q_pos, kv_pos, *, kv_valid, **kw):
    """``attention`` with DTensor K/V (a cache with its own placements, or
    a layer's activations) inside ``local_map``: q follows K/V's batch,
    head and head-dim split, the positions their batch and key split."""
    mesh = k.device_mesh
    names = mesh.mesh_dim_names
    kv_pl = k.placements
    q_pl = tuple(Replicate() if p == Shard(1) else p for p in kv_pl)
    qpos_pl = tuple(p if p == Shard(0) else Replicate() for p in kv_pl)
    kpos_pl = tuple(p if p in (Shard(0), Shard(1)) else Replicate()
                    for p in kv_pl)
    dh_axes = tuple(n for n, p in zip(names, kv_pl) if p == Shard(3))
    seq_axes = tuple(n for n, p in zip(names, kv_pl) if p == Shard(1))
    if kv_valid is not None:
        kv_valid = replicated_like(k, kv_valid)
    fn = local_map(partial(_attention_local, mesh, dh_axes, seq_axes,
                           head_dim=q.shape[-1], **kw),
                   out_placements=list(q_pl),
                   in_placements=(q_pl, kv_pl, kv_pl, qpos_pl, kpos_pl,
                                  None if kv_valid is None else kpos_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    o = fn(q, k, v, replicated_like(k, q_pos), replicated_like(k, kv_pos),
           kv_valid)
    if dh_axes:     # whole heads again: a split head dim does not reshape
        o = o.redistribute(mesh, tuple(Replicate() if p == Shard(3) else p
                                       for p in q_pl))
    return o


# ---------------------------------------------------------------------------
# Attention projections and the attention kernel calls
# ---------------------------------------------------------------------------

def head_placements(pctx: ParallelCtx, B: int, Hq: int, Hkv: int,
                    head_dim: int = 2):
    """Placements for a kernel that runs on local shards of model-layout
    (B, S, H, D) tensors: the batch over the data axes where it divides,
    the heads over the tensor-parallel axis. Returns (q, kv, kv grad)
    placements and whether each rank slices its one K/V head out of
    replicated K/V: where Hkv does not divide by TP but a rank's block of
    query heads falls inside one group (llama3.2-1b's 8 KV heads under TP
    16), K/V stay whole and their gradient is a partial sum over TP."""
    mesh = pctx.mesh
    dp_ok = bool(pctx.dp_axes) and B % _axis_size(mesh, pctx.dp_axes) == 0
    has_tp = pctx.tp_axis in mesh.mesh_dim_names
    tp = _axis_size(mesh, (pctx.tp_axis,)) if has_tp else 1
    hq, G = Hq // tp, Hq // Hkv
    mode = ("shard" if Hq % tp == 0 and Hkv % tp == 0 else
            "slice" if Hq % tp == 0 and G % hq == 0 else "replicate")
    q, kv, kvg = [], [], []
    for name in mesh.mesh_dim_names:
        if dp_ok and name in pctx.dp_axes:
            pl = (Shard(0),) * 3
        elif has_tp and name == pctx.tp_axis and mode != "replicate":
            sh = Shard(head_dim)
            pl = (sh, sh, sh) if mode == "shard" else (sh, Replicate(),
                                                       Partial())
        else:
            pl = (Replicate(),) * 3
        q.append(pl[0])
        kv.append(pl[1])
        kvg.append(pl[2])
    return tuple(q), tuple(kv), tuple(kvg), mode == "slice"


def _kv_slice(pctx: ParallelCtx, G: int, q, k, v, head_dim: int):
    """This rank's one K/V head (``head_placements``' slice mode)."""
    r = pctx.mesh.get_local_rank(pctx.tp_axis)
    h0 = (r * q.shape[head_dim]) // G
    return (k.narrow(head_dim, h0, 1), v.narrow(head_dim, h0, 1))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: DTensor's
    backward of a view (a reshape before a product) views the local
    gradient as it comes, and the gradient out of a local body can be a
    transposed one (the kernels take transposed views)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(*ts):
    return tuple(_ContiguousGrad.apply(t) if t.requires_grad else t
                 for t in ts)


def _flash_local(pctx, G, kv_slice, q, k, v, **kw):
    q, k, v = _contiguous_grads(q, k, v)
    if kv_slice:
        k, v = _kv_slice(pctx, G, q, k, v, 2)
    return dense_prefill_attention(q, k, v, **kw).contiguous()


def dense_prefill_attention(q, k, v, *, window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            q_offset: int = 0, causal: bool = True,
                            pctx: Optional[ParallelCtx] = None):
    """Full-sequence or chunked-prefill attention of one batch whose rows
    all start at the host-side ``q_offset`` (row ``i`` at ``q_offset +
    i``): causal, or with ``causal=False`` every row over every key (an
    encoder, or a cross-attention with Sq != Skv).

    q: (B, Sq, Hq, D) **model layout**; k/v: (B, Skv, Hkv, D), e.g. a
    dense cache slot. Returns (B, Sq, Hq, D). All three reach the flash
    kernel as transposed views: nothing is copied. DTensor inputs (under
    ``pctx``'s mesh) run the kernel on each rank's shard of the batch and
    the heads (``head_placements``), inside ``local_map``."""
    kw = dict(window=window, softcap=softcap, q_offset=q_offset,
              causal=causal)
    if isinstance(q, DTensor):
        Hq, Hkv = q.shape[2], k.shape[2]
        qp, kvp, kvg, kv_slice = head_placements(pctx, q.shape[0], Hq, Hkv)
        fn = local_map(partial(_flash_local, pctx, Hq // Hkv, kv_slice,
                               **kw),
                       out_placements=list(qp), in_placements=(qp, kvp, kvp),
                       in_grad_placements=(qp, kvg, kvg),
                       device_mesh=pctx.mesh, redistribute_inputs=True)
        return fn(q, k, v)
    from repro_torch.kernels import ops            # lazy: keeps layers cheap
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      **kw)
    return o.transpose(1, 2)


def write_kv(cache, positions, new):
    """Write ``new`` (B, C, H, D) into ``cache`` (B, Smax, H, D) at the
    rows ``positions`` (B, C), in place; returns ``cache``. A DTensor
    cache is written on each rank's shard: ``new`` and ``positions`` are
    redistributed to the cache's batch and head split, and where the
    cache's sequence is split (long-context decode), each rank writes the
    rows it holds."""
    if not isinstance(cache, DTensor):
        B, C = positions.shape
        b = torch.arange(B, device=cache.device)[:, None].expand(B, C)
        cache.index_put_((b, positions.long()), new)
        return cache
    mesh, pl = cache.device_mesh, cache.placements
    new = new.redistribute(mesh, tuple(
        Replicate() if q == Shard(1) else q for q in pl)).to_local()
    pos = positions.redistribute(mesh, tuple(
        q if q == Shard(0) else Replicate() for q in pl)).to_local().long()
    local = cache.to_local()
    B, C = pos.shape
    seq = [i for i, q in enumerate(pl) if q == Shard(1)]
    if not seq:
        b = torch.arange(B, device=local.device)[:, None].expand(B, C)
        local.index_put_((b, pos), new)
        return cache
    (i,) = seq                         # the sequence over one mesh axis
    chunk = -(-cache.shape[1] // mesh.size(i))         # torch.chunk's split
    rows = torch.arange(local.shape[1], device=local.device) + \
        mesh.get_coordinate()[i] * chunk
    for c in range(C):                 # a row outside the shard: no write
        hit = rows[None, :] == pos[:, c:c + 1]                 # (B, S_l)
        local.copy_(torch.where(hit[..., None, None], new[:, c:c + 1],
                                local))
    return cache


def _pool_placements(pctx: ParallelCtx, Hq: int, Hkv: int):
    """(query, pool) placements for the paged kernels under a mesh: the
    lanes whole on every rank (the pool is one, shared by every lane), the
    heads over the tensor-parallel axis where both head counts divide by
    it, else whole. q (B, [Sq,] Hq, D) splits dim ``-2``; the pools
    (P, page, Hkv, D) and the new K/V (B, Hkv, D) split their heads."""
    tp = pctx.tp_axis
    n = _axis_size(pctx.mesh, (tp,)) if tp in pctx.mesh.mesh_dim_names else 1
    split = n > 1 and Hq % n == 0 and Hkv % n == 0
    return (tuple(Shard(-2) if split and n == tp else Replicate()
                  for n in pctx.mesh.mesh_dim_names),
            tuple(Shard(2) if split and n == tp else Replicate()
                  for n in pctx.mesh.mesh_dim_names))


def _replicated(mesh):
    return (Replicate(),) * mesh.ndim


def _paged_decode_local(q, k_pages, v_pages, block_table, lengths, k_new,
                        v_new, write_pages, write_offsets):
    from repro_torch.kernels import ops
    return ops.decode_attention(q, k_pages, v_pages, block_table, lengths,
                                k_new=k_new, v_new=v_new,
                                write_pages=write_pages,
                                write_offsets=write_offsets)[0]


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           k_new=None, v_new=None, write_pages=None,
                           write_offsets=None,
                           pctx: Optional[ParallelCtx] = None):
    """Single-token decode attention over a paged KV pool.

    q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); block_table: (B, max_pages)
    int32 device page ids in token order; lengths: (B,) valid kv tokens.
    Runs the Hopper ``paged_attention`` kernels on a CUDA tensor and their
    plain versions on a CPU tensor. No sliding window or softcap: the paged
    layout is gated on configs without them.

    With ``k_new/v_new (B, Hkv, D)`` + ``write_pages/write_offsets (B,)``
    the new token's KV write is fused into the call (slot contract:
    position ``lengths - 1``), the pools are updated in place, and the
    result is ``(o, k_pages, v_pages)``. DTensor inputs (the fused form)
    run the kernel on each rank's heads (``_pool_placements``) inside
    ``local_map``.
    """
    from repro_torch.kernels import ops            # lazy: keeps layers cheap
    if isinstance(q, DTensor):
        mesh = pctx.mesh
        q_pl, pool_pl = _pool_placements(pctx, q.shape[1], k_pages.shape[2])
        kv_pl = tuple(Shard(1) if isinstance(p, Shard) else p
                      for p in pool_pl)
        rep = _replicated(mesh)
        fn = local_map(_paged_decode_local, out_placements=list(q_pl),
                       in_placements=(q_pl, pool_pl, pool_pl, rep, rep,
                                      kv_pl, kv_pl, rep, rep),
                       device_mesh=mesh, redistribute_inputs=True)
        o = fn(q, k_pages, v_pages, *(replicated_like(q, t) for t in (
            block_table, lengths)), k_new, v_new,
               *(replicated_like(q, t) for t in (write_pages,
                                                 write_offsets)))
        return o, k_pages, v_pages
    return ops.decode_attention(q, k_pages, v_pages, block_table, lengths,
                                k_new=k_new, v_new=v_new,
                                write_pages=write_pages,
                                write_offsets=write_offsets)


def paged_write(pool, pages, offsets, new):
    """``pool[pages, offsets] = new`` in place: pool (P, page, H, D), new
    (C, H, D), pages/offsets (C,). A DTensor pool is written on each
    rank's heads."""
    if isinstance(pool, DTensor):
        mesh = pool.device_mesh
        new = new.redistribute(mesh, tuple(
            Shard(1) if isinstance(p, Shard) else p
            for p in pool.placements)).to_local()
        rep = _replicated(mesh)
        pages = replicated_like(pool, pages).redistribute(mesh, rep)
        offsets = replicated_like(pool, offsets).redistribute(mesh, rep)
        pages, offsets = pages.to_local(), offsets.to_local()
        pool.to_local().index_put_((pages.long(), offsets.long()), new)
        return pool
    pool.index_put_((pages.long(), offsets.long()), new)
    return pool


def paged_prefill_attention(q, k_pages, v_pages, block_table, kv_len,
                            q_offset, pctx: Optional[ParallelCtx] = None):
    """Gather-free chunked-prefill attention over a paged KV pool.

    q: (B, Sq, Hq, D) **model layout**; k/v_pages: (P, page, Hkv, D);
    block_table: (B, Np) int32 pool pages in token order (scratch-padded);
    kv_len: (B,) valid kv tokens (the chunk's own KV already scattered in);
    q_offset: (B,) absolute position of each row's first query. Returns
    (B, Sq, Hq, D). The kernel reads pages in place through the table;
    DTensor inputs run it on each rank's heads inside ``local_map``.
    """
    if isinstance(q, DTensor):
        mesh = pctx.mesh
        q_pl, pool_pl = _pool_placements(pctx, q.shape[2], k_pages.shape[2])
        rep = _replicated(mesh)
        fn = local_map(paged_prefill_attention, out_placements=list(q_pl),
                       in_placements=(q_pl, pool_pl, pool_pl, rep, rep, rep),
                       device_mesh=mesh, redistribute_inputs=True)
        return fn(q, k_pages, v_pages, *(replicated_like(q, t) for t in (
            block_table, kv_len, q_offset)))
    from repro_torch.kernels import ops            # lazy: keeps layers cheap
    o = ops.prefill_attention(q.transpose(1, 2).contiguous(), k_pages,
                              v_pages, block_table, kv_len, q_offset)
    return o.transpose(1, 2)


def split_heads(t, H: int):
    """(..., H * Dh) -> (..., H, Dh). A DTensor whose last dimension is
    split over more ranks than H divides by is gathered on it first (its
    shards would straddle heads): llama3.2-1b's 8 K/V heads under TP 16."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.dim() - 1
        n = 1
        for i, p in enumerate(t.placements):
            if p.is_shard(last):
                n *= mesh.size(i)
        if H % n:
            t = t.redistribute(mesh, tuple(
                Replicate() if p.is_shard(last) else p
                for p in t.placements))
    return t.reshape(*t.shape[:-1], H, t.shape[-1] // H)


def attn_qkv(cfg: ModelConfig, p: Params, x, positions, *, use_rope=True):
    B, S, D = x.shape
    q = matmul_f32(x, p["wq"])
    k = matmul_f32(x, p["wk"])
    v = matmul_f32(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(F32)
        k = k + p["bk"].to(F32)
        v = v + p["bv"].to(F32)
    q = split_heads(q, cfg.n_heads).to(x.dtype)
    k = split_heads(k, cfg.n_kv_heads).to(x.dtype)
    v = split_heads(v, cfg.n_kv_heads).to(x.dtype)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p: Params, o):
    B, S, H, Dh = o.shape
    o = o.reshape(B, S, H * Dh)
    if isinstance(o, DTensor) and o.requires_grad:
        o = _GradAsInput.apply(o)
    return matmul_f32(o, p["wo"]).to(o.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(name: str):
    gelu = (lambda x: F.gelu(x, approximate="tanh"))
    return {"silu": F.silu, "gelu": gelu, "gelu_tanh": gelu,
            "relu": F.relu}[name]


def mlp(cfg: ModelConfig, p: Params, x,
        pctx: Optional[ParallelCtx] = None):
    act = _act(cfg.act)
    up = matmul_f32(x, p["w_up"])
    if cfg.gated_mlp:
        gate = matmul_f32(x, p["w_gate"])
        h = act(gate) * up
    else:
        h = act(up)
    h = h.to(x.dtype)
    if pctx is not None:
        h = constrain(h, pctx, dp_for(pctx, h.shape[0]), None, pctx.tp_axis)
    return matmul_f32(h, p["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE: capacity-based dispatch (GShard-style, scatter formulation), as in
# the JAX package. Every function is free of host syncs and of shapes that
# depend on the data: the capacity comes from shapes alone, overflowing
# entries go to a dump row instead of being filtered out.
# ---------------------------------------------------------------------------

def _route(moe, logits):
    """logits (T, E) -> (topk_idx (T, K) int64, topk_w (T, K) normalised).
    ``torch.topk`` sorted descending, as ``lax.top_k``."""
    probs = torch.softmax(logits.to(F32), dim=-1)
    w, idx = torch.topk(probs, moe.top_k, dim=-1, largest=True, sorted=True)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
    return idx, w


def _dispatch(x, idx, w, num_experts: int, capacity: int,
              offsets=None):
    """Scatter tokens into per-expert capacity buffers.

    x: (T, D); idx/w: (T, K). Returns buf (E, C, D) and the gather metadata
    (flat_e, pos_c, keep), each (T*K,). An entry's slot is its rank among
    the entries routed to its expert in token-major, k-minor order (the
    order of JAX's scan, which decides who overflows); entries ranked past
    ``capacity`` land in the dump row ``capacity`` and are dropped. The
    one-hot is held expert-major, (E, T*K), so that the rank scan runs
    along its contiguous rows: a scan down the columns of (T*K, E) is a
    slow kernel on the card. ``offsets``: counts (E,) -> (E,), the
    entries of earlier token blocks per expert, added to the ranks (a
    block of the tokens under a mesh, ranked as in the whole).
    """
    T, D = x.shape
    K = idx.shape[1]
    flat_e = idx.reshape(-1)                                   # (T*K,)
    onehot = torch.zeros((num_experts, T * K), dtype=torch.int32,
                         device=x.device).scatter_(0, flat_e[None], 1)
    ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = ranks.gather(0, flat_e[None])[0].long() - 1          # (T*K,)
    if offsets is not None:
        pos = pos + offsets(ranks[:, -1])[flat_e]
    keep = pos < capacity
    pos_c = torch.where(keep, pos, capacity)       # overflow -> dump row
    buf = torch.zeros((num_experts, capacity + 1, D), dtype=x.dtype,
                      device=x.device)
    src = x.repeat_interleave(K, dim=0)                        # (T*K, D)
    buf.index_put_((flat_e, pos_c), src, accumulate=True)
    return buf[:, :capacity], (flat_e, pos_c, keep)


def _combine(expert_out, meta, w, T: int):
    """expert_out (E, C, D) -> (T, D): each token's kept entries, weighted
    by their route weights and summed over its K choices."""
    flat_e, pos_c, keep = meta
    K = w.shape[1]
    E, C, D = expert_out.shape
    padded = torch.cat([expert_out, expert_out.new_zeros((E, 1, D))], dim=1)
    gathered = padded[flat_e, pos_c]                           # (T*K, D)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    gathered = gathered.reshape(T, K, D) * w[..., None].to(expert_out.dtype)
    return torch.sum(gathered, dim=1)


def _expert_ffn(cfg: ModelConfig, p: Params, buf):
    """buf (E, C, D) -> (E, C, D) through each expert's gated MLP."""
    act = _act(cfg.act)
    g = bmm_f32(buf, p["w_gate"])
    u = bmm_f32(buf, p["w_up"])
    h = (act(g) * u).to(buf.dtype)
    return bmm_f32(h, p["w_down"]).to(buf.dtype)


def _capacity(m, tokens: int) -> int:
    return max(8, int(tokens * m.top_k / m.num_experts * m.capacity_factor))


def moe_ffn(cfg: ModelConfig, p: Params, x,
            pctx: Optional[ParallelCtx] = None, token_shard: bool = False):
    """Single-device / TP-sharded MoE FFN. x: (B, S, D), every row of it
    routed, padded lanes included (they count towards the capacity, as in
    JAX).

    Under ``pctx``'s mesh (DTensor inputs) the dispatch keeps the
    single-device semantics, one capacity over all B * S tokens: see
    ``_moe_ffn_sharded``. ``token_shard``: with replicated expert weights
    (the moe_replicated perf toggle), shard the flattened token dim over
    BOTH the data and model axes so the model-axis replicas split the
    expert work instead of duplicating it."""
    if isinstance(x, DTensor):
        return _moe_ffn_sharded(cfg, p, x, pctx, token_shard)
    m = cfg.moe
    B, S, D = x.shape
    with spans.span("moe.route"):
        xt = x.reshape(B * S, D)
        logits = matmul_f32(xt, p["router"])
        idx, w = _route(m, logits)
        capacity = _capacity(m, B * S)
    with spans.span("moe.dispatch"):
        buf, meta = _dispatch(xt, idx, w, m.num_experts, capacity)
    with spans.span("moe.experts"):
        out = _expert_ffn(cfg, p, buf)
    with spans.span("moe.combine"):
        return _combine(out, meta, w, B * S).reshape(B, S, D)


_MOE_WEIGHTS = ("router", "w_gate", "w_up", "w_down")


def _block_offsets(counts, mesh, axes):
    """Per-expert entries routed by the token blocks before this rank's:
    ``axes`` split the token order major to minor, so the blocks of the
    lower coordinates come first. counts: (E,) -> (E,)."""
    every, index = counts[None], 0
    for a in reversed(axes):
        every = _wait(funcol.all_gather_tensor(
            every[None], 0, (mesh, _dim(mesh, a))))
    for a in axes:
        index = index * mesh.size(_dim(mesh, a)) + mesh.get_local_rank(a)
    every = every.reshape(-1, counts.shape[0])
    return every[:index].sum(dim=0)


def _scatter_sum(t, mesh, axes, dim: int):
    """Sum over ``axes``, each rank keeping its slice of ``dim`` (major
    axis first); the gradient is gathered (``_gather``'s inverse)."""
    for a in axes:
        t = _wait(funcol.reduce_scatter_tensor_autograd(
            t.contiguous(), "sum", dim, (mesh, _dim(mesh, a))))
    return t


def _gather(t, mesh, axes, dim: int):
    """The slices of ``dim`` over ``axes`` put back together (minor axis
    first); the gradient is summed and sliced (``_scatter_sum``)."""
    for a in reversed(axes):
        t = _wait(funcol.all_gather_tensor_autograd(
            t.contiguous(), dim, (mesh, _dim(mesh, a))))
    return t


def _moe_local(cfg, mesh, tok_axes, tp_axis, capacity, router, w_gate, w_up,
               w_down, xt):
    """The body of ``_moe_ffn_sharded`` on local shards. Each rank ranks
    its own block of tokens, offset by the earlier blocks' counts, so that
    every entry gets the capacity slot that the single-device dispatch
    gives it. The buffers are summed over the token axes, each rank
    keeping a slice of the capacity (padded to divide), on which it runs
    the experts (F split over ``tp_axis``); the slices are gathered back
    and each rank combines its own tokens."""
    p = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    m = cfg.moe
    T = xt.shape[0]
    idx, w = _route(m, matmul_f32(xt, router))
    offsets = partial(_block_offsets, mesh=mesh, axes=tok_axes) \
        if tok_axes else None
    buf, meta = _dispatch(xt, idx, w, m.num_experts, capacity, offsets)
    n = _axis_size(mesh, tok_axes)
    pad = -capacity % n
    if pad:
        buf = F.pad(buf, (0, 0, 0, pad))
    buf = _scatter_sum(buf, mesh, tok_axes, 1)
    if tp_axis:
        buf = _SumBackward.apply(buf, mesh, (tp_axis,))
    out = _expert_ffn(cfg, p, buf)
    if tp_axis:
        out = _SumForward.apply(out, mesh, (tp_axis,))
    out = _gather(out, mesh, tok_axes, 1)[:, :capacity]
    return _combine(out, meta, w, T)


def _weight_placements(mesh, specs, partial_over):
    """(placements, grad placements) of the four MoE weights: the grad is
    a partial sum over the axes in ``partial_over`` that do not shard the
    weight (each rank's gradient covers its own tokens only)."""
    from repro_torch.distributed.sharding import placements
    pls, grads = [], []
    for name in _MOE_WEIGHTS:
        pl = placements(mesh, specs[name])
        pls.append(pl)
        grads.append(tuple(Partial() if n in partial_over and
                           isinstance(q, Replicate) else q
                           for n, q in zip(mesh.mesh_dim_names, pl)))
    return pls, grads


def _moe_ffn_sharded(cfg, p, x, pctx: ParallelCtx, token_shard: bool):
    """``moe_ffn`` on DTensors: the expert weights (E, D, F) split over
    the model axis on F (or whole, with the moe_replicated toggle), the
    tokens over the data axes (and the model axis with ``token_shard``).
    One capacity over all B * S tokens, as the JAX package's global
    dispatch under GSPMD has."""
    mesh = pctx.mesh
    m = cfg.moe
    B, S, D = x.shape
    tp = pctx.tp_axis if pctx.tp_axis in mesh.mesh_dim_names else None
    tok_axes = tuple(pctx.dp_axes) + ((tp,) if token_shard and tp else ())
    if (B * S) % _axis_size(mesh, tok_axes):
        tok_axes = ()
    w_tp = None if token_shard else tp
    specs = {"router": (), "w_gate": (None, None, w_tp),
             "w_up": (None, None, w_tp), "w_down": (None, w_tp, None)}
    from repro_torch.distributed.sharding import placements
    x_pl = placements(mesh, (tok_axes or None, None))
    w_pl, w_grad = _weight_placements(mesh, specs, tok_axes)
    fn = local_map(partial(_moe_local, cfg, mesh, tok_axes, w_tp,
                           _capacity(m, B * S)),
                   out_placements=list(x_pl), in_placements=(*w_pl, x_pl),
                   in_grad_placements=(*w_grad, x_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    out = fn(*(p[n] for n in _MOE_WEIGHTS), x.reshape(B * S, D))
    out = out.reshape(B, S, D)
    if token_shard:
        out = constrain(out, pctx, tuple(pctx.dp_axes) or None, None, None)
    return out


def moe_ffn_ep_local(cfg: ModelConfig, p: Params, x, *, mesh, ep_axis: str,
                     tp_axis: Optional[str]):
    """Per-shard body for expert-parallel MoE (runs under ``local_map``).

    x: (B_local, S, D) local tokens; p['w_*'] are the local expert shards
    (E_local, D, F_local); p['router'] replicated. The ``ep_axis``
    all-to-all routes capacity buffers so each shard computes only its own
    experts; tp_axis (if set) shards F with a sum on the way out. The
    capacity is the local tokens', as in the JAX package: with drops the
    result differs from ``moe_ffn``'s. The all-to-alls carry their
    gradients (``all_to_all_single_autograd``); the F-split products
    enter through ``_SumBackward`` and leave through ``_SumForward``.
    """
    m = cfg.moe
    B, S, D = x.shape
    E = m.num_experts
    n = mesh.size(_dim(mesh, ep_axis))
    xt = x.reshape(B * S, D)
    idx, w = _route(m, matmul_f32(xt, p["router"]))
    capacity = _capacity(m, B * S)
    buf, meta = _dispatch(xt, idx, w, E, capacity)             # (E, C, D)
    # exchange: split E over shards, concat received buffers along C
    group = (mesh, _dim(mesh, ep_axis))
    buf = funcol.all_to_all_single_autograd(buf.contiguous(), None, None,
                                            group)
    buf = _wait(buf).reshape(n, E // n, capacity, D).transpose(0, 1) \
        .reshape(E // n, n * capacity, D)
    if tp_axis is not None:
        buf = _SumBackward.apply(buf, mesh, (tp_axis,))
    out = _expert_ffn(cfg, p, buf)                         # (E/n, n*C, D)
    if tp_axis is not None:
        out = _SumForward.apply(out, mesh, (tp_axis,))
    out = out.reshape(E // n, n, capacity, D).transpose(0, 1) \
        .reshape(E, capacity, D)
    out = _wait(funcol.all_to_all_single_autograd(out.contiguous(), None,
                                                  None, group))
    return _combine(out, meta, w, B * S).reshape(B, S, D)


def _ep_local(cfg, mesh, ep_axis, tp_axis, router, w_gate, w_up, w_down, x):
    p = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    return moe_ffn_ep_local(cfg, p, x, mesh=mesh, ep_axis=ep_axis,
                            tp_axis=tp_axis)


def moe_ffn_ep(cfg: ModelConfig, p: Params, x, pctx: ParallelCtx):
    """Expert-parallel MoE on DTensors: ``moe_ffn_ep_local`` on each
    rank's shard inside ``local_map`` (the JAX package's ``shard_map``),
    with its in-specs: the router whole, the experts over ``ep_axis`` and
    F over ``tp_axis``, the tokens over the data axes."""
    mesh = pctx.mesh
    ep, tp = pctx.ep_axis, pctx.tp_axis
    tp = tp if tp in mesh.mesh_dim_names else None
    specs = {"router": (), "w_gate": (ep, None, tp), "w_up": (ep, None, tp),
             "w_down": (ep, tp, None)}
    from repro_torch.distributed.sharding import placements
    dp = dp_for(pctx, x.shape[0])
    x_pl = placements(mesh, (dp, None, None))
    w_pl, w_grad = _weight_placements(mesh, specs, dp or ())
    fn = local_map(partial(_ep_local, cfg, mesh, ep, tp),
                   out_placements=list(x_pl),
                   in_placements=(*w_pl, x_pl),
                   in_grad_placements=(*w_grad, x_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*(p[n] for n in _MOE_WEIGHTS), x)
