"""The plain PyTorch reference of the served models, in float32 with TF32
off: the pieces every architecture shares, and ``forward_logits``, which
hands a configuration to its architecture's ``arch/<name>.py``.

It imports torch and the benchmark's own modules: nothing of the program
under test. It takes the weights that the benchmark made (``weights.py``)
and the token streams the served run fed, and works out again, from those
alone, every hidden state, key and value the served path derived. Layer
by layer over a whole stream, each layer's weights cast to float32 on
their own, attention in blocks of query rows: so it fits beside the
weights on the card.

The MoE capacity semantics are the program's and shared by every MoE
architecture (``_moe_keep``): GShard dispatch, ``capacity = max(8, int(C *
k / E * capacity_factor))`` for a call of C rows, entries ranked
token-major and k-minor, the overflow dropped.

``precision="fp8"`` is the control: the reference computed one step
below the configuration's bf16, every tensor the program holds in bf16
held in float8 e4m3 instead: the weights (scaled per output column), the
inputs of every matrix product, the residual stream after the embedding
and after each sublayer, each sublayer's output, and q, k and v (scaled
per row). Products accumulate, and norms, RoPE, softmax and the router
run, in float32, as the program runs them.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mars_bench import arch

F32 = torch.float32
ROW_BLOCK = 1024           # query rows of one attention block
FFN_BLOCK = 4096           # rows of one dense-MLP block
FP8_MAX = 448.0            # largest finite float8 e4m3fn


@contextmanager
def exact_f32():
    """float32 products without TF32 (the card's default may round them)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3, scaled along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(F32) / scale


class _Mm:
    """The reference's matrix product: float32, or the fp8 control."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight (..., K, N) in float32 (fp8: rounded per column)."""
        t = t.to(F32)
        return _fp8(t, -2) if self.fp8 else t

    def hold(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor the program holds in its stated precision."""
        return _fp8(t, -1) if self.fp8 else t

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.hold(x) @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    var = x.pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x (T, H, D), pos (T,): split-half rotation."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None] * freq                    # (T, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v):
    """q (T, Hq, D), k/v (T, Hkv, D) -> (T, Hq, D); row t attends 0..t."""
    T, Hq, D = q.shape
    G = Hq // k.shape[1]
    kh = k.repeat_interleave(G, dim=1).transpose(0, 1)   # (Hq, T, D)
    vh = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    cols = torch.arange(T, device=q.device)
    for r0 in range(0, T, ROW_BLOCK):
        r1 = min(T, r0 + ROW_BLOCK)
        qb = q[r0:r1].transpose(0, 1)                    # (Hq, R, D)
        s = (qb @ kh[:, :r1].transpose(1, 2)) * D ** -0.5
        mask = cols[None, :r1] > torch.arange(r0, r1, device=q.device)[:, None]
        s.masked_fill_(mask, float("-inf"))
        out[r0:r1] = (torch.softmax(s, dim=-1) @ vh[:, :r1]).transpose(0, 1)
    return out


def _moe_keep(idx: torch.Tensor, groups: Sequence[Tuple[int, int, int]],
              experts: int, top_k: int, capacity_factor: float):
    """(T, k) bool: which routed entries the capacity dispatch keeps.
    ``groups``: (start, n, C) runs of positions routed in one call of C
    rows; every other position is alone (all its k entries kept)."""
    keep = torch.ones_like(idx, dtype=torch.bool)
    for start, n, C in groups:
        # a stream cut after its last served position cuts its last call:
        # an entry's rank depends only on the rows before it
        n = min(n, idx.shape[0] - start)
        if n <= 0:
            continue
        cap = max(8, int(C * top_k / experts * capacity_factor))
        flat = idx[start:start + n].reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, experts)
        rank = (onehot.cumsum(0) * onehot).sum(-1) - 1   # token-major
        keep[start:start + n] = (rank < cap).reshape(n, -1)
    return keep


def _mlp(lp, h, mm: _Mm):
    """A SiLU-gated MLP (``w_gate``, ``w_up``, ``w_down``) over the rows
    of ``h``, in blocks of FFN_BLOCK rows."""
    wg, wu, wd = (mm.w(lp["w_gate"]), mm.w(lp["w_up"]), mm.w(lp["w_down"]))
    out = torch.empty_like(h)
    for r0 in range(0, h.shape[0], FFN_BLOCK):
        x = h[r0:r0 + FFN_BLOCK]
        out[r0:r0 + FFN_BLOCK] = mm(
            torch.nn.functional.silu(mm(x, wg)) * mm(x, wu), wd)
    return out


def _layer(params, l: int) -> Dict:
    """Layer ``l``'s weights out of the stacked ``params["layers"]``."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[l]
    return pick(params["layers"])


def forward_logits(cfg: Dict, params: Dict, tokens: Sequence[int],
                   rows: Sequence[int], *, moe_groups=(),
                   precision: str = "f32",
                   tally: Optional[Dict] = None) -> torch.Tensor:
    """Logits (len(rows), V) in float32 at positions ``rows`` of the
    stream ``tokens`` (positions 0..T-1), computed over the whole stream.
    ``cfg``: the configuration's numbers (``configs/<name>.json``);
    ``params``: the served weights, any dtype and device. ``tally``, when
    given, counts the routed entries (``moe_entries``, over every MoE
    layer) and those the capacity dispatch drops (``moe_dropped``)."""
    return arch.module(cfg).forward_logits(
        cfg, params, tokens, rows, moe_groups=moe_groups,
        precision=precision, tally=tally)


def gaps_sd(ref: torch.Tensor, tokens: Sequence[int]) -> List[float]:
    """How far below each row's best the given token's logit lies, in
    standard deviations of that row's logits."""
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=ref.device)
    top = ref.max(dim=-1).values
    got = ref.gather(1, t[:, None])[:, 0]
    return ((top - got) / ref.std(dim=-1)).tolist()


def control_gaps_sd(ref: torch.Tensor, ctrl: torch.Tensor) -> List[float]:
    """The gap, on the reference, of the token the control puts first."""
    return gaps_sd(ref, ctrl.argmax(dim=-1).tolist())


def stream_groups(ops: Sequence[Tuple]) -> List[Tuple[int, int, int]]:
    """The MoE call groups of one served stream: each prefill pack
    (start, n, C) as it was served."""
    return [(op[1], op[2], op[3]) for op in ops if op[0] == "pack"]

