"""Plain PyTorch reference of the served decoder LMs (dense GQA and
top-k MoE), in float32 with TF32 off.

It imports torch alone: nothing of the program under test. It takes the
weights that the benchmark made (``weights.py``) and the token streams the
served run fed, and works out again, from those alone, every hidden state,
key and value the served path derived. Layer by layer over a whole stream,
each layer's weights cast to float32 on their own, attention in blocks of
query rows: so it fits beside the weights on the card.

The model follows the configuration's published equations as the program
serves them: RMSNorm with the ``(1 + scale)`` convention, split-half RoPE,
causal GQA (query head ``h`` reads key/value head ``h // G``), a SiLU-gated
MLP, and for MoE a softmax router whose top-k weights are renormalised.
The MoE layer keeps the program's capacity semantics (GShard dispatch,
``capacity = max(8, int(C * k / E * capacity_factor))`` for a call of C
rows, entries ranked token-major and k-minor, the overflow dropped). A
call's drops depend on the tokens in that call, so ``moe_groups`` tells
the reference which positions the served path routed together and at
what padded width; a position alone in its group keeps all k experts.

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
              num_experts: int, top_k: int, capacity_factor: float):
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
        cap = max(8, int(C * top_k / num_experts * capacity_factor))
        flat = idx[start:start + n].reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, num_experts)
        rank = (onehot.cumsum(0) * onehot).sum(-1) - 1   # token-major
        keep[start:start + n] = (rank < cap).reshape(n, -1)
    return keep


def _moe(cfg, lp, h, mm: _Mm, groups, tally: Optional[Dict]):
    E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(h, mm.w(lp["router"])), dim=-1)
    w, idx = torch.topk(probs, K, dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    keep = _moe_keep(idx, groups, E, K, cfg["capacity_factor"])
    if tally is not None:
        tally["moe_entries"] = tally.get("moe_entries", 0) + keep.numel()
        tally["moe_dropped"] = (tally.get("moe_dropped", 0)
                                + int((~keep).sum()))
    w = torch.where(keep, w, torch.zeros_like(w))
    out = torch.zeros_like(h)
    for e in range(E):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        g = mm(x, mm.w(lp["w_gate"][e]))
        u = mm(x, mm.w(lp["w_up"][e]))
        y = mm.hold(mm(torch.nn.functional.silu(g) * u,
                       mm.w(lp["w_down"][e])))
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def _mlp(lp, h, mm: _Mm):
    wg, wu, wd = (mm.w(lp["w_gate"]), mm.w(lp["w_up"]), mm.w(lp["w_down"]))
    out = torch.empty_like(h)
    for r0 in range(0, h.shape[0], FFN_BLOCK):
        x = h[r0:r0 + FFN_BLOCK]
        out[r0:r0 + FFN_BLOCK] = mm(
            torch.nn.functional.silu(mm(x, wg)) * mm(x, wu), wd)
    return out


def _layer(params, l: int) -> Dict:
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
    dev = params["embed"].device
    mm = _Mm(precision)
    D, Hq, Hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                  cfg["num_key_value_heads"])
    Dh = cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    pos = torch.arange(tok.numel(), device=dev)
    with exact_f32(), torch.no_grad():
        x = mm.hold(params["embed"][tok].to(F32))
        for l in range(cfg["num_hidden_layers"]):
            lp = _layer(params, l)
            a = lp["attn"]
            h = rms_norm(x, lp["ln_attn"]["scale"], eps)
            q, k, v = (mm(h, mm.w(a[n])) for n in ("wq", "wk", "wv"))
            if cfg.get("attention_bias"):
                q, k, v = (q + a["bq"].to(F32), k + a["bk"].to(F32),
                           v + a["bv"].to(F32))
            q = rope(q.view(-1, Hq, Dh), pos, theta)
            k = rope(k.view(-1, Hkv, Dh), pos, theta)
            q, k, v = mm.hold(q), mm.hold(k), mm.hold(v.view(-1, Hkv, Dh))
            o = causal_attention(q, k, v)
            x = mm.hold(x + mm.hold(mm(o.reshape(-1, Hq * Dh),
                                       mm.w(a["wo"]))))
            h = rms_norm(x, lp["ln_mlp"]["scale"], eps)
            f = (_moe(cfg, lp["moe"], h, mm, moe_groups, tally) if "moe" in lp
                 else _mlp(lp["mlp"], h, mm))
            x = mm.hold(x + mm.hold(f))
        idx = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
        hf = rms_norm(x[idx], params["ln_final"]["scale"], eps)
        head = (params["embed"].T if cfg.get("tie_word_embeddings")
                else params["lm_head"])
        return mm(hf, mm.w(head))


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

