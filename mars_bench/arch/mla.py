"""Decoders with multi-head latent attention (MLA) and sigmoid-routed
experts with shared experts: DeepSeek-V3's block (``model_type``
``deepseek_v3``) without ``q_lora_rank``, as kanana-2-30b-a3b publishes it
and the program's paged path serves it (``repro_torch.models.mla``).

The reference follows the published equations in the non-absorbed form,
in float32 under ``reference.exact_f32``. Per layer and token ``h``:
``q = h W_q`` split into ``q_nope`` (``qk_nope_head_dim``) and ``q_pe``
(``qk_rope_head_dim``) per head; ``[c | k_pe] = h W_kv_a``; ``c`` through
RMSNorm (``(1 + scale)``, ``rms_norm_eps``); ``[k_nope | v] = c W_kv_b``
per head; interleaved RoPE (pairs ``(2i, 2i + 1)`` at
``rope_theta^(-2i / qk_rope_head_dim)``) on ``q_pe`` and on the one
``k_pe`` every head shares; causal attention at scale ``qk_head_dim^-1/2``
over ``[k_nope | k_pe]`` with values ``v``, in blocks of query rows; ``o
W_o``. The first ``first_k_dense_replace`` layers have a SiLU-gated MLP of
``intermediate_size``; the others route each token to
``num_experts_per_tok`` of ``n_routed_experts`` experts by sigmoid score
plus ``e_score_correction_bias``, weight them by the score alone,
renormalised (``norm_topk_prob``) and scaled by ``routed_scaling_factor``,
and add one shared SiLU-gated MLP of ``n_shared_experts *
moe_intermediate_size``, which nothing drops. With ``n_group`` and
``topk_group`` 1 the published group selection keeps every expert. The
routed experts keep the program's capacity semantics
(``reference._moe_keep``), as ``arch/gqa.py``'s do.

The roofline counts read the published attention, whatever implements it:
``2 H (qk_head_dim + v_head_dim)`` operations a query-key pair and layer,
and ``kv_lora_rank + qk_rope_head_dim`` bf16 values of cache a token and
layer.
"""
from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from mars_bench.reference import (F32, _layer, _mlp, _Mm, _moe_keep,
                                  exact_f32, rms_norm)
from mars_bench.roofline import BF16

ROW_BLOCK = 256            # query rows of one attention block


def _published(cfg: Dict) -> None:
    """Raise where the configuration asks for what this file does not
    compute."""
    want = {"q_lora_rank": None, "rope_scaling": None, "n_group": 1,
            "topk_group": 1, "scoring_func": "sigmoid",
            "topk_method": "noaux_tc", "rope_interleave": True,
            "moe_layer_freq": 1, "hidden_act": "silu"}
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f"arch mla computes {want}; the configuration "
                         f"has {bad}")


def program_config(cfg: Dict):
    """The program's ``MLAModelConfig`` for a configuration file."""
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.mla import MLAConfig, MLAModelConfig
    _published(cfg)
    return MLAModelConfig(
        name=cfg["name"], family="moe",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["qk_head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]),
        qkv_bias=bool(cfg.get("attention_bias")),
        tie_embeddings=bool(cfg.get("tie_word_embeddings")),
        norm_eps=float(cfg["rms_norm_eps"]),
        moe=MoEConfig(num_experts=cfg["n_routed_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff_expert=cfg["moe_intermediate_size"],
                      capacity_factor=cfg["capacity_factor"],
                      shard_mode="tp"),
        mla=MLAConfig(
            kv_lora_rank=cfg["kv_lora_rank"],
            qk_nope_head_dim=cfg["qk_nope_head_dim"],
            qk_rope_head_dim=cfg["qk_rope_head_dim"],
            v_head_dim=cfg["v_head_dim"],
            first_k_dense_replace=cfg["first_k_dense_replace"],
            n_shared_experts=cfg["n_shared_experts"],
            routed_scaling_factor=float(cfg["routed_scaling_factor"]),
            norm_topk_prob=bool(cfg["norm_topk_prob"])))


def toy(cfg: Dict) -> Dict:
    """A copy at the CPU tests' widths: the dense layer and two MoE
    layers, 8 experts (top 2) and one shared expert."""
    cfg = copy.deepcopy(cfg)
    cfg.update(num_hidden_layers=3, first_k_dense_replace=1, hidden_size=64,
               num_attention_heads=4, num_key_value_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
               qk_head_dim=32, v_head_dim=16, head_dim=16,
               intermediate_size=96, moe_intermediate_size=32,
               n_routed_experts=8, num_experts_per_tok=2,
               n_shared_experts=1, vocab_size=256)
    return cfg


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def make_params(cfg: Dict, seed: int, *, dtype=torch.bfloat16,
                device="cuda") -> Dict:
    """The weights of ``cfg`` in the program's layout: attention and norms
    stacked over every layer under ``"layers"`` (``wq``, ``wkv_a``,
    ``wkv_b``, ``wo`` drawn in that order), the leading dense MLPs under
    ``"dense"``, the MoE layers' router, correction bias (N(0,
    ``bias_scale``^2)), experts and shared MLP under ``"moe"``, then the
    embedding and the unembedding. Every FFN's output projection
    (``w_down``) is drawn at ``ffn_down_init_scale`` of the fan-in rule
    (the configuration's ``assumed`` says why). Norm scales are zero (the
    identity)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, V = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["vocab_size"])
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    Dn, Dr, Dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    k = cfg["first_k_dense_replace"]
    E, Fe, F = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
                cfg["intermediate_size"])
    Fs = cfg["n_shared_experts"] * Fe

    def nrm(shape, fan_in, scale=1.0):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, scale * fan_in ** -0.5, generator=gen)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    attn = {"wq": nrm((L, D, H * (Dn + Dr)), D),
            "wkv_a": nrm((L, D, R + Dr), D),
            "kv_norm": {"scale": zeros(L, R)},
            "wkv_b": nrm((L, R, H * (Dn + Dv)), R),
            "wo": nrm((L, H * Dv, D), H * Dv)}
    layers = {"ln_attn": {"scale": zeros(L, D)}, "attn": attn,
              "ln_mlp": {"scale": zeros(L, D)}}
    down = cfg["ffn_down_init_scale"]
    dense = {"w_gate": nrm((k, D, F), D), "w_up": nrm((k, D, F), D),
             "w_down": nrm((k, F, D), F, down)}
    Lm = L - k
    bias = torch.empty((Lm, E), dtype=dtype, device=device).normal_(
        0.0, cfg["bias_scale"], generator=gen)
    moe = {"router": nrm((Lm, D, E), D), "bias": bias,
           "w_gate": nrm((Lm, E, D, Fe), D), "w_up": nrm((Lm, E, D, Fe), D),
           "w_down": nrm((Lm, E, Fe, D), Fe, down),
           "shared": {"w_gate": nrm((Lm, D, Fs), D),
                      "w_up": nrm((Lm, D, Fs), D),
                      "w_down": nrm((Lm, Fs, D), Fs, down)}}
    params = {"embed": nrm((V, D), D), "layers": layers, "dense": dense,
              "moe": moe, "ln_final": {"scale": zeros(D)}}
    if not cfg.get("tie_word_embeddings"):
        params["lm_head"] = nrm((D, V), D)
    return params


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

def rope_interleaved(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x (T, H, D), pos (T,): the pairs ``(2i, 2i + 1)`` rotated in place
    at ``theta^(-2i / D)``."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=F32, device=x.device) / d)
    ang = pos.to(F32)[:, None] * freq                    # (T, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2)


def causal_attention(q, k, v, scale: float):
    """q/k (T, H, Dk), v (T, H, Dv) -> (T, H, Dv); row t attends 0..t, in
    blocks of ROW_BLOCK query rows."""
    T = q.shape[0]
    kh, vh = k.transpose(0, 1), v.transpose(0, 1)        # (H, T, D)
    out = q.new_empty((T, q.shape[1], v.shape[-1]))
    cols = torch.arange(T, device=q.device)
    for r0 in range(0, T, ROW_BLOCK):
        r1 = min(T, r0 + ROW_BLOCK)
        s = (q[r0:r1].transpose(0, 1) @ kh[:, :r1].transpose(1, 2)) * scale
        mask = cols[None, :r1] > torch.arange(r0, r1, device=q.device)[:, None]
        s.masked_fill_(mask, float("-inf"))
        out[r0:r1] = (torch.softmax(s, dim=-1) @ vh[:, :r1]).transpose(0, 1)
    return out


def _attention(cfg, a, h, pos, mm: _Mm):
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    Dn, Dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    theta = cfg["rope_theta"]
    q = mm.hold(mm(h, mm.w(a["wq"]))).view(-1, H, Dn + Dr)
    kv = mm.hold(mm(h, mm.w(a["wkv_a"])))
    c = mm.hold(rms_norm(kv[:, :R], a["kv_norm"]["scale"],
                         cfg["rms_norm_eps"]))
    k_pe = mm.hold(rope_interleaved(kv[:, None, R:], pos, theta))
    q = torch.cat([q[..., :Dn],
                   mm.hold(rope_interleaved(q[..., Dn:], pos, theta))], -1)
    kvb = mm.hold(mm(c, mm.w(a["wkv_b"]))).view(-1, H,
                                                 Dn + cfg["v_head_dim"])
    k = torch.cat([kvb[..., :Dn], k_pe.expand(-1, H, Dr)], dim=-1)
    o = causal_attention(q, k, kvb[..., Dn:], cfg["qk_head_dim"] ** -0.5)
    return mm(o.reshape(o.shape[0], -1), mm.w(a["wo"]))


def _moe(cfg, lp, h, mm: _Mm, groups, tally: Optional[Dict]):
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    scores = torch.sigmoid(mm(h, mm.w(lp["router"])))
    _, idx = torch.topk(scores + lp["bias"].to(F32), K, dim=-1)
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
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
    return mm.hold(out) + mm.hold(_mlp(lp["shared"], h, mm))


def forward_logits(cfg: Dict, params: Dict, tokens: Sequence[int],
                   rows: Sequence[int], *, moe_groups=(),
                   precision: str = "f32",
                   tally: Optional[Dict] = None) -> torch.Tensor:
    """``reference.forward_logits`` for this architecture."""
    _published(cfg)
    dev = params["embed"].device
    mm = _Mm(precision)
    eps, k = cfg["rms_norm_eps"], cfg["first_k_dense_replace"]
    tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    pos = torch.arange(tok.numel(), device=dev)
    with exact_f32(), torch.no_grad():
        x = mm.hold(params["embed"][tok].to(F32))
        for l in range(cfg["num_hidden_layers"]):
            lp = _layer(params, l)
            h = rms_norm(x, lp["ln_attn"]["scale"], eps)
            x = mm.hold(x + mm.hold(_attention(cfg, lp["attn"], h, pos, mm)))
            h = rms_norm(x, lp["ln_mlp"]["scale"], eps)
            if l < k:
                f = _mlp(_layer({"layers": params["dense"]}, l), h, mm)
            else:
                f = _moe(cfg, _layer({"layers": params["moe"]}, l - k), h,
                         mm, moe_groups, tally)
            x = mm.hold(x + mm.hold(f))
        idx = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
        hf = rms_norm(x[idx], params["ln_final"]["scale"], eps)
        head = (params["embed"].T if cfg.get("tie_word_embeddings")
                else params["lm_head"])
        return mm(hf, mm.w(head))


# ---------------------------------------------------------------------------
# roofline counts: the published attention
# ---------------------------------------------------------------------------

def _pair_flops(cfg: Dict) -> int:
    """QK^T and PV of one query-key pair in one layer."""
    return 2 * cfg["num_attention_heads"] * (cfg["qk_head_dim"]
                                             + cfg["v_head_dim"])


def _query_bytes(cfg: Dict) -> int:
    """One query's q read and o written, in bf16."""
    return cfg["num_attention_heads"] * (cfg["qk_head_dim"]
                                         + cfg["v_head_dim"]) * BF16


def active_params(cfg: Dict) -> int:
    """Weights one token runs through, norm scales and the correction bias
    aside: every attention block, the dense layers, and in each MoE layer
    the router, the top-k routed experts and the shared MLP."""
    D, H, R = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    attn = (D * H * cfg["qk_head_dim"]
            + D * (R + cfg["qk_rope_head_dim"])
            + R * H * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"])
            + H * cfg["v_head_dim"] * D)
    k, Fe = cfg["first_k_dense_replace"], cfg["moe_intermediate_size"]
    moe = (D * cfg["n_routed_experts"]
           + (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
           * 3 * D * Fe)
    L = cfg["num_hidden_layers"]
    return L * attn + k * 3 * D * cfg["intermediate_size"] + (L - k) * moe


def attn_flops(cfg: Dict, keys: int) -> float:
    """The published attention of one query over ``keys`` keys, every
    layer."""
    return float(cfg["num_hidden_layers"] * _pair_flops(cfg) * keys)


def kv_bytes_per_token_layer(cfg: Dict) -> int:
    """One latent row: the normed latent and the roped key."""
    return (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * BF16


def decode_attn_work(cfg: Dict, lengths: Iterable[int]) -> Tuple[float, float]:
    """One layer's decode attention over lanes of ``lengths`` keys each:
    (flops, bytes). Bytes: every latent row read once, each lane's query
    read and output written."""
    lengths = list(lengths)
    keys = sum(lengths)
    return (float(_pair_flops(cfg) * keys),
            kv_bytes_per_token_layer(cfg) * keys
            + _query_bytes(cfg) * len(lengths))


def prefill_attn_work(cfg: Dict, start: int, n: int) -> Tuple[float, float]:
    """One layer's causal attention of a pack of ``n`` queries at
    ``start..``: (flops, bytes). Bytes: the ``start + n`` latent rows read
    once, the queries read and the outputs written."""
    pairs = n * start + n * (n + 1) // 2
    return (float(_pair_flops(cfg) * pairs),
            kv_bytes_per_token_layer(cfg) * (start + n)
            + _query_bytes(cfg) * n)
