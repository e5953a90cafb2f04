"""Decoder LMs with grouped-query attention: dense (a SiLU-gated MLP) or
top-k MoE (a softmax router over ``num_experts`` experts), as the
program's paged path serves them (``family`` ``dense`` or ``moe``).

The model follows the configuration's published equations as the program
serves them: RMSNorm with the ``(1 + scale)`` convention, split-half RoPE,
causal GQA (query head ``h`` reads key/value head ``h // G``), a SiLU-gated
MLP, and for MoE a softmax router whose top-k weights are renormalised.
The MoE layer keeps the program's capacity semantics
(``reference._moe_keep``): a call's drops depend on the tokens in that
call, so ``moe_groups`` tells the reference which positions the served
path routed together and at what padded width; a position alone in its
group keeps all k experts.
"""
from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from mars_bench.reference import (F32, _layer, _mlp, _Mm, _moe_keep,
                                  causal_attention, exact_f32, rms_norm,
                                  rope)
from mars_bench.roofline import BF16


def program_config(cfg: Dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    moe = None
    if cfg.get("num_experts"):
        moe = MoEConfig(num_experts=cfg["num_experts"],
                        top_k=cfg["num_experts_per_tok"],
                        d_ff_expert=cfg["moe_intermediate_size"],
                        capacity_factor=cfg["capacity_factor"],
                        shard_mode="tp")
    return ModelConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["moe_intermediate_size"] if moe else cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        qkv_bias=bool(cfg.get("attention_bias")),
        tie_embeddings=bool(cfg.get("tie_word_embeddings")),
        norm_eps=float(cfg["rms_norm_eps"]), moe=moe)


def toy(cfg: Dict) -> Dict:
    """A copy at the CPU tests' widths."""
    cfg = copy.deepcopy(cfg)
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=96,
               vocab_size=256)
    if cfg.get("num_experts"):
        cfg.update(num_experts=8, num_experts_per_tok=2,
                   moe_intermediate_size=32)
    return cfg


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def make_params(cfg: Dict, seed: int, *, dtype=torch.bfloat16,
                device="cuda") -> Dict:
    """The weights of ``cfg``: q, k and v projections of ``head_dim``
    per head, then the MoE experts and router or the dense MLP, then the
    embedding and the unembedding."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, V = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["vocab_size"])
    Dh = cfg["head_dim"]
    qd, kd = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh

    def nrm(shape, fan_in):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, fan_in ** -0.5, generator=gen)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    attn = {"wq": nrm((L, D, qd), D), "wk": nrm((L, D, kd), D),
            "wv": nrm((L, D, kd), D), "wo": nrm((L, qd, D), qd)}
    if cfg.get("attention_bias"):
        attn.update(bq=nrm((L, qd), D), bk=nrm((L, kd), D),
                    bv=nrm((L, kd), D))
    layers = {"ln_attn": {"scale": zeros(L, D)}, "attn": attn,
              "ln_mlp": {"scale": zeros(L, D)}}
    if cfg.get("num_experts"):
        E, F = cfg["num_experts"], cfg["moe_intermediate_size"]
        layers["moe"] = {"router": nrm((L, D, E), D),
                         "w_gate": nrm((L, E, D, F), D),
                         "w_up": nrm((L, E, D, F), D),
                         "w_down": nrm((L, E, F, D), F)}
    else:
        F = cfg["intermediate_size"]
        layers["mlp"] = {"w_gate": nrm((L, D, F), D),
                         "w_up": nrm((L, D, F), D),
                         "w_down": nrm((L, F, D), F)}
    params = {"embed": nrm((V, D), D), "layers": layers,
              "ln_final": {"scale": zeros(D)}}
    if not cfg.get("tie_word_embeddings"):
        params["lm_head"] = nrm((D, V), D)
    return params


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

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


def forward_logits(cfg: Dict, params: Dict, tokens: Sequence[int],
                   rows: Sequence[int], *, moe_groups=(),
                   precision: str = "f32",
                   tally: Optional[Dict] = None) -> torch.Tensor:
    """``reference.forward_logits`` for this architecture."""
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


# ---------------------------------------------------------------------------
# roofline counts
# ---------------------------------------------------------------------------

def active_params(cfg: Dict) -> int:
    """Non-embedding parameters one token runs through (top-k experts)."""
    D, Dh = cfg["hidden_size"], cfg["head_dim"]
    qd = cfg["num_attention_heads"] * Dh
    kd = cfg["num_key_value_heads"] * Dh
    attn = D * qd + 2 * D * kd + qd * D
    if cfg.get("num_experts"):
        ffn = (D * cfg["num_experts"]
               + cfg["num_experts_per_tok"] * 3 * D
               * cfg["moe_intermediate_size"])
    else:
        ffn = 3 * D * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn)


def attn_flops(cfg: Dict, keys: int) -> float:
    """QK^T and PV of one query over ``keys`` keys, every layer."""
    return (4.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * cfg["head_dim"] * keys)


def kv_bytes_per_token_layer(cfg: Dict) -> int:
    return 2 * cfg["num_key_value_heads"] * cfg["head_dim"] * BF16


def decode_attn_work(cfg: Dict, lengths: Iterable[int]) -> Tuple[float, float]:
    """One layer's decode attention over lanes of ``lengths`` keys each:
    (flops, bytes). Bytes: every key and value read once, each lane's
    query read and output written."""
    Hq, Dh = cfg["num_attention_heads"], cfg["head_dim"]
    lengths = list(lengths)
    flops = 4.0 * Hq * Dh * sum(lengths)
    nbytes = (kv_bytes_per_token_layer(cfg) * sum(lengths)
              + 2 * Hq * Dh * BF16 * len(lengths))
    return flops, nbytes


def prefill_attn_work(cfg: Dict, start: int, n: int) -> Tuple[float, float]:
    """One layer's causal attention of a pack of ``n`` queries at
    ``start..``: (flops, bytes). Bytes: the ``start + n`` keys and values
    read once, the queries read and the outputs written."""
    Hq, Dh = cfg["num_attention_heads"], cfg["head_dim"]
    keys = n * start + n * (n + 1) // 2
    flops = 4.0 * Hq * Dh * keys
    nbytes = (kv_bytes_per_token_layer(cfg) * (start + n)
              + 2 * Hq * Dh * BF16 * n)
    return flops, nbytes
