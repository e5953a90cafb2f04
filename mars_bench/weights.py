"""Random weights for one configuration, made on the device from the seed.

The benchmark makes them, in the dtype they are served in, one tensor per
call to the generator (a stacked tensor holds a weight of every layer), and
hands the same tensors to the program and to the reference. The layout is
the one the program's decoder takes: per-layer weights stacked under
``"layers"`` with a leading layer axis. Scales follow the usual fan-in rule
(``N(0, 1) / sqrt(fan_in)``); norm scales are zero under the
``(1 + scale)`` convention, so every norm starts as the identity.
"""
from __future__ import annotations

from typing import Dict

import torch


def make_params(cfg: Dict, seed: int, *, dtype=torch.bfloat16,
                device="cuda") -> Dict:
    """The weights of ``cfg`` (a ``configs/<name>.json``'s numbers)."""
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
