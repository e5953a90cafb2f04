"""Peaks of the card and the operations and bytes the served work needs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the full
700 W): 989 TFLOP/s in bf16, 3.35 TB/s of HBM. A share of a peak is stated
against these, with the card's power limit printed beside it.

The least time of a piece of work is ``max(bytes / HBM_BPS, flops /
PEAK_FLOPS)``, the bound formula of ``chip_smoke.py``. Operations and
bytes are counted from the shapes of the work the schedule asked for:
each input byte read once, each output byte written once, causal
attention over the keys each query needs, top-k experts (never the
capacity a dispatch computes). So they read the same whatever implements
the step, and a share computed from them cannot pass 100 % unless the
time leaves out part of the work. The counts that depend on the
architecture are its module's (``arch/<name>.py``); this file composes
them.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from mars_bench import arch

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores
HBM_BPS = 3.35e12          # bytes / s
BF16 = 2                   # bytes per served element


def least_s(flops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS)


def active_params(cfg: Dict) -> int:
    """Non-embedding parameters one token runs through (top-k experts)."""
    return arch.module(cfg).active_params(cfg)


def attn_flops(cfg: Dict, keys: int) -> float:
    """Attention's operations for one query over ``keys`` keys, every
    layer."""
    return arch.module(cfg).attn_flops(cfg, keys)


def token_flops(cfg: Dict, keys: int, logits: bool) -> float:
    """One token's forward: the active parameters, attention over
    ``keys`` keys, the unembedding where its logits are formed."""
    f = 2.0 * active_params(cfg) + attn_flops(cfg, keys)
    if logits:
        f += 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    return f


def pack_flops(cfg: Dict, start: int, n: int) -> float:
    """A prefill pack of ``n`` tokens at positions ``start..``: causal
    keys, logits at its last token."""
    keys = n * start + n * (n + 1) // 2
    return (2.0 * active_params(cfg) * n + attn_flops(cfg, keys)
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"])


def kv_bytes_per_token_layer(cfg: Dict) -> int:
    """Bytes of KV cache one token holds in one layer."""
    return arch.module(cfg).kv_bytes_per_token_layer(cfg)


def decode_attn_work(cfg: Dict, lengths: Iterable[int]) -> Tuple[float, float]:
    """One layer's decode attention over lanes of ``lengths`` keys each:
    (flops, bytes), each input byte read and each output byte written
    once."""
    return arch.module(cfg).decode_attn_work(cfg, lengths)


def prefill_attn_work(cfg: Dict, start: int, n: int) -> Tuple[float, float]:
    """One layer's causal attention of a pack of ``n`` queries at
    ``start..``: (flops, bytes), each input byte read and each output byte
    written once."""
    return arch.module(cfg).prefill_attn_work(cfg, start, n)
