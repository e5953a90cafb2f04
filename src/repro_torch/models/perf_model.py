"""Analytic performance/footprint model.

Two consumers:
  * the discrete-event serving simulator (service time of prefill chunks /
    decode steps on a given hardware spec), and
  * the roofline analysis (MODEL_FLOPS = 6·N·D for train, 2·N_active·tokens
    for inference, KV footprints, ideal execution times for SLO targets).

All byte counts assume bf16 weights/KV unless stated.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s
    hbm_bytes: float
    link_bw: float             # bytes/s per ICI/NVLink link
    host_dev_bw: float = 25e9  # device<->host (KV swap path)
    mfu_prefill: float = 0.55  # achievable fraction of peak, compute-bound
    mbu_decode: float = 0.70   # achievable fraction of HBM bw, memory-bound


# host_dev_bw: effective KV swap bandwidth of the stock vLLM swapper (the
# baseline implementation the paper evaluates InferCept on): paged KV is
# offloaded as per-layer-per-block scattered copies (~32 KB each for a
# 16-token GQA block), thousands of small DMAs whose launch overhead caps
# effective bandwidth at a few GB/s — InferCept's own measurements of the
# stock swap path report low single-digit GB/s. We use 3 GB/s effective.
TPU_V5E = HardwareSpec("tpu-v5e", 197e12, 819e9, 16e9, 50e9, host_dev_bw=3e9)
H100 = HardwareSpec("h100-nvl", 989e12, 3.35e12, 96e9, 450e9, host_dev_bw=3e9)
H200 = HardwareSpec("h200-nvl", 989e12, 4.8e12, 144e9, 450e9, host_dev_bw=3e9)

HW = {"tpu-v5e": TPU_V5E, "h100": H100, "h200": H200}


# ---------------------------------------------------------------------------
# per-token costs
# ---------------------------------------------------------------------------

def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """KV-cache bytes appended per generated/prefilled token."""
    if cfg.family == "rwkv6":
        return 0               # constant state, no per-token growth
    if cfg.family == "zamba2":
        n_apps = max(1, cfg.n_layers // cfg.shared_attn_every)
        return n_apps * 2 * cfg.n_kv_heads * cfg.head_dim_ * dtype_bytes
    if cfg.family == "whisper":
        return cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim_ * dtype_bytes
    per_layer = 2 * cfg.n_kv_heads * cfg.head_dim_ * dtype_bytes
    if cfg.sliding_window is not None and "local" in cfg.layer_pattern:
        kinds = cfg.layer_kinds()
        n_global = sum(1 for k in kinds if k != "local")
        # local layers stop growing past the window; amortized ~global only
        # for long contexts. Report full-rate here; window capping is applied
        # by callers that know the context length (see kv_cache_bytes).
        return cfg.n_layers * per_layer
    return cfg.n_layers * per_layer


def state_bytes(cfg: ModelConfig) -> int:
    """Constant per-sequence state (SSM/RWKV) in bytes."""
    if cfg.family == "rwkv6":
        H = cfg.d_model // cfg.rwkv.head_size
        K = cfg.rwkv.head_size
        return cfg.n_layers * (2 * cfg.d_model * 2 + H * K * K * 4)
    if cfg.family == "zamba2":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        H = s.n_heads(cfg.d_model)
        conv = (di + 2 * s.d_state) * (s.d_conv - 1) * 2
        ssm = H * s.head_dim * s.d_state * 4
        return cfg.n_layers * (conv + ssm)
    return 0


def kv_cache_bytes(cfg: ModelConfig, context_len: int, dtype_bytes: int = 2) -> int:
    """Total suspended-state bytes for one sequence at ``context_len``."""
    base = state_bytes(cfg)
    if cfg.family == "rwkv6":
        return base
    per_layer_tok = 2 * cfg.n_kv_heads * cfg.head_dim_ * dtype_bytes
    if cfg.family == "zamba2":
        n_apps = max(1, cfg.n_layers // cfg.shared_attn_every)
        return base + n_apps * context_len * per_layer_tok
    if cfg.family == "whisper":
        dec = min(context_len, cfg.max_target_len)
        return cfg.n_layers * (dec + context_len) * per_layer_tok
    if cfg.sliding_window is not None and "local" in cfg.layer_pattern:
        kinds = cfg.layer_kinds()
        n_local = sum(1 for k in kinds if k == "local")
        n_global = cfg.n_layers - n_local
        local_len = min(context_len, cfg.sliding_window)
        return (n_local * local_len + n_global * context_len) * per_layer_tok
    return cfg.n_layers * context_len * per_layer_tok


def flops_per_token(cfg: ModelConfig, context_len: int = 0) -> float:
    """Forward FLOPs per token: 2·N_active + attention term."""
    n_active = cfg.param_count(active_only=True)
    f = 2.0 * n_active
    if cfg.family not in ("rwkv6",):
        # attention score+value FLOPs vs average context
        H, Dh = cfg.n_heads, cfg.head_dim_
        eff_layers = (max(1, cfg.n_layers // cfg.shared_attn_every)
                      if cfg.family == "zamba2" else cfg.n_layers)
        f += 4.0 * eff_layers * H * Dh * max(context_len, 1)
    return f


def train_flops(cfg: ModelConfig, tokens: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE)."""
    return 6.0 * cfg.param_count(active_only=True) * tokens


# ---------------------------------------------------------------------------
# service-time model (simulator)
# ---------------------------------------------------------------------------

def prefill_time(cfg: ModelConfig, hw: HardwareSpec, n_tokens: int,
                 context_len: int = 0, tp: int = 1) -> float:
    """Seconds to prefill ``n_tokens`` against ``context_len`` history."""
    f = flops_per_token(cfg, context_len + n_tokens // 2) * n_tokens
    return f / (hw.peak_flops * tp * hw.mfu_prefill)


def decode_step_time(cfg: ModelConfig, hw: HardwareSpec, batch: int,
                     avg_context: int, tp: int = 1) -> float:
    """Seconds for one decode step of a ``batch`` of sequences.

    Memory-bound: weights are read once per step; KV is read per sequence.
    """
    w_bytes = 2.0 * cfg.param_count(active_only=True)
    kv = kv_cache_bytes(cfg, avg_context) * batch
    t_mem = (w_bytes + kv) / (hw.hbm_bw * tp * hw.mbu_decode)
    f = flops_per_token(cfg, avg_context) * batch
    t_flop = f / (hw.peak_flops * tp * hw.mfu_prefill)
    return max(t_mem, t_flop)


def swap_time(cfg: ModelConfig, hw: HardwareSpec, context_len: int) -> float:
    """One-way host<->device KV transfer time."""
    return kv_cache_bytes(cfg, context_len) / hw.host_dev_bw


def ideal_session_time(cfg: ModelConfig, hw: HardwareSpec, rounds, tp: int = 1) -> float:
    """Isolated (concurrency=1) execution time of a session.

    ``rounds``: iterable of (new_input_tokens, decode_tokens, tool_seconds).
    Matches the paper's T_ideal definition (vLLM, max concurrency 1).
    """
    t = 0.0
    ctx = 0
    for new_in, n_dec, tool_s in rounds:
        t += prefill_time(cfg, hw, new_in, ctx, tp)
        ctx += new_in
        # closed-form decode: batch-1 steps at the round's average context
        t += n_dec * decode_step_time(cfg, hw, 1, ctx + n_dec // 2, tp)
        ctx += n_dec
        t += tool_s
    return t
