"""Qwen3-Coder-30B-A3B-Instruct — the paper\'s primary evaluation model
(262K context). Used by the reproduction benchmarks, not an assigned arch.
[arXiv:2505.09388]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-coder-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    rope_theta=10_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768, shard_mode="tp"),
)
CONTEXT_LIMIT = 262_144
