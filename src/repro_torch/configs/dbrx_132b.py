"""dbrx-132b — MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,            # == d_ff_expert (kept for param accounting)
    vocab_size=100_352,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752, shard_mode="ep"),
)
