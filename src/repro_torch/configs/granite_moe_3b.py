"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8, d_ff=512.
Experts are TP-sharded (not EP): with 512-wide experts the EP all_to_all
volume exceeds expert FLOPs — see DESIGN.md. [hf:ibm-granite/granite-3.0]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512, shard_mode="tp"),
)
