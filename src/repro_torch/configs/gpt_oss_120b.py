"""GPT-OSS-120B — the paper\'s larger evaluation model (131K context).
Used by the reproduction benchmarks, not an assigned arch. [OpenAI model card]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="gpt-oss-120b",
    family="moe",
    n_layers=36,
    d_model=2880,
    n_heads=64,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2880,
    vocab_size=201_088,
    layer_pattern=("local", "global"),
    sliding_window=128,
    moe=MoEConfig(num_experts=128, top_k=4, d_ff_expert=2880, shard_mode="ep"),
)
CONTEXT_LIMIT = 131_072
