"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv6",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # = d_model / head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
)
