"""zamba2-1.2b — Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="zamba2",
    n_layers=38,           # mamba2 layers
    d_model=2048,
    n_heads=32,            # shared attention block (MHA, kv=32)
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=64),
)
