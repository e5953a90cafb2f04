"""gemma2-27b — dense, local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_sublayer_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    act="gelu",
    rope_theta=10_000.0,
)
