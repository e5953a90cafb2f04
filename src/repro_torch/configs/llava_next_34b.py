"""llava-next-34b — VLM; anyres patch tiling is a stub that provides
precomputed patch embeddings prepended to the text sequence.
[hf:llava-hf/llava-v1.6; backbone per assignment]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    frontend="image_patches",
    n_frontend_tokens=2880,     # anyres 5-tile x 576 patches
)
