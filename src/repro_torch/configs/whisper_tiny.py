"""whisper-tiny — enc-dec audio backbone; conv frontend is a stub that
consumes precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="whisper",
    n_layers=4,            # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    norm_type="layernorm",
    act="gelu",
    gated_mlp=False,
    max_target_len=448,
    frontend="audio_frames",
)
