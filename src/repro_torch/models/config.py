"""Model configuration for all assigned architectures.

One ``ModelConfig`` describes any member of the supported families:
dense decoder LMs (optionally with sliding-window/global alternation and logit
softcaps), MoE decoder LMs, RWKV6, Mamba2/Zamba2 hybrids, and Whisper-style
encoder-decoders. ``src/repro/configs/<arch>.py`` instantiate the full-scale
configs; ``reduced()`` derives CPU-smoke-test variants of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # 'ep' shards experts over the data axis (all_to_all dispatch); 'tp' keeps
    # experts replicated over data and shards d_ff over the model axis.
    shard_mode: str = "ep"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclass(frozen=True)
class ModelConfig:
    name: str
    # 'dense' | 'moe' | 'rwkv6' | 'zamba2' | 'whisper' — selects the forward fn.
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # defaults to d_model // n_heads

    # --- attention options -------------------------------------------------
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None      # gemma2: 50.0
    final_logit_softcap: Optional[float] = None     # gemma2: 30.0
    sliding_window: Optional[int] = None            # window size for local layers
    # layer pattern, e.g. ('local', 'global'); repeated to cover n_layers.
    layer_pattern: Tuple[str, ...] = ("global",)
    post_sublayer_norm: bool = False                # gemma2 pre+post norms
    norm_type: str = "rmsnorm"                      # 'rmsnorm' | 'layernorm'
    act: str = "silu"                               # mlp activation ('silu'|'gelu')
    gated_mlp: bool = True
    tie_embeddings: bool = False
    embed_scale: bool = False                       # gemma-style sqrt(d) embed scale
    norm_eps: float = 1e-6

    # --- family-specific ----------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # zamba2: shared attention block applied every k mamba layers.
    shared_attn_every: int = 6
    # whisper: encoder depth (decoder uses n_layers); frontend is a stub that
    # consumes precomputed frame embeddings of length enc_len.
    n_enc_layers: int = 0
    max_target_len: int = 448

    # --- modality stubs ----------------------------------------------------
    # 'none' | 'audio_frames' | 'image_patches': input_specs() provides
    # precomputed embeddings for the stub frontend.
    frontend: str = "none"
    n_frontend_tokens: int = 0

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer attention kind, e.g. ('local','global','local',...)."""
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def is_subquadratic(self) -> bool:
        """True if the arch admits 500K-token decode (SSM / linear-attn /
        local+global hybrids where local layers bound most KV)."""
        if self.family in ("rwkv6", "zamba2"):
            return True
        return self.sliding_window is not None and "local" in self.layer_pattern

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4 if self.family != "zamba2" else 7),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            sliding_window=64 if self.sliding_window else None,
            n_enc_layers=2 if self.n_enc_layers else 0,
            shared_attn_every=3,
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2), d_ff_expert=64)
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk_size=16)
        if self.rwkv is not None:
            small["rwkv"] = dataclasses.replace(
                self.rwkv, head_size=32, decay_lora=16, mix_lora=8)
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-smoke", **small)

    # --- analytic parameter count (for roofline MODEL_FLOPS) ----------------
    def param_count(self, active_only: bool = False) -> int:
        D, V, L = self.d_model, self.vocab_size, self.n_layers
        n = V * D  # embed
        if not self.tie_embeddings:
            n += V * D
        if self.family == "rwkv6":
            assert self.rwkv is not None
            H = D // self.rwkv.head_size
            per = (5 * D * D            # r,k,v,g,o  (w is lora)
                   + 2 * D * self.rwkv.decay_lora
                   + 5 * 2 * D * self.rwkv.mix_lora
                   + 2 * H * self.rwkv.head_size
                   + 2 * D * self.d_ff + self.d_ff * 0)
            return n + L * per
        attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
        mlp_dense = (3 if self.gated_mlp else 2) * D * self.d_ff
        if self.family == "moe":
            assert self.moe is not None
            e_all = self.moe.num_experts
            e_act = self.moe.top_k
            per_expert = (3 if self.gated_mlp else 2) * D * self.moe.d_ff_expert
            router = D * e_all
            per_layer_total = attn + router + e_all * per_expert
            per_layer_active = attn + router + e_act * per_expert
            return n + L * (per_layer_active if active_only else per_layer_total)
        if self.family == "zamba2":
            assert self.ssm is not None
            di = self.ssm.d_inner(D)
            H = self.ssm.n_heads(D)
            mamba = (D * (2 * di + 2 * self.ssm.d_state + H)  # in_proj(z,x,B,C,dt)
                     + di * self.ssm.d_conv + di * D)
            n_shared = max(1, L // self.shared_attn_every)
            shared = attn + mlp_dense
            return n + L * mamba + shared + 0 * n_shared
        if self.family == "whisper":
            enc = self.n_enc_layers * (attn + mlp_dense)
            dec = L * (2 * attn + mlp_dense)  # self + cross
            return n + enc + dec
        return n + L * (attn + mlp_dense)
