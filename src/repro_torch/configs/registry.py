"""Architecture registry: ``get_config(arch_id)`` / ``ARCH_IDS``.

Each assigned architecture lives in its own module exposing ``CONFIG``.
``cell_is_supported`` encodes the assignment's skip rules (long_500k only for
sub-quadratic archs) — skips are documented in DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec

ARCH_IDS: Tuple[str, ...] = (
    "gemma2-27b",
    "internlm2-20b",
    "qwen2.5-3b",
    "llama3.2-1b",
    "whisper-tiny",
    "llava-next-34b",
    "rwkv6-1.6b",
    "dbrx-132b",
    "granite-moe-3b-a800m",
    "zamba2-1.2b",
)

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "internlm2-20b": "internlm2_20b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3.2-1b": "llama3_2_1b",
    "whisper-tiny": "whisper_tiny",
    "llava-next-34b": "llava_next_34b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "dbrx-132b": "dbrx_132b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "zamba2-1.2b": "zamba2_1b2",
}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cell_is_supported(arch_id: str, shape_name: str) -> Tuple[bool, str]:
    """(supported, reason-if-skipped) for an (arch x shape) cell."""
    cfg = get_config(arch_id)
    sp = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.is_subquadratic():
        return False, ("pure full-attention arch: 500K-token decode KV is "
                       "quadratic-history; skipped per assignment rules")
    if cfg.family == "whisper" and sp.kind == "decode" and sp.seq_len > 4 * cfg.max_target_len:
        # decoder caches stay at max_target_len; seq_len maps to encoder frames.
        pass
    return True, ""
