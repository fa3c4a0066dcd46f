"""Architecture registry — the ``--arch <id>`` lookup.

The port carries ``forge-125m`` (a GPT-2-class dense decoder, the serve
CLI's default) and its smoke variant; the other architectures of the
JAX package follow in later slices.
"""
from __future__ import annotations

from typing import List

from .base import ModelConfig

ARCH_IDS: List[str] = ["forge-125m"]


def forge_125m() -> ModelConfig:
    """GPT-2-class reference config (paper's smallest model family)."""
    return ModelConfig(
        name="forge-125m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=50257,
        ffn="gelu",
        ffn_bias=True,
        norm="layernorm",
        tie_embeddings=True,
        source="[GPT-2 125M layout]",
    )


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id != "forge-125m":
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    cfg = forge_125m()
    return cfg.with_(
        name=cfg.name + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, remat=False,
    ) if smoke else cfg


__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "forge_125m"]
