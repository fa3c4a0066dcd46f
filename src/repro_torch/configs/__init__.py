"""Architecture registry — the ``--arch <id>`` lookup.

The port carries ``forge-125m`` (a GPT-2-class dense decoder, the serve
CLI's default), the SwiGLU dense decoders ``deepseek-7b``,
``phi3-mini-3.8b``, ``qwen1.5-32b`` and ``qwen2.5-14b`` (GQA 40/8),
``recurrentgemma-2b`` (the RG-LRU / local-attention hybrid),
``xlstm-350m`` (mLSTM + sLSTM blocks), the MoE decoders
``phi3.5-moe-42b-a6.6b`` (16 experts, top-2) and ``kimi-k2-1t-a32b`` (384
experts, top-8, one shared expert), the M-RoPE VLM backbone
``qwen2-vl-72b``, the encoder-decoder ``seamless-m4t-large-v2`` (24 + 24
layers, GELU, tied 256 206-entry head) and their smoke variants: every
architecture of the JAX package.  ``shapes`` holds the assigned input
shapes and their meta-tensor stand-ins (the dry run's inputs).
"""
from __future__ import annotations

from typing import Dict, List

from . import (deepseek_7b, kimi_k2_1t_a32b, phi3_mini_38b, phi35_moe_42b_a66b, qwen2_vl_72b,
               qwen15_32b, qwen25_14b, recurrentgemma_2b, seamless_m4t_large_v2, xlstm_350m)
from .base import ModelConfig
from .shapes import (SHAPES, SUBQUADRATIC, ShapeSpec, cache_specs, input_specs, params_specs,
                     shape_applicable)

REGISTRY: Dict[str, object] = {m.ARCH_ID: m for m in (
    deepseek_7b, phi3_mini_38b, qwen15_32b, qwen25_14b, recurrentgemma_2b, xlstm_350m,
    phi35_moe_42b_a66b, kimi_k2_1t_a32b, qwen2_vl_72b, seamless_m4t_large_v2)}
ARCH_IDS: List[str] = ["forge-125m"] + list(REGISTRY)


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
    if arch_id == "forge-125m":
        cfg = forge_125m()
        return cfg.with_(
            name=cfg.name + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=128, vocab=512, remat=False,
        ) if smoke else cfg
    mod = REGISTRY.get(arch_id)
    if mod is None:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return mod.smoke_config() if smoke else mod.config()


__all__ = ["ModelConfig", "REGISTRY", "ARCH_IDS", "get_config", "forge_125m", "SHAPES",
           "SUBQUADRATIC", "ShapeSpec", "cache_specs", "input_specs", "params_specs",
           "shape_applicable"]
