"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; M-RoPE (sections 16/24/24), dynamic resolution.
[arXiv:2409.12191; hf]

The vision frontend is a stub: ``input_specs`` supplies precomputed patch
embeddings merged ahead of the text tokens; this config is the 80-layer
LM backbone with multimodal rotary positions.

A copy of the JAX package's ``configs/qwen2_vl_72b.py``."""
from .base import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab=152064,
        qkv_bias=True,
        ffn="swiglu",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        source="[arXiv:2409.12191; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, mrope_sections=(4, 2, 2), remat=False,
    )
