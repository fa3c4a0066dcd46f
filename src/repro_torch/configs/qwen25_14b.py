"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5 family; hf]

A copy of the JAX package's ``configs/qwen25_14b.py``."""
from .base import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13824,
        vocab=152064,
        qkv_bias=True,
        ffn="swiglu",
        rope_theta=1_000_000.0,
        source="[hf:Qwen/Qwen2.5-0.5B; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, remat=False,
    )
