"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064, RoPE SwiGLU.  [arXiv:2404.14219; unverified]

A copy of the JAX package's ``configs/phi3_mini_38b.py``."""
from .base import ModelConfig

ARCH_ID = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32064,
        ffn="swiglu",
        source="[arXiv:2404.14219; unverified]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, remat=False,
    )
