"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5 family; hf]

A copy of the JAX package's ``configs/qwen15_32b.py``."""
from .base import ModelConfig

ARCH_ID = "qwen1.5-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_ff=27392,
        vocab=152064,
        qkv_bias=True,
        ffn="swiglu",
        source="[hf:Qwen/Qwen1.5-0.5B; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, remat=False,
    )
