"""deepseek-7b [dense] — 30L d_model=4096 32H (kv=32) d_ff=11008
vocab=102400, llama-arch.  [arXiv:2401.02954; hf]

A copy of the JAX package's ``configs/deepseek_7b.py``."""
from .base import ModelConfig

ARCH_ID = "deepseek-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab=102400,
        ffn="swiglu",
        source="[arXiv:2401.02954; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, remat=False,
    )
