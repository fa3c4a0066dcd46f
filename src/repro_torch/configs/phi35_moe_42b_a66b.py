"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]

A copy of the JAX package's ``configs/phi35_moe_42b_a66b.py``."""
from .base import ModelConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab=32064,
        n_experts=16,
        top_k=2,
        ffn="swiglu",
        source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=512, n_experts=4, top_k=2, remat=False,
    )
