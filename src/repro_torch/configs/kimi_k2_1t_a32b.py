"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 + 1 shared expert.
[arXiv:2501.kimi2; unverified — paper-table config]

Trillion-parameter MoE.  Training memory note (DESIGN §7): bf16 params
(~2 TB) + Adafactor factored states — Adam fp32 states would exceed the
single-pod HBM; sharding plan is FSDP(data)×EP(model).

A copy of the JAX package's ``configs/kimi_k2_1t_a32b.py``."""
from .base import ModelConfig

ARCH_ID = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=112,
        d_ff=2048,
        vocab=163840,
        n_experts=384,
        top_k=8,
        shared_experts=1,
        shared_d_ff=2048,
        ffn="swiglu",
        source="[arXiv:2501.kimi2; unverified]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=512, n_experts=8, top_k=2, shared_experts=1,
        shared_d_ff=32, remat=False,
    )
