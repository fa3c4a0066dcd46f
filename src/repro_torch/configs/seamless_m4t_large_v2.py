"""seamless-m4t-large-v2 [audio/enc-dec] — 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf]

24L is interpreted as 24 encoder + 24 decoder layers (SeamlessM4T-large
layout).  The audio frontend is a stub: ``input_specs`` supplies
precomputed frame embeddings (B, T, d_model).

A copy of the JAX package's ``configs/seamless_m4t_large_v2.py``."""
from .base import ModelConfig

ARCH_ID = "seamless-m4t-large-v2"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="encdec",
        n_layers=24,
        n_enc_layers=24,
        n_dec_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256206,
        ffn="gelu",
        ffn_bias=True,
        norm="layernorm",
        tie_embeddings=True,
        source="[arXiv:2308.11596; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=2, n_enc_layers=2, n_dec_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        remat=False,
    )
