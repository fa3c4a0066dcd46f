"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention, pattern (rec, rec, attn),
window 2048.  [arXiv:2402.19427; hf]

A copy of the JAX package's ``configs/recurrentgemma_2b.py``.
Sub-quadratic: decode state is O(1) (LRU state + bounded window KV)."""
from .base import ModelConfig

ARCH_ID = "recurrentgemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab=256000,
        ffn="geglu",
        block_pattern=("rec", "rec", "attn"),
        window=2048,
        conv_width=4,
        lru_dim=2560,
        tie_embeddings=True,
        scan_layers=False,  # heterogeneous pattern -> python-loop layers
        source="[arXiv:2402.19427; hf]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab=512, window=8, lru_dim=64, remat=False,
    )
