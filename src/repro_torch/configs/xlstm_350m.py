"""xlstm-350m [ssm] — 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304;
sLSTM + mLSTM blocks (1 sLSTM per 8).  [arXiv:2405.04517; unverified]

A copy of the JAX package's ``configs/xlstm_350m.py``.
d_ff=0: no separate FFN — blocks carry internal up/down projections.
Attention fusion is INAPPLICABLE (no softmax-attention subgraph; reported
as 0 matches, not an error).  ``long_500k`` RUNS (O(1) decode state)."""
from .base import ModelConfig

ARCH_ID = "xlstm-350m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        slstm_every=8,
        conv_width=4,
        tie_embeddings=True,
        scan_layers=False,  # heterogeneous block mix
        source="[arXiv:2405.04517; unverified]",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name=ARCH_ID + "-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, vocab=512,
        slstm_every=3, remat=False,
    )
