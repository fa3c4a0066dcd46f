"""ModelConfig — the single config dataclass all architectures share.

One ``configs/<arch>.py`` per assigned architecture exports ``config()``
(the exact published numbers) and ``smoke_config()`` (a reduced same-family
variant for CPU smoke tests).  ``repro_torch.configs.get_config`` is the
``--arch`` registry.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default: d_model // n_heads

    # block flavour
    ffn: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    ffn_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_experts: int = 0
    shared_d_ff: int = 0

    # hybrid (RecurrentGemma): block pattern unit, tiled over n_layers
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    window: Optional[int] = None
    conv_width: int = 4
    lru_dim: Optional[int] = None  # RG-LRU width (defaults d_model)

    # ssm (xLSTM): 1 sLSTM block every `slstm_every` (0 = all mLSTM)
    slstm_every: int = 0

    # encoder-decoder
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # vlm
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)

    # numerics / runtime
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    fuse: str = "forge"  # none | forge  (Phase-2 pipeline on block bodies)
    # paged-KV attend implementation: "ref" gathers pages and reuses the
    # unfused sdpa (bitwise vs the contiguous cache), "pallas" (the JAX
    # package's name, kept so the field matches it) calls the port's
    # hand-written paged-attention kernel, kernels/paged_attention.py: the
    # CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.
    # Only consulted by the paged decode/prefill entry points.
    kv_kernel: str = "ref"  # ref | pallas

    # provenance
    source: str = ""  # [arXiv/hf ref; verification tier]

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # -- parameter counting (roofline MODEL_FLOPS term) ------------------------

    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim_
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.ffn == "swiglu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            if self.shared_experts:
                ffn += 3 * d * (self.shared_d_ff or self.d_ff * self.shared_experts)
        per_layer = attn + ffn + 2 * d

        if self.family == "hybrid":
            pattern = self.block_pattern or ("rec", "rec", "attn")
            lru = self.lru_dim or d
            rec = (3 * d * lru + lru * d + self.conv_width * lru + 2 * lru
                   + 2 * d)
            n_attn = sum(
                1 for i in range(self.n_layers)
                if pattern[i % len(pattern)] == "attn"
            )
            n_rec = self.n_layers - n_attn
            ffn_l = 3 * d * self.d_ff if self.d_ff else 0
            body = n_attn * (attn + ffn_l + 2 * d) + n_rec * (rec + ffn_l + 2 * d)
        elif self.family == "ssm":
            # mLSTM block: up-proj 2x, qkv on inner dim, gates, down-proj
            inner = 2 * d
            cell = (2 * d * inner + 3 * inner * hd * self.n_heads // max(self.n_heads, 1)
                    + inner * d + 4 * inner)
            body = self.n_layers * (cell + 2 * d)
        elif self.family == "encdec":
            n_enc = self.n_enc_layers or self.n_layers
            n_dec = self.n_dec_layers or self.n_layers
            body = n_enc * per_layer + n_dec * (per_layer + attn + d)
        else:
            body = self.n_layers * per_layer

        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        return body + emb + head

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_ffn = self.n_experts * 3 * d * self.d_ff
        active_ffn = self.top_k * 3 * d * self.d_ff
        if self.shared_experts:
            active_ffn += 3 * d * (self.shared_d_ff or self.d_ff * self.shared_experts)
            dense_ffn += 3 * d * (self.shared_d_ff or self.d_ff * self.shared_experts)
        return self.param_count() - self.n_layers * (dense_ffn - active_ffn)
