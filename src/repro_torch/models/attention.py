"""Multi-head / grouped-query attention, written unfused.

The decomposed chain below (projections → RoPE → GQA expansion → matmul
→ scale → where/additive mask → softmax → matmul → out-proj) is exactly
what the Forge attention-fusion pass matches; after Phase 2 the middle
collapses into one ``forge.sdpa`` dispatch.

Carries the no-cache branch (full causal self-attention: the
full-sequence forward) and the contiguous-cache branch (single-token
decode at a scalar or per-row position).  The paged-cache branch comes
with the paged KV slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import layers as L

Params = Dict[str, Any]


def attn_init(
    generator: Optional[torch.Generator],
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: Optional[int] = None,
    *,
    qkv_bias: bool = False,
    dtype=torch.bfloat16,
    device="cpu",
) -> Params:
    hd = head_dim or d_model // n_heads
    p = {
        "wq": L.dense_init(generator, d_model, n_heads * hd, dtype, device),
        "wk": L.dense_init(generator, d_model, n_kv_heads * hd, dtype, device),
        "wv": L.dense_init(generator, d_model, n_kv_heads * hd, dtype, device),
        "wo": L.dense_init(generator, n_heads * hd, d_model, dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv_heads * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_kv_heads * hd,), dtype=dtype, device=device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.view(B, S, n_heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """The canonical GQA expansion (unwrapped again by fusion)."""
    if groups == 1:
        return k
    B, KVH, S, D = k.shape
    return k.unsqueeze(2).expand(B, KVH, groups, S, D).reshape(B, KVH * groups, S, D)


def sdpa_unfused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    extra_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decomposed attention: the fusion pass's input pattern.

    Scores and softmax in fp32, probabilities cast to v's dtype for the
    second product, as the JAX package's ``sdpa_unfused`` does."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    groups = H // KVH
    k = _expand_kv(k, groups)
    v = _expand_kv(v, groups)
    s = torch.matmul(q.float(), k.float().transpose(-2, -1))
    s = s * (1.0 / math.sqrt(D))
    if causal:
        s = L.causal_where(s, Sq, Sk)
    if extra_mask is not None:
        s = s + (extra_mask if extra_mask.dtype == s.dtype else extra_mask.to(s.dtype))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def attention(
    x: torch.Tensor,
    p: Params,
    *,
    n_heads: int,
    n_kv_heads: int,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full attention sub-layer.  Returns (out, updated_cache).

    With a cache, the step's keys and values are written at
    ``cache_pos`` — a 0-d or per-row ``(B,)`` integer tensor — and the
    queries attend to every cache entry at or before their position.
    """
    q = L.linear(x, p["wq"], p.get("bq"))
    k = L.linear(x, p["wk"], p.get("bk"))
    v = L.linear(x, p["wv"], p.get("bv"))
    q = _split_heads(q, n_heads)
    k = _split_heads(k, n_kv_heads)
    v = _split_heads(v, n_kv_heads)

    if rope_cos is not None:
        q = L.apply_rope(q, rope_cos, rope_sin)
        k = L.apply_rope(k, rope_cos, rope_sin)

    new_cache = None
    if cache is not None:
        # one-token decode: write at cache_pos, attend to all keys <= pos.
        # A per-row (B,) position writes and masks each row at its own
        # position (slot-level continuous batching); the write is a select
        # against a position iota, so the captured graph stays in plain ops.
        max_len = cache["k"].shape[2]
        if q.shape[2] != 1:
            raise NotImplementedError(
                "cached attention takes one token per step here; whole-chunk "
                "prefill comes with the 2-D prefill grid"
            )
        slot_idx = torch.arange(max_len, device=x.device).view(1, 1, max_len, 1)
        write = slot_idx == L.per_row_pos(cache_pos)
        k_cache = torch.where(write, k, cache["k"])
        v_cache = torch.where(write, v, cache["v"])
        new_cache = {"k": k_cache, "v": v_cache}
        mask = L.decode_length_mask(cache_pos, max_len)
        out = sdpa_unfused(q, k_cache, v_cache, causal=False, extra_mask=mask)
    else:
        out = sdpa_unfused(q, k, v, causal=causal)
    out = L.linear(_merge_heads(out), p["wo"])
    return out, new_cache
