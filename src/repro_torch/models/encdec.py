"""Encoder-decoder transformer backbone (SeamlessM4T-large-v2 layout: 24
encoder + 24 decoder layers, d_model 1024, 16 heads, GELU d_ff 8192,
vocab 256 206, tied decoder embedding / LM head).

A port of the JAX package's ``models/encdec.py``.  The audio frontend is
a stub, as there: callers hand precomputed frame embeddings (B, T_frames,
d_model) in the config's dtype; this module is the transformer backbone
only.

Entry points:

* ``init(cfg, generator, device)``                       — parameter dict
* ``encode(params, frame_embeds, cfg)``                   — (B, T, d) encoder output
* ``apply(params, frame_embeds, dec_tokens, cfg)``        — (B, S, vocab) fp32 logits
* ``init_cache(params, frame_embeds, cfg, max_len)``      — the decode state
* ``decode_step(params, cache, token, pos, cfg)``         — one-token serve step

``encode`` and ``apply`` run one Forge-compiled encoder body and one
decoder body (``cfg.fuse == 'forge'``) in a Python loop over the layers,
where the JAX package scans them over layer-stacked parameters.  Decode:
the decoder's causal self-attention writes a KV cache at one shared
position; its cross-attention reads K/V that :func:`init_cache`
precomputes once from the encoder output.  The decode step is unfused
ATen ops throughout, as the reference's scanned step is: a caller that
compiles the whole step (``ForgeCompiler``) meets its attention and
projections as one graph and fuses them there.

Every entry point that creates tensors from nothing runs on the CUDA
device unless the caller passes ``device="cpu"``; the others follow their
inputs' device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as A
from . import layers as L
from ._forge import config_key, forge_body

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def _n_dec(cfg: ModelConfig) -> int:
    return cfg.n_dec_layers or cfg.n_layers


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _attn_init(generator, cfg: ModelConfig, device) -> Params:
    return A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                       dtype=_dtype(cfg), device=device)


def _ffn_init(generator, cfg: ModelConfig, device) -> Params:
    return L.ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.ffn, bias=cfg.ffn_bias,
                      dtype=_dtype(cfg), device=device)


def _enc_block_init(generator, cfg: ModelConfig, device) -> Params:
    return {
        "norm1": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "attn": _attn_init(generator, cfg, device),
        "norm2": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "ffn": _ffn_init(generator, cfg, device),
    }


def _dec_block_init(generator, cfg: ModelConfig, device) -> Params:
    return {
        "norm1": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "self_attn": _attn_init(generator, cfg, device),
        "norm_x": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "cross_attn": _attn_init(generator, cfg, device),
        "norm2": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "ffn": _ffn_init(generator, cfg, device),
    }


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device] = "cuda") -> Params:
    """Random parameters with the JAX package's distributions and layout
    (per-layer lists where it stacks layers).  ``generator`` must live on
    ``device``.  A tied config stores ONE embedding tensor, read again by
    the LM head."""
    device = resolve_device(device)
    params: Params = {
        "enc_blocks": [_enc_block_init(generator, cfg, device) for _ in range(_n_enc(cfg))],
        "enc_norm": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "dec_blocks": [_dec_block_init(generator, cfg, device) for _ in range(_n_dec(cfg))],
        "dec_norm": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, _dtype(cfg), device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab, _dtype(cfg), device)
    return params


# --------------------------------------------------------------------------
# block bodies (the Forge capture targets)
# --------------------------------------------------------------------------


def _enc_block(p: Params, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    a, _ = A.attention(h, p["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       rope_cos=cos, rope_sin=sin, causal=False)
    x = x + a
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + L.apply_ffn(h, p["ffn"], cfg.ffn)


def _dec_block(p: Params, x: torch.Tensor, enc_out: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    a, _ = A.attention(h, p["self_attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       rope_cos=cos, rope_sin=sin, causal=True)
    x = x + a
    h = L.apply_norm(x, p["norm_x"], cfg.norm)
    c, _ = A.attention(h, p["cross_attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       causal=False, kv=enc_out)
    x = x + c
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + L.apply_ffn(h, p["ffn"], cfg.ffn)


def _body(cfg: ModelConfig, mode: str, raw, example_args, impl: Optional[str]):
    """The Forge-compiled ``mode`` body ("enc" | "dec"), keyed by the whole
    config: bf16, f32 and smoke bodies never share a program."""
    return forge_body(lambda *a: raw(*a, cfg=cfg), f"{config_key(cfg)}/{mode}", example_args,
                      enabled=(cfg.fuse == "forge"), impl=impl, remat=cfg.remat)


# --------------------------------------------------------------------------
# forward paths
# --------------------------------------------------------------------------


def encode(params: Params, frame_embeds: torch.Tensor, cfg: ModelConfig, *,
           impl: Optional[str] = None) -> torch.Tensor:
    """(B, T, d) frame embeddings -> (B, T, d) encoder output (after the
    final norm): non-causal self-attention over the frames."""
    x = frame_embeds
    T = x.shape[1]
    cos, sin = L.rope_tables(torch.arange(T, device=x.device), cfg.head_dim_, cfg.rope_theta)
    blocks = params["enc_blocks"]
    body = _body(cfg, "enc", _enc_block, (blocks[0], x, cos, sin), impl)
    for p_layer in blocks:
        x = body(p_layer, x, cos, sin)
    return L.apply_norm(x, params["enc_norm"], cfg.norm)


def apply(params: Params, frame_embeds: torch.Tensor, dec_tokens: torch.Tensor,
          cfg: ModelConfig, *, impl: Optional[str] = None) -> torch.Tensor:
    """Full encoder-decoder forward: frame embeddings (B, T, d) and
    decoder tokens (B, S) -> (B, S, vocab) fp32 logits."""
    enc_out = encode(params, frame_embeds, cfg, impl=impl)
    x = L.embed(dec_tokens, params["embed"])
    S = x.shape[1]
    cos, sin = L.rope_tables(torch.arange(S, device=x.device), cfg.head_dim_, cfg.rope_theta)
    blocks = params["dec_blocks"]
    body = _body(cfg, "dec", _dec_block, (blocks[0], x, enc_out, cos, sin), impl)
    for p_layer in blocks:
        x = body(p_layer, x, enc_out, cos, sin)
    x = L.apply_norm(x, params["dec_norm"], cfg.norm)
    return L.lm_head(x, params.get("lm_head", params["embed"]), transpose=cfg.tie_embeddings)


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------


def init_cache(params: Params, frame_embeds: torch.Tensor, cfg: ModelConfig, max_len: int,
               *, impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Run the encoder once and precompute every decoder layer's cross K/V
    (plain products, as in the JAX package).  The JAX package's layout: a
    leading ``n_dec`` axis on ``self_k`` / ``self_v`` (n_dec, B, KVH,
    max_len, hd), zeros, and ``cross_k`` / ``cross_v`` (n_dec, B, KVH, T,
    hd)."""
    enc_out = encode(params, frame_embeds, cfg, impl=impl)
    B = enc_out.shape[0]
    ks, vs = [], []
    for p_layer in params["dec_blocks"]:
        ks.append(A._split_heads(L.linear(enc_out, p_layer["cross_attn"]["wk"]), cfg.n_kv_heads))
        vs.append(A._split_heads(L.linear(enc_out, p_layer["cross_attn"]["wv"]), cfg.n_kv_heads))
    shape = (_n_dec(cfg), B, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {
        "self_k": torch.zeros(shape, dtype=_dtype(cfg), device=enc_out.device),
        "self_v": torch.zeros(shape, dtype=_dtype(cfg), device=enc_out.device),
        "cross_k": torch.stack(ks),
        "cross_v": torch.stack(vs),
    }


def decode_step(params: Params, cache: Dict[str, torch.Tensor], token: torch.Tensor,
                pos: Union[int, torch.Tensor], cfg: ModelConfig, *,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One serve step at one shared position ``pos`` (a 0-d tensor inside a
    capture: ``torch.export`` freezes a Python int): the causal
    self-attention writes its K/V at ``pos``, the cross-attention attends
    to the cached encoder K/V without a mask.  Returns the (B, 1, vocab)
    fp32 logits and the new cache (the cross K/V passed through).

    The step runs no Forge body (the reference's scanned step has none),
    so ``impl`` has nothing to reach here; a compiled step takes its
    fused nodes' ``impl`` from the compiler's configuration."""
    del impl
    x = L.embed(token, params["embed"])
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    cos, sin = L.rope_tables(L.decode_positions(pos), cfg.head_dim_, cfg.rope_theta)
    new_k, new_v = [], []
    for i, p in enumerate(params["dec_blocks"]):
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        a, kv = A.attention(h, p["self_attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                            rope_cos=cos, rope_sin=sin,
                            cache={"k": cache["self_k"][i], "v": cache["self_v"][i]},
                            cache_pos=pos)
        x = x + a
        h = L.apply_norm(x, p["norm_x"], cfg.norm)
        # cross-attention against the precomputed encoder K/V
        q = A._split_heads(L.linear(h, p["cross_attn"]["wq"]), cfg.n_heads)
        c = A.sdpa_unfused(q, cache["cross_k"][i], cache["cross_v"][i], causal=False)
        x = x + L.linear(A._merge_heads(c), p["cross_attn"]["wo"])
        h = L.apply_norm(x, p["norm2"], cfg.norm)
        x = x + L.apply_ffn(h, p["ffn"], cfg.ffn)
        new_k.append(kv["k"])
        new_v.append(kv["v"])
    x = L.apply_norm(x, params["dec_norm"], cfg.norm)
    logits = L.lm_head(x, params.get("lm_head", params["embed"]), transpose=cfg.tie_embeddings)
    new_cache = dict(cache)
    new_cache["self_k"] = torch.stack(new_k)
    new_cache["self_v"] = torch.stack(new_v)
    return logits, new_cache
