"""Decoder-only transformer LM (dense + MoE + VLM backbones).

The block body is written unfused; when ``cfg.fuse == 'forge'`` it is
captured and optimized by the Forge pipeline once per (config, shape)
and the compiled body runs once per layer in a Python loop over the
per-layer parameters (the JAX package scans it over layer-stacked
parameters instead).

Entry points:

* ``init(cfg, generator, device)``                — parameter dict
* ``apply(params, tokens, cfg, embeds=, mrope_positions=)`` — full-sequence
  logits (from tokens or from (B, S, D) embeddings; M-RoPE positions
  (3, B, S) for the VLM backbone)
* ``init_cache(cfg, batch, max_len, device)``     — stacked KV cache
* ``decode_step(params, cache, tok, pos, cfg)``   — one-token serve step
* ``prefill_step(params, cache, tokens, pos, cfg)`` — whole-prompt prefill
  of an S-token block into the KV cache in one pass
* ``init_paged_cache(cfg, batch, max_len, num_pages=, page_size=)``,
  ``paged_decode_step``, ``paged_prefill_step``   — the same against a
  flat page pool and a per-row page table (continuous batching)

Every entry point that creates tensors runs on the CUDA device unless the
caller passes ``device="cpu"``; the others follow their inputs' device.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as A
from . import layers as L
from . import moe as MOE
from ._forge import config_key, forge_body

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


#: the backbones this module carries (``models/vlm.py`` wraps it for vlm)
FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: this module carries the "
                                  f"{', '.join(FAMILIES)} backbones")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def block_init(generator: Optional[torch.Generator], cfg: ModelConfig,
               device: torch.device) -> Params:
    dt = _dtype(cfg)
    p: Params = {
        "norm1": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "attn": A.attn_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            qkv_bias=cfg.qkv_bias, dtype=dt, device=device,
        ),
        "norm2": L.norm_init(cfg.d_model, cfg.norm, device=device),
    }
    if cfg.family == "moe":
        p["moe"] = MOE.moe_init(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                shared_experts=cfg.shared_experts,
                                shared_d_ff=cfg.shared_d_ff, dtype=dt, device=device)
    else:
        p["ffn"] = L.ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.ffn,
                              bias=cfg.ffn_bias, dtype=dt, device=device)
    return p


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device] = "cuda") -> Params:
    """Random parameters with the JAX package's distributions.

    ``generator`` must live on ``device`` (a CUDA generator for CUDA).
    Tied configs store ONE embedding tensor, read again by the LM head."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = _dtype(cfg)
    params: Params = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device),
        "blocks": [block_init(generator, cfg, device) for _ in range(cfg.n_layers)],
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab, dt, device)
    return params


# --------------------------------------------------------------------------
# block bodies (the Forge capture targets)
# --------------------------------------------------------------------------


def _ffn(h: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.family == "moe":
        return MOE.moe_ffn(h, p["moe"], n_experts=cfg.n_experts, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor)
    return L.apply_ffn(h, p["ffn"], cfg.ffn)


def block_apply(p: Params, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    attn_out, _ = A.attention(
        h, p["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        rope_cos=cos, rope_sin=sin, causal=True,
    )
    x = x + attn_out
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + _ffn(h, p, cfg)


def block_decode(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    attn_out, new_cache = A.attention(
        h, p["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        rope_cos=cos, rope_sin=sin,
        cache={"k": k_cache, "v": v_cache}, cache_pos=pos,
    )
    x = x + attn_out
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + _ffn(h, p, cfg), new_cache["k"], new_cache["v"]


def block_paged_decode(p: Params, x: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       pos: torch.Tensor, write_mask: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, cfg: ModelConfig,
                       impl: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block body against the paged KV pool (decode and chunked prefill).

    ``k_pages``/``v_pages``: this layer's pool (num_pages, page_size,
    KVH, D); ``page_table`` (B, max_pages), shared by all layers.  Unlike
    :func:`block_decode` the slot mask rides *inside* the body: the page
    store has no batch axis to gate afterwards, so inactive rows' writes
    go to the trash page in the scatter itself."""
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    attn_out, new_cache = A.attention(
        h, p["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        rope_cos=cos, rope_sin=sin,
        cache={"k_pages": k_pages, "v_pages": v_pages, "page_table": page_table},
        cache_pos=pos, write_mask=write_mask, kv_kernel=cfg.kv_kernel, impl=impl,
    )
    x = x + attn_out
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + _ffn(h, p, cfg), new_cache["k_pages"], new_cache["v_pages"]


def paged_body_compiled(cfg: ModelConfig) -> bool:
    """Whether the paged steps call a Forge-compiled block body.  The
    paged kernel is itself the fused dispatch: as in the JAX package the
    body runs raw with ``kv_kernel == "pallas"``, and a caller that
    captures the whole step (the serve fronts) meets the kernel as one
    custom-op node."""
    return cfg.fuse == "forge" and cfg.kv_kernel != "pallas"


def _body_fn(cfg: ModelConfig, mode: str, example_args, impl: Optional[str] = None):
    if mode.startswith("paged_"):
        base = functools.partial(block_paged_decode, impl=impl)
        enabled = paged_body_compiled(cfg)
    else:
        base = block_apply if mode == "apply" else block_decode
        enabled = cfg.fuse == "forge"

    def raw(*args):
        return base(*args, cfg=cfg)

    # the whole config keys the body: two configs can share a name and
    # every parameter shape yet split heads differently
    return forge_body(raw, f"{config_key(cfg)}/{mode}", example_args, enabled=enabled, impl=impl,
                      remat=cfg.remat)


# --------------------------------------------------------------------------
# forward paths
# --------------------------------------------------------------------------


def _rope_for(cfg: ModelConfig, positions: torch.Tensor,
              mrope_positions: Optional[torch.Tensor] = None):
    if cfg.family == "vlm" and mrope_positions is not None:
        return L.mrope_tables(mrope_positions, cfg.head_dim_, cfg.mrope_sections,
                              cfg.rope_theta)
    return L.rope_tables(positions, cfg.head_dim_, cfg.rope_theta)


def _embed_or(tokens: Optional[torch.Tensor], embeds: Optional[torch.Tensor],
              params: Params) -> torch.Tensor:
    return L.embed(tokens, params["embed"]) if embeds is None else embeds


def apply(params: Params, tokens: Optional[torch.Tensor], cfg: ModelConfig, *,
          embeds: Optional[torch.Tensor] = None,
          mrope_positions: Optional[torch.Tensor] = None,
          impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence forward: (B, S) tokens [or (B, S, D) embeds] →
    (B, S, vocab) fp32 logits."""
    _check_family(cfg)
    x = _embed_or(tokens, embeds, params)
    B, S, _ = x.shape
    cos, sin = _rope_for(cfg, torch.arange(S, device=x.device), mrope_positions)
    blocks = params["blocks"]
    body = _body_fn(cfg, "apply", (blocks[0], x, cos, sin), impl)
    for p_layer in blocks:
        x = body(p_layer, x, cos, sin)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return L.lm_head(x, params.get("lm_head", params["embed"]),
                     transpose=cfg.tie_embeddings)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """Whole-block prefill reproduces sequential decode only when no op
    couples tokens across the (B, S) block — false for MoE, whose
    capacity routing is first-come-first-served over the flattened
    token stream (see :func:`prefill_step`)."""
    return cfg.family != "moe"


def _cached_forward(
    params: Params,
    cache: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D) embedded inputs
    pos: torch.Tensor,  # int64 cache write position, 0-d or per-row (B,)
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: ModelConfig,
    mode: str,
    slot_mask: Optional[torch.Tensor] = None,  # bool (B,) — active decode slots
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Layer loop over the block-decode body against the KV cache, final
    norm, LM head.  ``mode`` keys the Forge body compile ("decode" and
    "prefill" apart).  ``slot_mask`` gates the cache update per batch row
    outside the compiled body (the body graph is mask-free): inactive
    rows keep their previous KV bitwise."""
    blocks = params["blocks"]
    body = _body_fn(cfg, mode, (blocks[0], x, cache["k"][0], cache["v"][0], pos, cos, sin),
                    impl)
    ks, vs = [], []
    for i, p_layer in enumerate(blocks):
        x, nk, nv = body(p_layer, x, cache["k"][i], cache["v"][i], pos, cos, sin)
        ks.append(L.slot_gate(slot_mask, nk, cache["k"][i]))
        vs.append(L.slot_gate(slot_mask, nv, cache["v"][i]))
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    logits = L.lm_head(x, params.get("lm_head", params["embed"]),
                       transpose=cfg.tie_embeddings)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(
    params: Params,
    cache: Dict[str, torch.Tensor],
    token: torch.Tensor,  # (B, 1) int
    pos: Union[int, torch.Tensor],  # write position — scalar or per-row (B,)
    cfg: ModelConfig,
    *,
    slot_mask: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One serve step: logits for the next token + updated cache.

    With ``pos`` a per-row vector every batch row decodes at its own
    position (per-row RoPE rotation, KV write and length mask);
    ``slot_mask`` additionally freezes inactive rows' cache updates."""
    _check_family(cfg)
    x = _embed_or(token, embeds, params)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    cos, sin = _rope_for(cfg, L.decode_positions(pos), mrope_positions)
    return _cached_forward(params, cache, x, pos, cos, sin, cfg, "decode",
                           slot_mask=slot_mask, impl=impl)


def _no_moe_prefill(cfg: ModelConfig, instead: str) -> None:
    # capacity routing is first come first served over the flattened
    # token stream: a (B, S) block routes and drops differently than S
    # single steps
    if cfg.family == "moe":
        raise NotImplementedError("MoE capacity routing couples tokens across the block; "
                                  f"prefill sequentially through {instead}")


def prefill_step(
    params: Params,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,  # (B, S) int — a whole (padded) prompt block
    pos: Union[int, torch.Tensor],  # first write position — scalar
    cfg: ModelConfig,
    *,
    slot_mask: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-prompt batched prefill: one forward pass writes the S-token
    block into the KV cache at ``[pos, pos + S)``.

    Equivalent to S sequential :func:`decode_step` calls (the causal
    length mask keeps query i from seeing keys beyond ``pos + i``) in one
    dispatch.  Returns the full (B, S, vocab) logits (the serve path
    reads the last real column) and the updated cache.  ``slot_mask``
    restricts the cache write to the marked rows: every other row's KV
    stays bitwise untouched (the slot scheduler's swap-in)."""
    _check_family(cfg)
    _no_moe_prefill(cfg, "decode_step")
    x = L.embed(tokens, params["embed"])
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    if pos.dim() != 0:
        raise NotImplementedError("per-row start positions need the paged prefill "
                                  "(paged_prefill_step); a contiguous chunk shares one")
    positions = pos + torch.arange(x.shape[1], device=x.device)
    cos, sin = _rope_for(cfg, positions)
    return _cached_forward(params, cache, x, pos, cos, sin, cfg, "prefill",
                           slot_mask=slot_mask, impl=impl)


# --------------------------------------------------------------------------
# paged KV pool (continuous batching)
# --------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *, num_pages: int,
                     page_size: int,
                     device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """Paged decode state: one flat page pool per layer plus one page
    table shared by every layer (a logical page holds all layers' K/V of
    its token block, so the allocator hands out one index per block).

    Page 0 is the reserved trash page (see ``core/paging.py``): a
    zero-filled table points every slot there, masked and pad writes
    land there, and the length masks keep it out of the softmax.
    """
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} not a multiple of page_size {page_size}")
    device = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k_pages": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "v_pages": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "page_table": torch.zeros((batch, max_len // page_size), dtype=torch.int32,
                                  device=device),
    }


def _paged_cached_forward(
    params: Params,
    cache: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D) embedded inputs
    pos: torch.Tensor,  # integer write position, 0-d or per-row (B,)
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: ModelConfig,
    mode: str,
    slot_mask: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`_cached_forward` against the paged KV pool.  The page table
    is read-only inside the model (allocation is host-side, in the serve
    layer); the slot mask rides inside the body."""
    B = x.shape[0]
    mask = (torch.ones((B,), dtype=torch.bool, device=x.device) if slot_mask is None
            else slot_mask.to(torch.bool))
    pt = cache["page_table"]
    kp, vp = cache["k_pages"], cache["v_pages"]
    blocks = params["blocks"]
    body = _body_fn(cfg, mode, (blocks[0], x, kp[0], vp[0], pt, pos, mask, cos, sin), impl)
    ks, vs = [], []
    for i, p_layer in enumerate(blocks):
        x, nk, nv = body(p_layer, x, kp[i], vp[i], pt, pos, mask, cos, sin)
        ks.append(nk)
        vs.append(nv)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    logits = L.lm_head(x, params.get("lm_head", params["embed"]),
                       transpose=cfg.tie_embeddings)
    return logits, {"k_pages": torch.stack(ks), "v_pages": torch.stack(vs),
                    "page_table": pt}


def paged_decode_step(
    params: Params,
    cache: Dict[str, torch.Tensor],
    token: torch.Tensor,  # (B, 1) int
    pos: Union[int, torch.Tensor],  # write position — scalar or per-row (B,)
    cfg: ModelConfig,
    *,
    slot_mask: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`decode_step` against the paged KV pool: the same logits,
    bitwise, on active rows with ``cfg.kv_kernel == "ref"``."""
    _check_family(cfg)
    x = _embed_or(token, embeds, params)
    pos = torch.as_tensor(pos, device=x.device)
    cos, sin = _rope_for(cfg, L.decode_positions(pos), mrope_positions)
    return _paged_cached_forward(params, cache, x, pos, cos, sin, cfg, "paged_decode",
                                 slot_mask=slot_mask, impl=impl)


def paged_prefill_step(
    params: Params,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,  # (B, S) int — a whole (padded) prompt block
    pos: Union[int, torch.Tensor],  # first write position — scalar or per-row (B,)
    cfg: ModelConfig,
    *,
    slot_mask: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-prompt prefill into the paged KV pool: one forward pass
    writes the S-token block at ``[pos, pos + S)`` of every masked row,
    causal within the chunk.  A per-row ``pos`` anchors each row's chunk
    at its own start: a row whose leading pages came from the prefix
    tree prefills only its suffix, in the same dispatch as rows starting
    from zero.  Returns the (B, S, vocab) logits and the new pools."""
    _check_family(cfg)
    _no_moe_prefill(cfg, "paged_decode_step")
    x = L.embed(tokens, params["embed"])
    pos = torch.as_tensor(pos, device=x.device)
    offs = torch.arange(x.shape[1], device=x.device)
    positions = pos[:, None] + offs if pos.dim() == 1 else pos + offs
    cos, sin = _rope_for(cfg, positions)
    return _paged_cached_forward(params, cache, x, pos, cos, sin, cfg, "paged_prefill",
                                 slot_mask=slot_mask, impl=impl)
