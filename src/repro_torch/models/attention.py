"""Multi-head / grouped-query attention, written unfused.

The decomposed chain below (projections → RoPE → GQA expansion → matmul
→ scale → where/additive mask → softmax → matmul → out-proj) is exactly
what the Forge attention-fusion pass matches; after Phase 2 the middle
collapses into one ``forge.sdpa`` dispatch.

Carries the no-cache branch (full self-attention, causal or not: the
full-sequence forward, optionally banded to a local window, and
cross-attention to a ``kv`` source), the
contiguous-cache branch (single-token decode at a scalar or per-row
position, optionally windowed, or over a rotating window buffer masked
by ``cache_valid_len``), whole-chunk prefill into the contiguous cache
at a scalar start position, and the paged-cache branch (decode and chunked
prefill against a flat page pool through a per-row page table,
:func:`_paged_update_attend`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..distrib.actsharding import (constrain, head_layout, kv_heads_like, merged_heads,
                                   settled, shard_count, split_heads)
from ..kernels import ops
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
    """(B, S, n·D) -> (B, n, S, D), a planned call's heads gathered."""
    return split_heads(x, n_heads, keep=False)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, D = x.shape
    return merged_heads(x.transpose(1, 2).reshape(B, S, H * D))


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
    window: Optional[int] = None,
    extra_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decomposed attention: the fusion pass's input pattern.

    Scores and softmax in fp32, probabilities cast to v's dtype for the
    second product, as the JAX package's ``sdpa_unfused`` does.  A
    ``window`` bands the causal mask (:func:`layers.local_causal_where`),
    which the fusion pass keeps as a mask operand."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    groups = H // KVH
    k = _expand_kv(k, groups)
    v = _expand_kv(v, groups)
    s = torch.matmul(q.float(), k.float().transpose(-2, -1))
    s = s * (1.0 / math.sqrt(D))
    if window is not None:
        s = L.local_causal_where(s, Sq, Sk, window)
    elif causal:
        s = L.causal_where(s, Sq, Sk)
    if extra_mask is not None:
        s = s + (extra_mask if extra_mask.dtype == s.dtype else extra_mask.to(s.dtype))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _paged_update_attend(
    q: torch.Tensor,  # (B, H, sq, D) post-RoPE queries
    k: torch.Tensor,  # (B, KVH, sq, D) post-RoPE keys of this step
    v: torch.Tensor,
    cache: Dict[str, torch.Tensor],  # k_pages / v_pages / page_table
    cache_pos: torch.Tensor,  # 0-d or per-row (B,) write position
    *,
    window: Optional[int],
    write_mask: Optional[torch.Tensor],  # bool (B,) — rows allowed to write
    kv_kernel: str,  # "ref" (gather + unfused sdpa) | "pallas" (the kernel)
    impl: Optional[str],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Paged-cache decode/prefill: scatter this step's K/V into the flat
    page pool through the page table, then attend over the row's pages.

    The write is a per-token scatter ``flat[table[b, pos//ps]*ps +
    pos%ps] = k``; rows outside ``write_mask`` (inactive slots) and
    positions past the table (prefill pad) go to the trash page 0, so the
    store needs no batch axis and no slot gate afterwards.  The scatter
    is out of place (``index_put``), as JAX's ``.at[].set`` is: a step
    returns new page pools.  Trash-routed writes may collide, and which
    one lands is unspecified; trash content is never unmasked.

    The "ref" attend gathers the row's pages back into the contiguous
    cache layout and takes the same masks and ``sdpa_unfused`` as the
    contiguous branch, so the paged path is bitwise the contiguous one on
    live rows.  "pallas" (the config value the JAX package uses) with one
    token per row calls the hand-written paged-attention kernel
    (:mod:`repro_torch.kernels.paged_attention`); ``impl="ref"`` makes
    that call take the kernel's plain version.
    """
    from ..kernels.paged_attention import paged_attention as _paged_kernel
    from ..kernels.ref import gather_pages

    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    pt = cache["page_table"]
    NP, ps, KVH, D = k_pages.shape
    B, MP = pt.shape
    max_len = MP * ps
    sq = q.shape[2]

    pos_row = cache_pos.expand(B) if cache_pos.dim() == 0 else cache_pos
    abs_pos = pos_row.long()[:, None] + torch.arange(sq, device=q.device)[None, :]
    page_idx = torch.clamp(abs_pos // ps, 0, MP - 1)
    slot = torch.gather(pt.long(), 1, page_idx) * ps + abs_pos % ps
    ok = abs_pos < max_len
    if write_mask is not None:
        ok = ok & write_mask[:, None]
    dest = torch.where(ok, slot, abs_pos % ps).reshape(-1)
    k_tok = k.transpose(1, 2).reshape(B * sq, KVH, D)
    v_tok = v.transpose(1, 2).reshape(B * sq, KVH, D)
    new_k = k_pages.reshape(NP * ps, KVH, D).index_put((dest,), k_tok).reshape(k_pages.shape)
    new_v = v_pages.reshape(NP * ps, KVH, D).index_put((dest,), v_tok).reshape(v_pages.shape)

    if kv_kernel == "pallas" and sq == 1:
        out = _paged_kernel(q[:, :, 0, :], new_k, new_v, pt, pos_row, window=window,
                            impl=impl)[:, :, None, :].to(v.dtype)
    else:
        # mirrors the contiguous cache branch exactly (same masks, same
        # sdpa, contiguous views): the bitwise-equality contract
        k_view = gather_pages(new_k, pt).contiguous()
        v_view = gather_pages(new_v, pt).contiguous()
        if sq > 1:
            mask = L.prefill_length_mask(cache_pos, sq, max_len, window=window)
        elif window is not None:
            mask = L.window_decode_mask(cache_pos, max_len, window)
        else:
            mask = L.decode_length_mask(cache_pos, max_len)
        out = sdpa_unfused(q, k_view, v_view, causal=False, extra_mask=mask)
    return out, {"k_pages": new_k, "v_pages": new_v}


def attention(
    x: torch.Tensor,
    p: Params,
    *,
    n_heads: int,
    n_kv_heads: int,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    kv: Optional[torch.Tensor] = None,  # cross-attention source
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,
    cache_valid_len: Optional[torch.Tensor] = None,
    write_mask: Optional[torch.Tensor] = None,
    kv_kernel: str = "ref",
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full attention sub-layer.  Returns (out, updated_cache).

    With a cache, the step's keys and values are written at
    ``cache_pos`` — a 0-d or per-row ``(B,)`` integer tensor — and the
    queries attend to every cache entry at or before their position
    (with ``window``, only the last ``window`` of them).  With
    ``cache_valid_len`` (0-d or per-row) the cache is a rotating window
    buffer instead: the write slot is ``cache_pos`` and the slots below
    ``cache_valid_len`` are live, whatever their order (softmax attention
    is permutation-invariant over keys, and RoPE was applied before the
    write).  A cache holding ``k_pages`` is paged: ``write_mask``,
    ``kv_kernel`` and ``impl`` apply to it (see
    :func:`_paged_update_attend`).  Without a cache, ``window`` bands the
    causal full-sequence attention.  With ``kv`` (B, Sk, d) the keys and
    values are projected from it instead of ``x`` (cross-attention) and
    only the queries rotate.
    """
    # a pending sum reaching a body's second attention (the residual
    # after its first, which the compiled body's fused product settles)
    # is settled here too, so that the capture's projections take the
    # placements the compiled body's do and the head layout read from
    # them is theirs (actsharding.settled; plain tensors pass)
    x, kv = settled((x, kv))
    src = kv if kv is not None else x
    q = L.linear(x, p["wq"], p.get("bq"))
    k = L.linear(src, p["wk"], p.get("bk"))
    v = L.linear(src, p["wv"], p.get("bv"))
    # a planned call's column-parallel projections keep their heads
    # sharded (tensor-parallel attention) where the shards divide them
    # and the attention is unmasked and cacheless; elsewhere the heads
    # are gathered (actsharding.head_layout)
    layout = (head_layout(shard_count(q, 2), n_heads, n_kv_heads)[0]
              if cache is None and window is None else "gathered")
    head_parallel = layout in ("heads", "kv_repeated")
    q = split_heads(q, n_heads, keep=head_parallel)
    k = split_heads(k, n_kv_heads, keep=layout == "heads")
    v = split_heads(v, n_kv_heads, keep=layout == "heads")
    # Megatron-style activation layout pins (distrib/actsharding.py; the
    # identity without a policy).  Decode keeps the inferred layouts, as
    # in the JAX package: pinning heads conflicts with the
    # sequence-sharded KV cache
    if cache is None:
        q = constrain(q, "heads")
        k = constrain(k, "kv")
        v = constrain(v, "kv")

    if rope_cos is not None:
        q = L.apply_rope(q, rope_cos, rope_sin)
        if kv is None:  # self-attention: the keys rotate too
            k = L.apply_rope(k, rope_cos, rope_sin)

    new_cache = None
    if cache is not None and "k_pages" in cache:
        if cache_valid_len is not None:
            raise NotImplementedError("rotating-buffer valid_len masks are a "
                                      "contiguous-cache feature; paged rows are "
                                      "length-masked through pos")
        out, new_cache = _paged_update_attend(
            q, k, v, cache, cache_pos, window=window, write_mask=write_mask,
            kv_kernel=kv_kernel, impl=impl,
        )
    elif cache is not None:
        # one-token decode or whole-chunk prefill: write at cache_pos,
        # attend to every key at or before the query's position.  A chunk
        # (sq > 1, the batched-prefill path) takes a causal length mask —
        # query i at cache position cache_pos + i sees keys <= cache_pos + i
        # — so one pass writes the whole prompt block with sequential-decode
        # semantics.  A per-row (B,) position writes and masks each row at
        # its own position (slot-level continuous batching, one token per
        # row); the write is a select against a position iota, so the
        # captured graph stays in plain ops.
        max_len = cache["k"].shape[2]
        sq = q.shape[2]
        if sq == 1:
            slot_idx = torch.arange(max_len, device=x.device).view(1, 1, max_len, 1)
            write = slot_idx == L.per_row_pos(cache_pos)
            k_cache = torch.where(write, k, cache["k"])
            v_cache = torch.where(write, v, cache["v"])
        else:
            if cache_pos.dim() != 0:
                raise NotImplementedError(
                    "per-row cache positions require single-token steps (chunked "
                    "prefill shares one scalar start position)")
            # the block lands at [pos, pos + sq), the start clamped so the
            # block fits, as JAX's dynamic_update_slice clamps it
            start = torch.clamp(cache_pos.long(), 0, max_len - sq)
            idx = start + torch.arange(sq, device=x.device)
            k_cache = cache["k"].index_copy(2, idx, k)
            v_cache = cache["v"].index_copy(2, idx, v)
        new_cache = {"k": k_cache, "v": v_cache}
        if cache_valid_len is not None:
            idx = torch.arange(max_len, device=x.device).view(1, 1, 1, max_len)
            mask = torch.where(idx < L.per_row_pos(cache_valid_len), 0.0,
                               torch.finfo(torch.float32).min)
        elif sq > 1:
            mask = L.prefill_length_mask(cache_pos, sq, max_len, window=window)
        elif window is not None:
            mask = L.window_decode_mask(cache_pos, max_len, window)
        else:
            mask = L.decode_length_mask(cache_pos, max_len)
        out = sdpa_unfused(q, k_cache, v_cache, causal=False, extra_mask=mask)
    elif head_parallel:
        # the flash op on each device's local heads (its sharding strategy,
        # distrib/sharding.py): DTensor's own products would flatten
        # (rows, heads) into a shard it cannot gather under fake tensors
        k, v = kv_heads_like(q, k), kv_heads_like(q, v)
        out = ops.sdpa(q, k, v, causal=causal, groups=q.shape[1] // k.shape[1], impl=impl)
    else:
        out = sdpa_unfused(q, k, v, causal=causal, window=window)
    out = L.linear(_merge_heads(out), p["wo"])
    return constrain(out, "tokens"), new_cache


def make_cache(batch: int, n_kv_heads: int, max_len: int, head_dim: int,
               dtype=torch.bfloat16, device="cpu") -> Dict[str, torch.Tensor]:
    shape = (batch, n_kv_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
