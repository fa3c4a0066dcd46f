"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local
attention blocks in a (rec, rec, attn) pattern — the port of the JAX
package's ``models/rglru.py``.

The recurrent block (Griffin §2):

    x̃ = conv1d_w4(Wx·x);  gates i, r = σ(Wi·x), σ(Wr·x)
    a_t = exp(-c · softplus(Λ) · r_t)           (log-space decay)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x̃_t)
    out = Wo·(gelu(Wy·x) ⊙ h)

The linear recurrence dispatches through ``_rg_lru_fused`` to
:func:`repro_torch.kernels.ops.rg_lru`, the custom op
``repro_torch::rg_lru``: Phase-1 capture keeps it as one node and Phase 3
routes it to the accelerator, where it launches the hand-written CUDA
scan (``kernels/csrc/rg_lru.cu``).

Local attention blocks use a banded causal mask (window 2048); the
attention-fusion pass fuses them with the predicate kept as a fused-node
operand, so they take the plain masked-softmax path.  The heterogeneous
layer pattern means layers run in a Python loop over per-layer dicts.

Entry points (the JAX module's):

* ``init(cfg, generator, device)``, ``apply(params, tokens, cfg)`` — one
  Forge-compiled body per block kind;
* ``init_cache(cfg, batch, max_len, device)`` — per layer, a rotating
  ``min(window, max_len)``-slot KV window or an O(1) ``{h, conv}`` state;
* ``decode_step`` — one token, scalar or per-row ``pos``, ``slot_mask``;
* ``prefill_step`` — the chunked state-scan prefill: the whole prompt in
  one dispatch, per-row ``length``.

Decode and prefill run raw (no per-block Forge body), as in the JAX
package: the serve fronts capture the whole step.  Every entry point that
creates tensors runs on the CUDA device unless the caller passes
``device="cpu"``; the others follow their inputs' device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distrib.actsharding import constrain
from ..kernels import ops
from . import attention as A
from . import layers as L
from ._forge import config_key, forge_body

Params = Dict[str, Any]

#: the {h, conv} recurrent states fold every past token in — a slot
#: swap-in must reset the row to init_cache values (ModelAPI contract)
STATEFUL_DECODE = True

#: chunked prefill consumes EVERY token into recurrent state (unlike KV
#: caches, where pad columns are masked positionally afterwards), so the
#: serve fronts pass a per-row ``length`` to bound the scan per row
PREFILL_TAKES_LENGTH = True


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """Every rglru config prefills through the chunked state scan."""
    return True


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _rg_lru_fused(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                  impl: Optional[str]) -> torch.Tensor:
    """The one opaque dispatch unit of the whole recurrence."""
    return ops.rg_lru(x, a, h0, impl=impl)


def rec_block_init(generator: Optional[torch.Generator], cfg: ModelConfig,
                   device: torch.device) -> Params:
    d = cfg.d_model
    lru = cfg.lru_dim or d
    dt = _dtype(cfg)
    return {
        "norm": L.norm_init(d, cfg.norm, device=device),
        "wx": L.dense_init(generator, d, lru, dt, device),
        "wy": L.dense_init(generator, d, lru, dt, device),
        "wi": L.dense_init(generator, d, lru, dt, device),
        "wr": L.dense_init(generator, d, lru, dt, device),
        "wo": L.dense_init(generator, lru, d, dt, device),
        "conv": (torch.randn((cfg.conv_width, lru), generator=generator, device=device)
                 * 0.1).to(dt),
        "lam": torch.linspace(0.9, 0.999, lru, device=device, dtype=torch.float32),
    }


def _decay(p: Params, r: torch.Tensor, c: float = 8.0) -> torch.Tensor:
    log_a = -c * F.softplus(p["lam"].float()) * r.float()
    return torch.exp(log_a)


def _gated(a: torch.Tensor, i: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """√(1 − a²) ⊙ (i ⊙ x̃): the gate product in the model dtype, then f32."""
    return torch.sqrt(torch.clamp(1.0 - a * a, min=1e-6)) * (i * xt).float()


def rec_block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    impl: Optional[str] = None) -> torch.Tensor:
    h = L.apply_norm(x, p["norm"], cfg.norm)
    xt = L.linear(h, p["wx"])
    xt = L.causal_conv1d(xt, p["conv"])
    i = torch.sigmoid(L.linear(h, p["wi"]))
    r = torch.sigmoid(L.linear(h, p["wr"]))
    a = _decay(p, r)
    gated = _gated(a, i, xt)
    h0 = torch.zeros((x.shape[0], xt.shape[-1]), dtype=torch.float32, device=x.device)
    hseq = _rg_lru_fused(gated, a, h0, impl)
    y = F.gelu(L.linear(h, p["wy"]), approximate="tanh").float() * hseq
    return x + L.linear(y.to(x.dtype), p["wo"])


def rec_block_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                     cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent step with O(1) state {h, conv}."""
    h = L.apply_norm(x, p["norm"], cfg.norm)  # (B, 1, d)
    xt = L.linear(h, p["wx"])  # (B, 1, lru)
    conv_state = state["conv"]  # (B, W-1, lru)
    xt_conv = L.causal_conv1d(xt, p["conv"], state=conv_state)
    new_conv = torch.cat([conv_state, xt], dim=1)[:, 1:]
    i = torch.sigmoid(L.linear(h, p["wi"]))
    r = torch.sigmoid(L.linear(h, p["wr"]))
    a = _decay(p, r)[:, 0]  # (B, lru)
    gated = _gated(a, i[:, 0], xt_conv[:, 0])
    h_new = a * state["h"] + gated  # (B, lru)
    y = F.gelu(L.linear(h, p["wy"]), approximate="tanh").float() * h_new[:, None]
    out = x + L.linear(y.to(x.dtype), p["wo"])
    return out, {"h": h_new, "conv": new_conv}


def rec_block_prefill(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                      length: torch.Tensor, cfg: ModelConfig, impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-chunk recurrent block: one scan replaces S sequential
    decode steps.

    The RG-LRU recurrence is affine in the state, so the chunk's state
    sequence starts from each row's incoming ``h`` (the kernel folds it
    in as its carry).  The post-chunk state is gathered at each row's OWN
    last real token (``length - 1``): rows padded past their prompt keep
    scanning garbage, but it never reaches their stored state or their
    real columns' outputs.
    """
    h = L.apply_norm(x, p["norm"], cfg.norm)
    xt = L.linear(h, p["wx"])  # (B, S, lru) — raw conv inputs
    xt_conv = L.causal_conv1d(xt, p["conv"], state=state["conv"])
    new_conv = L.conv_state_slice(state["conv"], xt, length)
    i = torch.sigmoid(L.linear(h, p["wi"]))
    r = torch.sigmoid(L.linear(h, p["wr"]))
    a = _decay(p, r)
    gated = _gated(a, i, xt_conv)
    hseq = _rg_lru_fused(gated, a, state["h"], impl)
    h_new = L.gather_last_valid(hseq, length)
    y = F.gelu(L.linear(h, p["wy"]), approximate="tanh").float() * hseq
    out = x + L.linear(y.to(x.dtype), p["wo"])
    return out, {"h": h_new, "conv": new_conv}


def _window_chunk_attn(h: torch.Tensor, p: Params, st: Dict[str, torch.Tensor],
                       pos_b: torch.Tensor, length: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor, window: int, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked prefill through the ROTATING local-attention window.

    Mirrors :func:`attention.attention`'s projection chain, but attends
    over the concatenation ``[window cache slots ; chunk keys]`` under
    :func:`layers.window_chunk_mask` (which encodes which slots would
    still be live at each in-chunk decode step), then writes back only
    the chunk's final occupant of each slot
    (:func:`layers.window_writeback_index`) — per-row start positions
    AND per-row lengths, so one dispatch serves ragged continuation
    prefills.
    """
    B, S, _ = h.shape
    q = A._split_heads(L.linear(h, p["wq"], p.get("bq")), cfg.n_heads)
    k = A._split_heads(L.linear(h, p["wk"], p.get("bk")), cfg.n_kv_heads)
    v = A._split_heads(L.linear(h, p["wv"], p.get("bv")), cfg.n_kv_heads)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    slots = st["k"].shape[2]
    kk = torch.cat([st["k"], k], dim=2)
    vv = torch.cat([st["v"], v], dim=2)
    mask = L.window_chunk_mask(pos_b, S, slots, window)
    out = A.sdpa_unfused(q, kk, vv, causal=False, extra_mask=mask)
    out = L.linear(A._merge_heads(out), p["wo"])
    idx, valid = L.window_writeback_index(pos_b, length, S, slots, window)
    gidx = idx[:, None, :, None].expand(B, k.shape[1], slots, k.shape[3])
    gk = torch.gather(k, 2, gidx)
    gv = torch.gather(v, 2, gidx)
    vm = valid[:, None, :, None]
    return constrain(out, "tokens"), {"k": torch.where(vm, gk, st["k"]),
                                      "v": torch.where(vm, gv, st["v"])}


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------


def _pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    return tuple(pat[i % len(pat)] for i in range(cfg.n_layers))


def attn_block_init(generator: Optional[torch.Generator], cfg: ModelConfig,
                    device: torch.device) -> Params:
    dt = _dtype(cfg)
    return {
        "norm1": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "attn": A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim_, dtype=dt, device=device),
        "norm2": L.norm_init(cfg.d_model, cfg.norm, device=device),
        "ffn": L.ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.ffn, dtype=dt,
                          device=device),
    }


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device] = "cuda") -> Params:
    """Random parameters with the JAX package's distributions.

    ``generator`` must live on ``device``.  Tied configs store ONE
    embedding tensor, read again by the LM head."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    blocks = []
    for kind in _pattern(cfg):
        if kind == "attn":
            blocks.append(attn_block_init(generator, cfg, device))
        else:
            p = rec_block_init(generator, cfg, device)
            if cfg.d_ff:
                p["ffn"] = L.ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.ffn, dtype=dt,
                                      device=device)
                p["norm2"] = L.norm_init(cfg.d_model, cfg.norm, device=device)
            blocks.append(p)
    params: Params = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device),
        "blocks": blocks,
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab, dt, device)
    return params


def _attn_block_apply(p: Params, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    a_out, _ = A.attention(
        h, p["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        rope_cos=cos, rope_sin=sin, causal=True, window=cfg.window,
    )
    x = x + a_out
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + L.apply_ffn(h, p["ffn"], cfg.ffn)


def _rec_full_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    impl: Optional[str] = None) -> torch.Tensor:
    x = rec_block_apply(p, x, cfg, impl)
    if cfg.d_ff:
        h = L.apply_norm(x, p["norm2"], cfg.norm)
        x = x + L.apply_ffn(h, p["ffn"], cfg.ffn)
    return x


def _lm_head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return L.lm_head(x, params.get("lm_head", params["embed"]), transpose=cfg.tie_embeddings)


def apply(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
          impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence forward: (B, S) tokens → (B, S, vocab) fp32 logits,
    one Forge-compiled body per block kind (shapes are identical across
    the layers of a kind) when ``cfg.fuse == 'forge'``."""
    x = L.embed(tokens, params["embed"])
    B, S, _ = x.shape
    cos, sin = L.rope_tables(torch.arange(S, device=x.device), cfg.head_dim_,
                             cfg.rope_theta)
    enabled = cfg.fuse == "forge"
    bodies = {}
    for p, kind in zip(params["blocks"], _pattern(cfg)):
        if kind not in bodies:
            # the whole config keys the body (see transformer._body_fn)
            if kind == "attn":
                bodies[kind] = forge_body(
                    lambda q, x_, c, s: _attn_block_apply(q, x_, c, s, cfg),
                    f"{config_key(cfg)}/attn", (p, x, cos, sin), enabled=enabled, impl=impl,
                    remat=cfg.remat)
            else:
                bodies[kind] = forge_body(
                    lambda q, x_: _rec_full_apply(q, x_, cfg, impl),
                    f"{config_key(cfg)}/rec", (p, x), enabled=enabled, impl=impl,
                    remat=cfg.remat)
        x = bodies[kind](p, x, cos, sin) if kind == "attn" else bodies[kind](p, x)
    return _lm_head(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Per-layer state: KV (bounded by window) for attn, {h, conv} for rec."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    lru = cfg.lru_dim or cfg.d_model
    window = min(cfg.window or max_len, max_len)
    caches = []
    for kind in _pattern(cfg):
        if kind == "attn":
            caches.append(A.make_cache(batch, cfg.n_kv_heads, window, cfg.head_dim_, dt,
                                       device))
        else:
            caches.append({
                "h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, lru), dtype=dt,
                                    device=device),
            })
    return {"layers": caches}


def _window(cfg: ModelConfig, cache: Dict[str, Any]) -> int:
    """The rotation period: the configured window, else the slot count of
    the attention caches."""
    return cfg.window or next(st["k"].shape[2] for st in cache["layers"] if "k" in st)


def decode_step(
    params: Params,
    cache: Dict[str, Any],
    token: torch.Tensor,  # (B, 1) int
    pos: Union[int, torch.Tensor],  # scalar or per-row (B,)
    cfg: ModelConfig,
    *,
    slot_mask: Optional[torch.Tensor] = None,  # bool (B,): active slots
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode.  ``pos`` may be a per-row vector: each batch
    row then rotates RoPE, writes its window slot, and masks validity at
    its OWN position (slot-level continuous batching).  ``slot_mask``
    freezes inactive rows' state — both the rotating KV windows and the
    O(1) recurrent states keep their previous values bitwise.  The step
    makes no RG-LRU scan (one token is one FMA per channel), so ``impl``
    reaches no kernel here; it is kept for the common step signature."""
    x = L.embed(token, params["embed"])
    pos = torch.as_tensor(pos, device=x.device)
    cos, sin = L.rope_tables(L.decode_positions(pos), cfg.head_dim_, cfg.rope_theta)
    window = _window(cfg, cache)
    new_layers = []
    for p, kind, st in zip(params["blocks"], _pattern(cfg), cache["layers"]):
        if kind == "attn":
            h = L.apply_norm(x, p["norm1"], cfg.norm)
            # rotating local window: write slot = pos % window (per row
            # when pos is a vector)
            slot = torch.remainder(pos, window)
            valid = torch.clamp(pos + 1, max=window)
            a_out, new_st = A.attention(
                h, p["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                rope_cos=cos, rope_sin=sin, cache=st, cache_pos=slot,
                cache_valid_len=valid,
            )
            x = x + a_out
            h = L.apply_norm(x, p["norm2"], cfg.norm)
            x = x + L.apply_ffn(h, p["ffn"], cfg.ffn)
        else:
            x, new_st = rec_block_decode(p, x, st, cfg)
            if cfg.d_ff:
                h = L.apply_norm(x, p["norm2"], cfg.norm)
                x = x + L.apply_ffn(h, p["ffn"], cfg.ffn)
        new_layers.append(L.slot_gate(slot_mask, new_st, st))
    return _lm_head(params, x, cfg), {"layers": new_layers}


def prefill_step(
    params: Params,
    cache: Dict[str, Any],
    tokens: torch.Tensor,  # (B, S) whole prompt chunk
    pos: Union[int, torch.Tensor],  # scalar or per-row (B,) chunk start position
    cfg: ModelConfig,
    *,
    slot_mask: Optional[torch.Tensor] = None,  # bool (B,): admitted slots
    length: Optional[torch.Tensor] = None,  # int (B,): real tokens per row
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Chunked state-scan prefill: the whole prompt in ONE dispatch.

    S sequential decode steps collapse into one program — the RG-LRU
    recurrence runs as one scan from each row's incoming state (the
    ``rg_lru`` kernel on the card), the rotating attention windows are
    rebuilt from the chunk's final slot occupants, and conv states slide
    to each row's last real token.  ``length`` bounds the scan per row
    (defaults to the full chunk): recurrent state consumes every token it
    sees, so pad columns must be excluded by index, not by a positional
    mask.  ``slot_mask`` keeps unadmitted rows' state bitwise untouched
    (NaN-inert select).  Chunked ≡ sequential within float32 scan
    reassociation.
    """
    B, S = tokens.shape
    x = L.embed(tokens, params["embed"])
    pos = torch.as_tensor(pos, device=x.device)
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    if length is None:
        length = torch.full((B,), S, dtype=torch.int64, device=x.device)
    positions = pos_b[:, None] + torch.arange(S, device=x.device)[None, :]
    cos, sin = L.rope_tables(positions, cfg.head_dim_, cfg.rope_theta)
    window = _window(cfg, cache)
    new_layers = []
    for p, kind, st in zip(params["blocks"], _pattern(cfg), cache["layers"]):
        if kind == "attn":
            h = L.apply_norm(x, p["norm1"], cfg.norm)
            a_out, new_st = _window_chunk_attn(h, p["attn"], st, pos_b, length, cos, sin,
                                               window, cfg)
            x = x + a_out
            h = L.apply_norm(x, p["norm2"], cfg.norm)
            x = x + L.apply_ffn(h, p["ffn"], cfg.ffn)
        else:
            x, new_st = rec_block_prefill(p, x, st, length, cfg, impl)
            if cfg.d_ff:
                h = L.apply_norm(x, p["norm2"], cfg.norm)
                x = x + L.apply_ffn(h, p["ffn"], cfg.ffn)
        new_layers.append(L.slot_gate(slot_mask, new_st, st))
    return _lm_head(params, x, cfg), {"layers": new_layers}
