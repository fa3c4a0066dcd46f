"""Model building blocks, written UNFUSED on purpose.

Every layer here is plain ATen ops (no ``F.scaled_dot_product_attention``,
no ``F.linear`` with fused bias, no pre-fused kernels) so that Phase 2 of
the Forge pipeline finds the decomposed chains the paper's passes match:
attention exports as matmul→scale→where→softmax→matmul, FFNs as
matmul→add→gelu.

Conventions (those of the JAX package):

* params are plain nested dicts of tensors,
* activations in the config dtype, norms computed in fp32,
* the causal mask uses the canonical ``row ≥ col`` ``arange`` pattern
  the attention-fusion matcher recognizes,
* integer positions are tensors, so a captured block body reads them at
  run time instead of freezing the capture-time value.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from ..distrib.actsharding import constrain, fsdp_gathered, settled

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# initializers (the JAX package's distributions; a torch.Generator cannot
# reproduce jax.random's numbers, so parity tests load the JAX parameters)
# --------------------------------------------------------------------------


def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=generator, device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(generator: Optional[torch.Generator], vocab: int, d: int,
               dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    return (torch.randn((vocab, d), generator=generator, device=device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms (computed in fp32, cast back)
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Params, kind: str = "rmsnorm") -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32, device="cpu") -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# --------------------------------------------------------------------------
# linear / embedding
# --------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x·w (+ b) in x's dtype (fp32 accumulation inside the product)."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + (b if b.dtype == x.dtype else b.to(x.dtype))
    return y


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.  A sharding plan's DTensor
    table is FSDP-gathered first, and a vocab-sharded one leaves a masked
    pending sum, reduced here (``settled``): its state is the lookup's and
    cannot be reduced twice."""
    return settled(F.embedding(tokens, fsdp_gathered(table)))


def lm_head(x: torch.Tensor, table_or_w: torch.Tensor, *, transpose: bool) -> torch.Tensor:
    """Project to vocab; fp32 logits.  ``transpose=True`` -> tied
    embedding (vocab, d), read through a transposed view (one tensor).
    A planned call's pending sum (a MoE block's combine) is reduced
    first, never scattered over the sequence (``settled``)."""
    x = settled(x)
    table_or_w = fsdp_gathered(table_or_w)
    w = table_or_w.t() if transpose else table_or_w
    # keep logits vocab-sharded through the loss under a policy
    return constrain(torch.matmul(x, w).float(), "logits")


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions: (..., S) -> (..., S, head_dim/2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_tables(positions: torch.Tensor, head_dim: int, sections: Tuple[int, int, int],
                 theta: float = 1_000_000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE: positions (3, B, S) of the temporal,
    height and width streams; the head_dim/2 frequency slots split into
    ``sections``, each rotated by its own stream -> (B, S, head_dim/2)."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang_all = positions.float()[..., None] * freqs  # (3, B, S, half)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> (1, 1, S, half)
        cos, sin = cos[None, None], sin[None, None]
    elif cos.dim() == 3:  # (B, S, half) -> (B, 1, S, half)
        cos, sin = cos[:, None], sin[:, None]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1)


# --------------------------------------------------------------------------
# masks — canonical patterns the fusion matcher understands
# --------------------------------------------------------------------------


def causal_where(s: torch.Tensor, sq: int, sk: int) -> torch.Tensor:
    """Apply the canonical causal mask to scores ``s`` (..., sq, sk)."""
    row = torch.arange(sq, device=s.device).view(sq, 1) + (sk - sq)
    col = torch.arange(sk, device=s.device).view(1, sk)
    return torch.where(row >= col, s, torch.finfo(s.dtype).min)


def local_causal_where(s: torch.Tensor, sq: int, sk: int, window: int) -> torch.Tensor:
    """Banded causal mask (RecurrentGemma local attention): query row i
    (aligned at ``sk - sq``) sees keys ``row - window < col <= row``."""
    row = torch.arange(sq, device=s.device).view(sq, 1) + (sk - sq)
    col = torch.arange(sk, device=s.device).view(1, sk)
    keep = (row >= col) & (row - col < window)
    return torch.where(keep, s, torch.finfo(s.dtype).min)


def decode_positions(pos: torch.Tensor) -> torch.Tensor:
    """RoPE position stream for one decode step: scalar -> (1,) shared
    across rows; per-row (B,) -> (B, 1) so row b rotates by its own
    position (ragged slot decode)."""
    if pos.dim() == 0:
        return pos[None]
    if pos.dim() == 1:
        return pos[:, None]
    return pos


def per_row_pos(pos: torch.Tensor) -> torch.Tensor:
    """Broadcast a cache position against (B, H, sq, max_len) scores:
    a scalar passes through, a per-row (B,) vector becomes (B, 1, 1, 1)."""
    return pos.view(-1, 1, 1, 1) if pos.dim() == 1 else pos


def decode_length_mask(pos: torch.Tensor, max_len: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Additive mask: 0 for idx <= pos else the dtype's minimum.

    ``pos`` scalar -> (1, 1, 1, max_len); ``pos`` (B,) -> (B, 1, 1, max_len).
    """
    idx = torch.arange(max_len, device=pos.device).view(1, 1, 1, max_len)
    return torch.where(idx <= per_row_pos(pos), 0.0,
                       torch.finfo(dtype).min).to(dtype)


def window_decode_mask(pos: torch.Tensor, max_len: int, window: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Additive sliding-window mask for one decode step: 0 for
    ``pos - window < idx <= pos`` else the dtype's minimum; scalar or
    per-row ``pos`` as in :func:`decode_length_mask`."""
    idx = torch.arange(max_len, device=pos.device).view(1, 1, 1, max_len)
    p = per_row_pos(pos)
    keep = (idx <= p) & (idx > p - window)
    return torch.where(keep, 0.0, torch.finfo(dtype).min).to(dtype)


def prefill_length_mask(pos: torch.Tensor, sq: int, max_len: int,
                        window: Optional[int] = None,
                        dtype=torch.float32) -> torch.Tensor:
    """Causal length mask (1|B, 1, sq, max_len) for chunked prefill.

    Query row i sits at cache position ``pos + i`` and sees keys
    ``idx <= pos + i`` (with ``window``, also ``idx > pos + i - window``)
    — causal *within* the chunk, so a whole prompt block is written
    through the cache path in one forward pass.  ``pos`` may be per-row
    (B,): each row then anchors its chunk at its own start position.
    Reduces to :func:`decode_length_mask` at ``sq == 1``.
    """
    idx = torch.arange(max_len, device=pos.device).view(1, 1, 1, max_len)
    qpos = per_row_pos(pos) + torch.arange(sq, device=pos.device).view(1, 1, sq, 1)
    keep = idx <= qpos
    if window is not None:
        keep = keep & (idx > qpos - window)
    return torch.where(keep, 0.0, torch.finfo(dtype).min).to(dtype)


def window_chunk_mask(pos: torch.Tensor, sq: int, slots: int, window: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Additive mask for chunked prefill over a ROTATING window cache.

    The key axis is ``[slots rotating-cache entries ; sq chunk keys]``.
    Cache slot s holds the key of absolute position
    ``pos - 1 - ((pos - 1 - s) mod window)`` — the latest pre-chunk
    position congruent to s — and is live only while that position is
    >= 0 (the slot was ever written) AND inside query i's band
    (``> pos + i - window``; beyond it the slot would already have been
    overwritten by the time sequential decode reached ``pos + i``).
    Chunk key j (absolute position pos + j) follows the plain banded
    causal rule.  ``pos`` is per-row (B,); returns (B, 1, sq,
    slots + sq) — attending over the concatenated keys with this mask
    reproduces sequential rotating-window decode exactly.
    """
    p = pos.view(-1, 1, 1, 1)
    i = torch.arange(sq, device=pos.device).view(1, 1, sq, 1)
    s = torch.arange(slots, device=pos.device).view(1, 1, 1, slots)
    cs = p - 1 - torch.remainder(p - 1 - s, window)  # slot s's absolute position
    keep_cache = (cs >= 0) & (cs > p + i - window)
    j = torch.arange(sq, device=pos.device).view(1, 1, 1, sq)
    keep_chunk = (j <= i) & (j > i - window)
    B = p.shape[0]
    keep = torch.cat([keep_cache.expand(B, 1, sq, slots),
                      keep_chunk.expand(B, 1, sq, sq)], dim=3)
    return torch.where(keep, 0.0, torch.finfo(dtype).min).to(dtype)


def window_writeback_index(pos: torch.Tensor, length: torch.Tensor, sq: int,
                           slots: int, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which chunk column lands in each rotating-cache slot after prefill.

    After sequential decode of chunk positions ``pos .. pos+length-1``,
    slot s holds the chunk's LAST write to it: chunk index
    ``length - 1 - ((pos + length - 1 - s) mod window)``, or its
    previous contents when that index is negative (the chunk never
    reached the slot).  ``pos``/``length`` are per-row (B,).  Returns
    ``(idx, valid)``: idx (B, slots) int64 clipped into [0, sq-1] (safe
    to gather with), valid (B, slots) bool — False slots must keep
    their old value.
    """
    p = pos.long()[:, None]
    n = length.long()[:, None]
    s = torch.arange(slots, device=pos.device)[None, :]
    idx = n - 1 - torch.remainder(p + n - 1 - s, window)
    return torch.clamp(idx, 0, sq - 1), idx >= 0


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time.  x: (B, T, D); w: (W, D);
    ``state``: (B, W-1, D) trailing inputs from before ``x`` (zeros when
    None).  The W taps accumulate in x's dtype, in tap order."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return out


def gather_last_valid(x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Per-row element at time index ``length - 1``: (B, S, ...) -> (B, ...).

    The chunked-prefill state extractor: row b's post-prefill recurrent
    state is the scan output at its OWN last real token, not at the
    padded chunk tail.
    """
    idx = (length.long() - 1).view((-1,) + (1,) * (x.dim() - 1))
    return torch.gather(x, 1, idx.expand((x.shape[0], 1) + tuple(x.shape[2:])))[:, 0]


def conv_state_slice(state: torch.Tensor, seq: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """Trailing causal-conv inputs after consuming ``length`` chunk tokens.

    ``state``: (B, W-1, D) pre-chunk conv state (the W-1 inputs before
    position ``pos``); ``seq``: (B, S, D) the chunk's raw conv inputs.
    Returns (B, W-1, D) — per-row inputs ``length-W+1 .. length-1`` of
    the concatenated stream, exactly the state sequential decode leaves
    behind after its ``length``-th token.
    """
    full = torch.cat([state, seq], dim=1)
    cw = state.shape[1]
    idx = length.long()[:, None] + torch.arange(cw, device=state.device)[None, :]
    return torch.gather(full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))


def slot_gate(slot_mask: Optional[torch.Tensor], new: Any, old: Any) -> Any:
    """Per-row select between updated and previous decode state.

    ``slot_mask: bool[B]`` gates every tensor leaf (batch axis 0) of a
    state update — one tensor or a tree of them, e.g. a layer's
    ``{h, conv}`` or ``{k, v}`` dict: active rows take the new value,
    inactive rows keep the old one **bitwise** — a ``torch.where``
    select, not a multiply, so an inactive slot stays inert even when its
    inputs are NaN.  ``None`` passes the update through.
    """
    if slot_mask is None:
        return new

    def blend(n: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        m = slot_mask.view(slot_mask.shape + (1,) * (n.dim() - 1))
        return torch.where(m, n, o)

    return pytree.tree_map(blend, new, old)


# --------------------------------------------------------------------------
# FFN (unfused: the operator-fusion pass matches it)
# --------------------------------------------------------------------------


def swiglu_ffn(x: torch.Tensor, p: Params) -> torch.Tensor:
    g = linear(x, p["w_gate"])
    u = linear(x, p["w_up"])
    h = F.silu(g) * u
    return linear(h, p["w_down"])


def geglu_ffn(x: torch.Tensor, p: Params) -> torch.Tensor:
    g = linear(x, p["w_gate"])
    u = linear(x, p["w_up"])
    h = F.gelu(g, approximate="tanh") * u
    return linear(h, p["w_down"])


def gelu_ffn(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = F.gelu(linear(x, p["w_fc"], p.get("b_fc")), approximate="tanh")
    return linear(h, p["w_out"], p.get("b_out"))


def ffn_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             kind: str = "swiglu", bias: bool = False, dtype=torch.bfloat16,
             device="cpu") -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, d_model, d_ff, dtype, device),
            "w_up": dense_init(generator, d_model, d_ff, dtype, device),
            "w_down": dense_init(generator, d_ff, d_model, dtype, device),
        }
    p = {
        "w_fc": dense_init(generator, d_model, d_ff, dtype, device),
        "w_out": dense_init(generator, d_ff, d_model, dtype, device),
    }
    if bias:
        p["b_fc"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def apply_ffn(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    """The dense FFN of ``kind``.  A pending sum reaching it (the residual
    after a body's attention, which the compiled body's fused product
    settles) is settled first, so that a planned body's capture takes the
    compiled body's layouts (plain tensors pass)."""
    x = settled(x)
    if kind == "swiglu":
        return swiglu_ffn(x, p)
    if kind == "geglu":
        return geglu_ffn(x, p)
    return gelu_ffn(x, p)
