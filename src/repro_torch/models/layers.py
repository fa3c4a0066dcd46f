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


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Params, kind: str = "layernorm") -> torch.Tensor:
    if kind != "layernorm":
        raise NotImplementedError(f"norm {kind!r}: the port carries LayerNorm so far")
    return layer_norm(x, p["scale"], p["bias"])


def norm_init(d: int, kind: str = "layernorm", dtype=torch.float32, device="cpu") -> Params:
    if kind != "layernorm":
        raise NotImplementedError(f"norm {kind!r}: the port carries LayerNorm so far")
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


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
    return F.embedding(tokens, table)


def lm_head(x: torch.Tensor, table_or_w: torch.Tensor, *, transpose: bool) -> torch.Tensor:
    """Project to vocab; fp32 logits.  ``transpose=True`` -> tied
    embedding (vocab, d), read through a transposed view (one tensor)."""
    w = table_or_w.t() if transpose else table_or_w
    return torch.matmul(x, w).float()


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


def slot_gate(slot_mask: Optional[torch.Tensor], new: torch.Tensor,
              old: torch.Tensor) -> torch.Tensor:
    """Per-row select between updated and previous decode state.

    ``slot_mask: bool[B]`` gates a state update (batch axis 0): active
    rows take the new value, inactive rows keep the old one **bitwise** —
    a select, not a multiply, so an inactive slot stays inert even when
    its inputs are NaN.  ``None`` passes the update through.
    """
    if slot_mask is None:
        return new
    m = slot_mask.view(slot_mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


# --------------------------------------------------------------------------
# FFN (unfused: the operator-fusion pass matches it)
# --------------------------------------------------------------------------


def gelu_ffn(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = F.gelu(linear(x, p["w_fc"], p.get("b_fc")), approximate="tanh")
    return linear(h, p["w_out"], p.get("b_out"))


def ffn_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             kind: str = "gelu", bias: bool = False, dtype=torch.bfloat16,
             device="cpu") -> Params:
    if kind != "gelu":
        raise NotImplementedError(f"ffn {kind!r}: the port carries the GELU FFN so far")
    p = {
        "w_fc": dense_init(generator, d_model, d_ff, dtype, device),
        "w_out": dense_init(generator, d_ff, d_model, dtype, device),
    }
    if bias:
        p["b_fc"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def apply_ffn(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind != "gelu":
        raise NotImplementedError(f"ffn {kind!r}: the port carries the GELU FFN so far")
    return gelu_ffn(x, p)
