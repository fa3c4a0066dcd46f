"""xLSTM (arXiv:2405.04517): mLSTM + sLSTM blocks — the port of the JAX
package's ``models/xlstm.py``, function for function.

* **mLSTM** — matrix-memory cell.  The full-sequence forward uses the
  *parallel* quadratic form (stabilized exponential-gate scores with a
  log-decay matrix D), registered as the opaque dispatch unit
  ``forge_mlstm`` (:func:`~repro_torch.kernels.ops.forge_op`: one
  ``repro_torch.forge_mlstm.default`` node, routed to the accelerator, as
  the reference's ``forge.mlstm``).  Decode uses the O(1)-state
  *recurrent* form (C: hd×hd matrix memory, n: normalizer, m: log
  stabilizer); the chunked prefill evaluates every prefix state of a
  chunk at once through an associative scan (:func:`mlstm_chunk_scan`).
* **sLSTM** — scalar-memory cell with recurrent h-dependence, inherently
  sequential: its time loop is the opaque op ``forge_scan::slstm``
  (:func:`~repro_torch.kernels.ops.scan_op`), one node routed to the host
  as the reference's ``lax.scan`` is (one block every
  ``cfg.slstm_every``).

``d_ff = 0``: blocks carry their own up/down projections (inner dim
2·d_model); there is no separate FFN.  The norms are the plain
``layers.rms_norm``, as in the reference (``ops.rms_norm``, the fused
kernel, is reached by no model there either).  Cell states stay fp32
under a bf16 config; a fresh cell has ``m = -1e30``, so its carry weight
``exp(F + m0 - m_t)`` underflows to exactly 0.

Entry points (the JAX module's): ``init(cfg, generator, device)``,
``apply(params, tokens, cfg)`` with one Forge body per block kind,
``init_cache``, ``decode_step`` and ``prefill_step`` (per-row ``length``
and ``slot_mask``).  The recurrent state carries no positional index, so
both steps accept ``pos`` and ignore it.  Every entry point that creates
tensors runs on the CUDA device unless the caller passes
``device="cpu"``; the others follow their inputs' device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distrib.actsharding import gathered, head_layout, merged_heads, shard_count, split_heads
from ..kernels import ops
from . import layers as L
from ._forge import config_key, forge_body

Params = Dict[str, Any]

#: the {conv, cell} / sLSTM states fold every past token in — a slot
#: swap-in must reset the row to init_cache values (ModelAPI contract)
STATEFUL_DECODE = True

#: chunked prefill consumes EVERY token into recurrent state, so the
#: serve fronts pass a per-row ``length`` bounding each row's scan
PREFILL_TAKES_LENGTH = True


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """Every xlstm config prefills through the chunked state scan."""
    return True


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# mLSTM parallel core (one opaque accel dispatch unit)
# --------------------------------------------------------------------------


def _mlstm_parallel(q, k, v, i_pre, f_pre):
    """q, k, v: (B, H, S, D); i_pre, f_pre: (B, H, S) pre-activation gates."""
    S, D = q.shape[2], q.shape[3]
    logf = F.logsigmoid(f_pre.float())  # (B, H, S)
    cf = torch.cumsum(logf, dim=-1)
    # D_ij = cf_i - cf_j + logi_j  for j <= i
    Dm = cf[..., :, None] - cf[..., None, :] + i_pre.float()[..., None, :]
    row = torch.arange(S, device=q.device)[:, None]
    col = torch.arange(S, device=q.device)[None, :]
    Dm = torch.where(row >= col, Dm, -math.inf)
    m = torch.amax(Dm, dim=-1, keepdim=True)  # (B, H, S, 1)
    m = torch.clamp(m, min=-1e30)  # guard all -inf rows
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) / math.sqrt(D)
    s = s * torch.exp(Dm - m)
    n = torch.maximum(torch.abs(s.sum(-1, keepdim=True)), torch.exp(-m))
    h = torch.matmul(s, v.float()) / n
    return h.to(v.dtype)


@ops.forge_op("mlstm")
def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_pre: torch.Tensor,
                   f_pre: torch.Tensor) -> torch.Tensor:
    return _mlstm_parallel(q, k, v, i_pre, f_pre)


def mlstm_recurrent_step(q, k, v, i_pre, f_pre, state):
    """One decode step.  q, k, v: (B, H, D); gates: (B, H).
    state = {C: (B, H, D, D), n: (B, H, D), m: (B, H)}."""
    D = q.shape[-1]
    logf = F.logsigmoid(f_pre.float())
    logi = i_pre.float()
    m_new = torch.maximum(logf + state["m"], logi)
    f_sc = torch.exp(logf + state["m"] - m_new)[..., None]  # (B, H, 1)
    i_sc = torch.exp(logi - m_new)[..., None]
    kf, vf = k.float(), v.float()
    qf = q.float() / math.sqrt(D)
    C = f_sc[..., None] * state["C"] + i_sc[..., None] * (
        vf[..., :, None] * kf[..., None, :])  # (B, H, Dv, Dk)
    n = f_sc * state["n"] + i_sc * kf
    num = torch.matmul(C, qf[..., None])[..., 0]
    den = torch.maximum(torch.abs((n * qf).sum(-1)), torch.exp(-m_new))
    h = num / den[..., None]
    return h.to(v.dtype), {"C": C, "n": n, "m": m_new}


def mlstm_chunk_combine(e1, e2):
    """Associative combine for the chunked mLSTM state scan.

    A segment of the stabilized recurrence is summarized by
    ``(F, M, Ĉ, n̂)``: total log-decay ``F = Σ logf``, log-scale ``M``,
    and scaled accumulators such that the segment's true state
    contribution is ``exp(M)·Ĉ`` / ``exp(M)·n̂``.  A single token t is
    the leaf ``(logf_t, logi_t, v_t k_tᵀ, k_t)``.  Segment 1 (earlier)
    followed by segment 2:

        F = F1 + F2
        M = max(F2 + M1, M2)
        Ĉ = e^{F2+M1−M}·Ĉ1 + e^{M2−M}·Ĉ2
        n̂ = e^{F2+M1−M}·n̂1 + e^{M2−M}·n̂2
    """
    F1, M1, C1, n1 = e1
    F2, M2, C2, n2 = e2
    F_ = F1 + F2
    M = torch.maximum(F2 + M1, M2)
    w1 = torch.exp(F2 + M1 - M)
    w2 = torch.exp(M2 - M)
    C = w1[..., None, None] * C1 + w2[..., None, None] * C2
    n = w1[..., None] * n1 + w2[..., None] * n2
    return F_, M, C, n


def _slice(x: torch.Tensor, axis: int, start: Optional[int], stop: Optional[int] = None,
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a0, b0, a1, b1, … along ``axis``; ``a`` holds as many elements as
    ``b`` or one more."""
    if a.shape[axis] == b.shape[axis]:
        return torch.stack([a, b], dim=axis + 1).flatten(axis, axis + 1)
    head = torch.stack([_slice(a, axis, 0, -1), b], dim=axis + 1).flatten(axis, axis + 1)
    return torch.cat([head, _slice(a, axis, -1)], dim=axis)


def associative_scan(combine, elems: Tuple[torch.Tensor, ...], axis: int
                     ) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of ``combine`` over ``axis`` — the odd/even recursion
    of ``jax.lax.associative_scan``, with static slices: combine adjacent
    pairs, scan the reduced sequence, then fold each odd prefix into the
    next even element.  The same combines in the same order as JAX's, so
    the rounding follows the reference's; every shape is static, so
    ``torch.export`` captures it."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = combine(tuple(_slice(e, axis, 0, -1, 2) for e in elems),
                      tuple(_slice(e, axis, 1, None, 2) for e in elems))
    odd = associative_scan(combine, reduced, axis)
    rest = tuple(_slice(e, axis, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = combine(tuple(_slice(e, axis, 0, -1) for e in odd), rest)
    else:
        even = combine(odd, rest)
    even = tuple(torch.cat([_slice(e, axis, 0, 1), r], dim=axis) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def _take_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, ...) at per-row time index idx (B,) -> (B, H, ...)."""
    shape = (x.shape[0], x.shape[1], 1) + tuple(x.shape[3:])
    i = idx.view((-1,) + (1,) * (x.dim() - 1)).expand(shape)
    return torch.gather(x, 2, i)[:, :, 0]


def mlstm_chunk_scan(q, k, v, i_pre, f_pre, state, length):
    """Whole-chunk mLSTM: every prefix state via one associative scan.

    q, k, v: (B, H, S, D); gates: (B, H, S); ``state`` = the incoming
    {C, n, m} cell; ``length``: (B,) real tokens per row.  Returns
    ``(h, cell)``: per-position hidden outputs (B, H, S, D) matching S
    sequential :func:`mlstm_recurrent_step` calls, and the cell at each
    row's OWN position ``length - 1``.  Memory: the leaves and prefix
    states are (B, H, S, D, D) fp32 — 1 MiB per (b, h, s) at D = 512.
    """
    D = q.shape[-1]
    logf = F.logsigmoid(f_pre.float())  # (B, H, S)
    logi = i_pre.float()
    kf, vf = k.float(), v.float()
    qf = q.float() / math.sqrt(D)
    leaf_C = vf[..., :, None] * kf[..., None, :]  # (B, H, S, Dv, Dk)
    F_, M, Ch, nh = associative_scan(mlstm_chunk_combine, (logf, logi, leaf_C, kf), axis=2)
    # fold the incoming cell into every prefix state in closed form
    m0 = state["m"][..., None]  # (B, H, 1)
    m_t = torch.maximum(F_ + m0, M)  # (B, H, S)
    w0 = torch.exp(F_ + m0 - m_t)
    wt = torch.exp(M - m_t)
    C_t = w0[..., None, None] * state["C"][:, :, None] + wt[..., None, None] * Ch
    n_t = w0[..., None] * state["n"][:, :, None] + wt[..., None] * nh
    num = torch.matmul(C_t, qf[..., None])[..., 0]
    den = torch.maximum(torch.abs((n_t * qf).sum(-1)), torch.exp(-m_t))
    h = num / den[..., None]
    last = length.long() - 1
    cell = {"C": _take_at(C_t, last), "n": _take_at(n_t, last), "m": _take_at(m_t, last)}
    return h.to(v.dtype), cell


# --------------------------------------------------------------------------
# mLSTM block
# --------------------------------------------------------------------------


def mlstm_block_init(generator: Optional[torch.Generator], cfg: ModelConfig,
                     device: torch.device) -> Params:
    d = cfg.d_model
    inner = 2 * d
    hd = inner // cfg.n_heads
    dt = _dtype(cfg)
    return {
        "norm": L.norm_init(d, cfg.norm, device=device),
        "w_up": L.dense_init(generator, d, inner, dt, device),
        "w_gate": L.dense_init(generator, d, inner, dt, device),
        "conv": (torch.randn((cfg.conv_width, inner), generator=generator, device=device)
                 * 0.1).to(dt),
        "wq": L.dense_init(generator, inner, inner, dt, device),
        "wk": L.dense_init(generator, inner, inner, dt, device),
        "wv": L.dense_init(generator, inner, inner, dt, device),
        "w_if": L.dense_init(generator, inner, 2 * cfg.n_heads, dt, device),
        "norm_h": L.norm_init(hd, "rmsnorm", device=device),
        "w_down": L.dense_init(generator, inner, d, dt, device),
    }


def _split(x: torch.Tensor, H: int, keep_shards: bool = False) -> torch.Tensor:
    """(B, S, I) -> (B, H, S, I / H); ``keep_shards``: a planned call's
    column-parallel shards stay where they divide the heads (the
    parallel mLSTM core runs on local heads, ``actsharding.head_layout``)."""
    keep = keep_shards and head_layout(shard_count(x, 2), H, H)[0] in ("replicated", "heads")
    return split_heads(x, H, keep)


def _gates(c: torch.Tensor, p: Params, H: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i_pre, f_pre), each (B, H, S) fp32, the forget gate biased by +3."""
    gates = L.linear(c, p["w_if"]).float()  # (B, S, 2H)
    return gates[..., :H].transpose(1, 2), gates[..., H:].transpose(1, 2) + 3.0


def _mlstm_out(x: torch.Tensor, hm: torch.Tensor, g: torch.Tensor, p: Params) -> torch.Tensor:
    """The head norm, the silu output gate and the down projection.
    hm: (B, H, S, hd)."""
    hm = L.rms_norm(hm, p["norm_h"]["scale"])
    B, H, S, hd = hm.shape
    hm = merged_heads(hm.transpose(1, 2).reshape(B, S, H * hd))
    return x + L.linear(hm * F.silu(g), p["w_down"])


def mlstm_block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    H = cfg.n_heads
    h = L.apply_norm(x, p["norm"], cfg.norm)
    u = L.linear(h, p["w_up"])  # (B, S, 2d)
    g = L.linear(h, p["w_gate"])
    c = F.silu(L.causal_conv1d(u, p["conv"]))
    q = _split(L.linear(c, p["wq"]), H, keep_shards=True)
    k = _split(L.linear(c, p["wk"]), H, keep_shards=True)
    v = _split(L.linear(u, p["wv"]), H, keep_shards=True)
    i_pre, f_pre = _gates(c, p, H)
    return _mlstm_out(x, mlstm_parallel(q, k, v, i_pre, f_pre), g, p)


def mlstm_block_decode(p: Params, x: torch.Tensor, st: Dict[str, Any], cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    H = cfg.n_heads
    h = L.apply_norm(x, p["norm"], cfg.norm)  # (B, 1, d)
    u = L.linear(h, p["w_up"])
    g = L.linear(h, p["w_gate"])
    c_in = L.causal_conv1d(u, p["conv"], state=st["conv"])
    new_conv = torch.cat([st["conv"], u], dim=1)[:, 1:]
    c = F.silu(c_in)
    q = _split(L.linear(c, p["wq"]), H)[:, :, 0]  # (B, H, hd)
    k = _split(L.linear(c, p["wk"]), H)[:, :, 0]
    v = _split(L.linear(u, p["wv"]), H)[:, :, 0]
    i_pre, f_pre = _gates(c, p, H)
    hm, cell = mlstm_recurrent_step(q, k, v, i_pre[..., 0], f_pre[..., 0], st["cell"])
    return _mlstm_out(x, hm[:, :, None], g, p), {"conv": new_conv, "cell": cell}


def mlstm_block_prefill(p: Params, x: torch.Tensor, st: Dict[str, Any],
                        length: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Whole-chunk mLSTM block: S decode steps as one associative scan,
    continuing from the incoming {conv, cell} state."""
    H = cfg.n_heads
    h = L.apply_norm(x, p["norm"], cfg.norm)
    u = L.linear(h, p["w_up"])  # (B, S, 2d): raw conv inputs
    g = L.linear(h, p["w_gate"])
    c_in = L.causal_conv1d(u, p["conv"], state=st["conv"])
    new_conv = L.conv_state_slice(st["conv"], u, length)
    c = F.silu(c_in)
    q = _split(L.linear(c, p["wq"]), H)
    k = _split(L.linear(c, p["wk"]), H)
    v = _split(L.linear(u, p["wv"]), H)
    i_pre, f_pre = _gates(c, p, H)
    hm, cell = mlstm_chunk_scan(q, k, v, i_pre, f_pre, st["cell"], length)
    return _mlstm_out(x, hm, g, p), {"conv": new_conv, "cell": cell}


# --------------------------------------------------------------------------
# sLSTM block (sequential scan)
# --------------------------------------------------------------------------


def slstm_block_init(generator: Optional[torch.Generator], cfg: ModelConfig,
                     device: torch.device) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    dt = _dtype(cfg)
    return {
        "norm": L.norm_init(d, cfg.norm, device=device),
        "w_in": L.dense_init(generator, d, 4 * d, dt, device),  # z, i, f, o pre-acts
        "r": torch.randn((H, hd, 4 * hd), generator=generator, device=device)
        * (1.0 / math.sqrt(hd)),
        "w_out": L.dense_init(generator, d, d, dt, device),
    }


def _slstm_step(pre_t, r, c, n, h, m):
    """One sLSTM cell step.  pre_t: (B, H, 4hd) fp32; c, n, h, m: (B, H, hd)."""
    rec = torch.einsum("bhd,hdk->bhk", h, r)  # (B, H, 4hd)
    z_p, i_p, f_p, o_p = torch.chunk(pre_t + rec, 4, dim=-1)
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    logf = F.logsigmoid(f_p)
    m_new = torch.maximum(logf + m, i_p)
    i_sc = torch.exp(i_p - m_new)
    f_sc = torch.exp(logf + m - m_new)
    c_new = f_sc * c + i_sc * z
    n_new = torch.maximum(f_sc * n + i_sc, torch.exp(-m_new))
    h_new = o * c_new / n_new
    return c_new, n_new, h_new, m_new


def _slstm_scan_fake(pre, r, c, n, h, m, live):
    return (pre.new_empty(tuple(pre.shape[:2]) + tuple(c.shape[1:])), torch.empty_like(c),
            torch.empty_like(n), torch.empty_like(h), torch.empty_like(m))


@ops.scan_op("slstm", fake=_slstm_scan_fake)
def slstm_scan(pre: torch.Tensor, r: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
               h: torch.Tensor, m: torch.Tensor, live: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The sLSTM time loop (the reference's ``lax.scan``).  pre: (B, S, H,
    4hd) fp32; r: (H, hd, 4hd); c, n, h, m: (B, H, hd) the incoming carry;
    ``live``: (B, S) bool or None (every step live).  A row's carry stays
    bitwise where ``live`` is False.  Returns (hs (B, S, H, hd), c, n, h,
    m): every step's h and the final carry."""
    hs = []
    for t in range(pre.shape[1]):
        new = _slstm_step(pre[:, t], r, c, n, h, m)
        hs.append(new[2])
        if live is not None:
            keep = live[:, t, None, None]
            new = tuple(torch.where(keep, nw, old) for nw, old in zip(new, (c, n, h, m)))
        c, n, h, m = new
    return torch.stack(hs, dim=1), c, n, h, m


def _slstm_in(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The pre-activations (B, S, H, 4hd) fp32."""
    B, S, d = x.shape
    H = cfg.n_heads
    h_in = L.apply_norm(x, p["norm"], cfg.norm)
    return gathered(L.linear(h_in, p["w_in"]).float(), 2).reshape(B, S, H, 4 * (d // H))


def _slstm_out(p: Params, x: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    B, S, d = x.shape
    return x + L.linear(hs.reshape(B, S, d).to(x.dtype), p["w_out"])


def slstm_block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, _, d = x.shape
    zeros = torch.zeros((B, cfg.n_heads, d // cfg.n_heads), dtype=torch.float32,
                        device=x.device)
    hs, *_ = slstm_scan(_slstm_in(p, x, cfg), p["r"], zeros, zeros, zeros, zeros - 1e30,
                        None)
    return _slstm_out(p, x, hs)


def slstm_block_decode(p: Params, x: torch.Tensor, st: Dict[str, Any], cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    pre = _slstm_in(p, x, cfg)[:, 0]
    c, n, h, m = _slstm_step(pre, p["r"], st["c"], st["n"], st["h"], st["m"])
    return _slstm_out(p, x, h[:, None]), {"c": c, "n": n, "h": h, "m": m}


def slstm_block_prefill(p: Params, x: torch.Tensor, st: Dict[str, Any],
                        length: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Whole-chunk sLSTM block continuing from the incoming state.

    sLSTM is strictly sequential (the h → gates feedback defeats an
    associative reformulation), so this is the loop op inside the
    captured program: still one dispatch per chunk instead of one per
    token.  Per-row ``length`` freezes the carry bitwise past each row's
    real prompt end, so edge padding cannot leak into the state."""
    S = x.shape[1]
    live = torch.arange(S, device=x.device)[None, :] < length[:, None]
    hs, c, n, h, m = slstm_scan(_slstm_in(p, x, cfg), p["r"], st["c"], st["n"], st["h"],
                                st["m"], live)
    return _slstm_out(p, x, hs), {"c": c, "n": n, "h": h, "m": m}


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------


def _kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    return tuple(
        "slstm" if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0 else "mlstm"
        for i in range(cfg.n_layers)
    )


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device] = "cuda") -> Params:
    """Random parameters with the JAX package's distributions.

    ``generator`` must live on ``device``.  Tied configs store ONE
    embedding tensor, read again by the LM head."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    blocks = [slstm_block_init(generator, cfg, device) if kind == "slstm"
              else mlstm_block_init(generator, cfg, device) for kind in _kinds(cfg)]
    params: Params = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device),
        "blocks": blocks,
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab, dt, device)
    return params


def _lm_head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return L.lm_head(x, params.get("lm_head", params["embed"]), transpose=cfg.tie_embeddings)


def apply(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
          impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence forward: (B, S) tokens → (B, S, vocab) fp32 logits,
    one Forge-compiled body per block kind (shapes are identical across
    the layers of a kind) when ``cfg.fuse == 'forge'``."""
    x = L.embed(tokens, params["embed"])
    bodies = {}
    for p, kind in zip(params["blocks"], _kinds(cfg)):
        if kind not in bodies:
            base = slstm_block_apply if kind == "slstm" else mlstm_block_apply
            # the whole config keys the body (see transformer._body_fn)
            bodies[kind] = forge_body(lambda q, x_, _b=base: _b(q, x_, cfg),
                                      f"{config_key(cfg)}/{kind}", (p, x),
                                      enabled=(cfg.fuse == "forge"), impl=impl,
                                      remat=cfg.remat)
        x = bodies[kind](p, x)
    return _lm_head(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Per layer: {conv, cell: {C, n, m}} for mLSTM, {c, n, h, m} for
    sLSTM — O(1) in the sequence, every leaf batch-major, its own buffer."""
    device = resolve_device(device)
    inner = 2 * cfg.d_model
    H = cfg.n_heads
    hd_m, hd_s = inner // H, cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    layers = []
    for kind in _kinds(cfg):
        if kind == "slstm":
            z = torch.zeros((batch, H, hd_s), **f32)
            layers.append({"c": z, "n": z.clone(), "h": z.clone(), "m": z - 1e30})
        else:
            layers.append({
                "conv": torch.zeros((batch, cfg.conv_width - 1, inner), dtype=_dtype(cfg),
                                    device=device),
                "cell": {"C": torch.zeros((batch, H, hd_m, hd_m), **f32),
                         "n": torch.zeros((batch, H, hd_m), **f32),
                         "m": torch.zeros((batch, H), **f32) - 1e30},
            })
    return {"layers": layers}


def decode_step(params: Params, cache: Dict[str, Any], token: torch.Tensor,
                pos: Union[int, torch.Tensor], cfg: ModelConfig, *,
                slot_mask: Optional[torch.Tensor] = None, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode.  The recurrent state carries no positional index,
    so ``pos`` (scalar or per row) is accepted and ignored;
    ``slot_mask: bool[B]`` freezes inactive rows' {conv, cell, sLSTM}
    states bitwise (slot-level continuous batching).  The step reaches no
    kernel through ``impl``; it is kept for the common step signature."""
    x = L.embed(token, params["embed"])
    new_layers = []
    for p, kind, st in zip(params["blocks"], _kinds(cfg), cache["layers"]):
        block = slstm_block_decode if kind == "slstm" else mlstm_block_decode
        x, new_st = block(p, x, st, cfg)
        new_layers.append(L.slot_gate(slot_mask, new_st, st))
    return _lm_head(params, x, cfg), {"layers": new_layers}


def prefill_step(params: Params, cache: Dict[str, Any], tokens: torch.Tensor,
                 pos: Union[int, torch.Tensor], cfg: ModelConfig, *,
                 slot_mask: Optional[torch.Tensor] = None,
                 length: Optional[torch.Tensor] = None, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Chunked prefill: the whole (B, S) prompt chunk in one dispatch.

    mLSTM blocks run the stabilized (C, n, m) update as an associative
    scan (:func:`mlstm_chunk_scan`); sLSTM blocks run their loop op.
    ``pos`` is accepted and ignored (no positional state).  ``length:
    int[B]`` marks where each row's real prompt ends — state is gathered
    there and edge padding past it never reaches the carried cache.
    ``slot_mask: bool[B]`` freezes inactive rows bitwise."""
    B, S = tokens.shape
    x = L.embed(tokens, params["embed"])
    if length is None:
        length = torch.full((B,), S, dtype=torch.int64, device=x.device)
    new_layers = []
    for p, kind, st in zip(params["blocks"], _kinds(cfg), cache["layers"]):
        block = slstm_block_prefill if kind == "slstm" else mlstm_block_prefill
        x, new_st = block(p, x, st, length, cfg)
        new_layers.append(L.slot_gate(slot_mask, new_st, st))
    return _lm_head(params, x, cfg), {"layers": new_layers}
