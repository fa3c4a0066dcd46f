"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch.

A port of the JAX package's ``models/moe.py`` (the GShard / Switch
formulation):

1. router logits in fp32, top-k gate selection, softmax over the
   selected k,
2. capacity C = ⌈k·T/E · capacity_factor⌉ per expert; position in the
   expert first come first served over the flattened token stream;
   overflowing tokens drop,
3. scatter the kept tokens into an (E, C, D) dispatch buffer; batched
   expert SwiGLU through ``torch.bmm`` over every expert,
4. optional shared experts (Kimi-K2 style) added densely.

Every shape is static (``C`` is a Python int from the token count), and
nothing indexes by a boolean mask or calls ``nonzero``, so a body that
holds the FFN exports whole and replays as a CUDA graph.  The dispatch
buffer and the experts' outputs go through ``distrib.actsharding.constrain``
(``moe_dispatch``), as in the JAX package: the identity without an active
sharding policy, the expert-major layout pin under one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from ..distrib.actsharding import constrain
from . import layers as L

Params = Dict[str, Any]


def moe_init(generator: Optional[torch.Generator], d_model: int, d_ff: int, n_experts: int,
             *, shared_experts: int = 0, shared_d_ff: int = 0, dtype=torch.bfloat16,
             device: Union[str, torch.device] = "cpu") -> Params:
    """Random MoE parameters with the JAX package's distributions: an
    fp32 router (d, E), expert stacks (E, d, f) / (E, f, d) and, with
    ``shared_experts``, a dense SwiGLU of ``shared_d_ff`` (or
    ``d_ff · shared_experts``)."""
    def normal(shape, scale, dt):
        # scaled in place: one fp32 temporary a stack (kimi-k2's are 22.5 GB)
        return torch.randn(shape, generator=generator, device=device).mul_(scale).to(dt)

    scale = 1.0 / math.sqrt(d_model)
    p: Params = {
        "router": normal((d_model, n_experts), scale, torch.float32),
        "w_gate": normal((n_experts, d_model, d_ff), scale, dtype),
        "w_up": normal((n_experts, d_model, d_ff), scale, dtype),
        "w_down": normal((n_experts, d_ff, d_model), 1.0 / math.sqrt(d_ff), dtype),
    }
    if shared_experts:
        p["shared"] = L.ffn_init(generator, d_model, shared_d_ff or d_ff * shared_experts,
                                 kind="swiglu", dtype=dtype, device=device)
    return p


def _positions_onehot(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """GShard-style position in expert through a one-hot cumsum (a
    (T·k, E) tensor); the reference for :func:`_positions_sort`."""
    onehot = F.one_hot(e_flat, n_experts).to(torch.int32)
    return (torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot).sum(-1,
                                                                         dtype=torch.int32) - 1


def _positions_sort(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Sort-based position in expert, O(T·k): a stable argsort and the
    rank within each run of equal experts give the same first come first
    served assignment as the one-hot cumsum."""
    n = e_flat.shape[0]
    sort_idx = torch.argsort(e_flat, stable=True)
    se = e_flat[sort_idx]
    run_start = torch.searchsorted(se, se, side="left")
    ranks = (torch.arange(n, device=e_flat.device) - run_start).to(torch.int32)
    # sort_idx is a permutation: every slot is written once
    return torch.zeros((n,), dtype=torch.int32, device=e_flat.device).index_put(
        (sort_idx,), ranks)


def select_top_k(logits: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest in descending
    order, ties to the lower index.  A stable descending sort gives that
    order by definition; ``torch.topk`` leaves the order of ties open."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xf: torch.Tensor, p: Params, *, n_experts: int, top_k: int,
          capacity_factor: float, position_impl: str = "sort"):
    """The routing half of :func:`moe_ffn` on flattened tokens (T, D):
    ``(top_idx (T, k), gates (T, k) fp32, pos_in_e (T·k,) int32, keep
    (T·k,) bool, cap)``."""
    T = xf.shape[0]
    logits = torch.matmul(xf.float(), p["router"])
    top_vals, top_idx = select_top_k(logits, top_k)
    gates = torch.softmax(top_vals, dim=-1)
    cap = max(1, int(math.ceil(top_k * T / n_experts * capacity_factor)))
    e_flat = top_idx.reshape(-1)
    if position_impl == "sort":
        pos_in_e = _positions_sort(e_flat, n_experts)
    else:
        pos_in_e = _positions_onehot(e_flat, n_experts)
    return top_idx, gates, pos_in_e, pos_in_e < cap, cap


def moe_ffn(x: torch.Tensor, p: Params, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, position_impl: str = "sort") -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    top_idx, gates, pos_in_e, keep, cap = route(
        xf, p, n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor,
        position_impl=position_impl)
    e_flat = top_idx.reshape(-1)
    g_flat = gates.reshape(-1)
    tok_idx = torch.arange(T * top_k, device=x.device) // top_k
    pos_c = torch.clamp(pos_in_e, max=cap - 1)

    # -- dispatch: scatter the kept tokens into (E, C, D).  A kept token
    # owns its slot; dropped ones add zeros, so the sum's order cannot
    # change a value
    xt = xf[tok_idx]
    contrib = torch.where(keep[:, None], xt, torch.zeros_like(xt))
    buf = torch.zeros((n_experts, cap, D), dtype=x.dtype, device=x.device).index_put(
        (e_flat, pos_c), contrib, accumulate=True)
    # pin the expert-major layout (EP) under a sharding policy
    buf = constrain(buf, "moe_dispatch")

    # -- batched expert SwiGLU over every expert (fp32 accumulation inside)
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    out_e = constrain(torch.bmm(F.silu(g) * u, p["w_down"]), "moe_dispatch")

    # -- combine: gather back, gate-weight, sum each token's k terms in a
    # fixed order (the JAX scatter-add's order: 0 + term 0 + term 1 ...);
    # an atomic scatter-add would sum them in a different order each run
    picked = out_e[e_flat, pos_c]
    w = (g_flat * keep.to(g_flat.dtype)).to(x.dtype)[:, None]
    terms = (picked * w).reshape(T, top_k, D)
    y = terms[:, 0]
    for j in range(1, top_k):
        y = y + terms[:, j]

    if "shared" in p:
        y = y + L.swiglu_ffn(xf, p["shared"])
    return y.reshape(B, S, D)


def aux_load_balance_loss(x: torch.Tensor, p: Params, *, n_experts: int,
                          top_k: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (E · Σ_e f_e · P_e)."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D).float()
    logits = xf @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    _, idx = select_top_k(logits, top_k)
    onehot = F.one_hot(idx, n_experts).float().sum(1)
    return n_experts * torch.sum(onehot.mean(0) * probs.mean(0))
