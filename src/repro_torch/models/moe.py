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

Under a sharding plan (``x`` a DTensor) the FFN runs expert-parallel in
the GShard layout the reference's plan pins (:func:`_moe_ffn_ep`): each
device routes its own token rows, holds and multiplies only its experts
(the plan's expert dim over ``model``) on its share of the capacity (over
the data axes), and the routing is the unplanned one: the capacity comes
from the global token count, and an entry's position in its expert is
its rank in the global token order (its rank in its device's rows plus
the entries of that expert on the devices before, an exclusive prefix sum
of per-device counts), so the same tokens drop.  The local parts are
custom ops (``repro_torch::moe_*``) whose DTensor strategies
(``distrib/sharding.py``) place their inputs and outputs; DTensor moves
the data between them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..distrib.actsharding import DP_AXES, constrain, gathered, pin, shard_dims_of
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
    """x: (B, S, D) -> (B, S, D); expert-parallel when ``x`` is placed by a
    sharding plan (:func:`_moe_ffn_ep`)."""
    if type(x) is not torch.Tensor and hasattr(x, "device_mesh"):
        return _moe_ffn_ep(x, p, n_experts=n_experts, top_k=top_k,
                           capacity_factor=capacity_factor, position_impl=position_impl)
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


# --------------------------------------------------------------------------
# expert parallelism under a sharding plan
# --------------------------------------------------------------------------


class EPLayout:
    """The mesh dims of a planned FFN by role.  ``rows``: the
    data-parallel dims over which the tokens' batch dim is sharded;
    ``caps``: every data-parallel dim of more than one device, which
    splits the dispatch buffer's capacity; ``experts``: the dims over
    which the expert stacks' dim 0 is sharded (none where the plan
    replicates the experts, as ``safe_pspec`` does when ``model`` does
    not divide E)."""

    def __init__(self, x: torch.Tensor, p: Params):
        self.mesh = mesh = x.device_mesh
        x_dims, w_dims = shard_dims_of(x), shard_dims_of(p["w_gate"])
        self.caps = [i for i, n in enumerate(mesh.mesh_dim_names)
                     if n in DP_AXES and mesh.size(i) > 1]
        self.rows = [i for i in self.caps if x_dims is not None and x_dims[i] == 0]
        self.experts = [i for i, d in enumerate(w_dims or ()) if d == 0 and mesh.size(i) > 1]

    def size(self, role: str) -> int:
        return math.prod(self.mesh.size(i) for i in getattr(self, role))

    def dims(self, **by: int) -> List[int]:
        """Per mesh dim the tensor dim sharded there, for ``pin``: ``by``
        maps a role to a tensor dim; -1 (replicated) elsewhere."""
        out = [-1] * self.mesh.ndim
        for role, d in by.items():
            for i in getattr(self, role):
                out[i] = d
        return out


def _ep_tokens(x: torch.Tensor, lay: EPLayout) -> torch.Tensor:
    """(B, S, D) -> (T, D) with the rows over ``lay.rows``, every other
    dim whole: each device holds its own token rows."""
    B, S, D = x.shape
    return pin(x, lay.dims(rows=0)).reshape(B * S, D)


def _ep_route(xf: torch.Tensor, p: Params, lay: EPLayout, *, n_experts: int, top_k: int,
              capacity_factor: float, position_impl: str):
    """:func:`route` on a device's token rows (``xf`` placed by
    :func:`_ep_tokens`), the same results: the capacity from the global
    token count, each entry's position its rank in the global token
    order (its rank in the device's rows plus that expert's entries on
    the devices before: every device's counts gathered, an exclusive
    prefix sum)."""
    T = xf.shape[0]
    logits = torch.matmul(xf.float(), gathered(p["router"], 1))
    top_vals, top_idx = select_top_k(logits, top_k)
    gates = torch.softmax(top_vals, dim=-1)
    cap = max(1, int(math.ceil(top_k * T / n_experts * capacity_factor)))
    e_flat = top_idx.reshape(-1)
    counts = pin(expert_counts(e_flat, n_experts, T * top_k // lay.size("rows")),
                 lay.dims())
    offsets = pin(torch.cumsum(counts, 0) - counts, lay.dims(rows=0))
    pos_in_e = global_positions(e_flat, offsets, position_impl != "sort")
    return top_idx, gates, pos_in_e, pos_in_e < cap, cap


def ep_route(x: torch.Tensor, p: Params, *, n_experts: int, top_k: int,
             capacity_factor: float, position_impl: str = "sort"):
    """:func:`route` of ``x`` (B, S, D) placed by a sharding plan, as the
    expert-parallel FFN routes it: ``(top_idx, gates, pos_in_e, keep,
    cap)``, their rows over the data axes."""
    lay = EPLayout(x, p)
    return _ep_route(_ep_tokens(x, lay), p, lay, n_experts=n_experts, top_k=top_k,
                     capacity_factor=capacity_factor, position_impl=position_impl)


def _moe_ffn_ep(x: torch.Tensor, p: Params, *, n_experts: int, top_k: int,
                capacity_factor: float, position_impl: str) -> torch.Tensor:
    """:func:`moe_ffn` on DTensors, expert-parallel (GShard layout).

    Per device: the routing of its token rows (:func:`_ep_route`); the
    kept entries of this device's experts scattered into an (E_l, C, D)
    buffer (:func:`dispatch`), which sums over the data axes into each
    device's (E_l, C / dp, D) share (a reduce-scatter); the expert SwiGLU
    on that share; the outputs gathered back over the data axes (an
    all-gather) and each token's terms of this device's experts
    gate-weighted and summed (:func:`combine`), a pending sum over the
    expert dims that DTensor reduces where the output is used.  ``C`` is
    padded up to a multiple of the data axes' devices; the padding slots
    stay empty (no entry's position reaches them)."""
    B, S, D = x.shape
    lay = EPLayout(x, p)
    xf = _ep_tokens(x, lay)
    top_idx, gates, pos_in_e, keep, cap = _ep_route(
        xf, p, lay, n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor,
        position_impl=position_impl)
    e_flat = top_idx.reshape(-1)
    pos_c = torch.clamp(pos_in_e, max=cap - 1)
    w = (gates.reshape(-1) * keep.to(gates.dtype)).to(x.dtype)
    # the expert ids, placed as the expert stacks are (a device's run of them)
    ids = pin(torch.zeros_like(p["router"][0], dtype=torch.int64)
              + torch.arange(n_experts, device=x.device), lay.dims(experts=0))
    n_caps = lay.size("caps")
    cap_p = -(-cap // n_caps) * n_caps

    # -- dispatch: each device's entries of the experts it holds, summed
    # over the data axes into each device's share of the capacity
    buf = pin(dispatch(xf, e_flat, pos_c, keep, ids, cap_p), lay.dims(caps=1, experts=0))
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    out_e = pin(torch.bmm(F.silu(g) * u, p["w_down"]), lay.dims(experts=0))

    # -- combine: this device's experts' terms of its tokens
    y = combine(out_e, e_flat, pos_c, w, ids, top_k)
    if "shared" in p:
        y = y + L.swiglu_ffn(xf, p["shared"])
    return y.reshape(B, S, D)


def _local_experts(e_flat: torch.Tensor, ids: torch.Tensor):
    """``(index of each entry's expert among ids, whether ids holds it)``:
    ``ids`` a run of consecutive expert ids (a device's experts)."""
    le = e_flat - ids[:1]
    own = (le >= 0) & (le < ids.shape[0])
    return le.clamp(0, ids.shape[0] - 1), own


def _sum_terms(terms: torch.Tensor, top_k: int) -> torch.Tensor:
    """(T·k, D) -> (T, D): each token's k terms summed in a fixed order
    (0 + term 0 + term 1 ..., as :func:`moe_ffn` sums them)."""
    terms = terms.reshape(-1, top_k, terms.shape[-1])
    y = terms[:, 0]
    for j in range(1, top_k):
        y = y + terms[:, j]
    return y


@torch.library.custom_op("repro_torch::moe_expert_counts", mutates_args=())
def expert_counts(e_flat: torch.Tensor, n_experts: int, shard_len: int) -> torch.Tensor:
    """(len / shard_len, E) int64: row i counts the entries of
    ``e_flat[i·shard_len : (i+1)·shard_len]`` routed to each expert (on a
    device: its own rows' counts)."""
    chunks = e_flat.reshape(-1, shard_len)
    return torch.zeros((chunks.shape[0], n_experts), dtype=torch.int64,
                       device=e_flat.device).scatter_add_(
        1, chunks, torch.ones_like(chunks, dtype=torch.int64))


@expert_counts.register_fake
def _(e_flat, n_experts, shard_len):
    return e_flat.new_empty((e_flat.shape[0] // shard_len, n_experts), dtype=torch.int64)


@torch.library.custom_op("repro_torch::moe_positions", mutates_args=())
def global_positions(e_flat: torch.Tensor, offsets: torch.Tensor, onehot: bool) -> torch.Tensor:
    """Each entry's position in its expert over the whole token stream:
    ``e_flat`` in ``len(offsets)`` equal chunks, an entry's rank among
    its chunk's entries of that expert (:func:`_positions_sort`, or
    :func:`_positions_onehot`) plus ``offsets[chunk, expert]`` (that
    expert's entries in the chunks before).  int32."""
    chunks = e_flat.reshape(offsets.shape[0], -1)
    rank = _positions_onehot if onehot else _positions_sort
    local = torch.stack([rank(c, offsets.shape[1]) for c in chunks])
    return (local + torch.gather(offsets, 1, chunks).to(torch.int32)).reshape(-1)


@global_positions.register_fake
def _(e_flat, offsets, onehot):
    return torch.empty_like(e_flat, dtype=torch.int32)


@torch.library.custom_op("repro_torch::moe_dispatch", mutates_args=())
def dispatch(xf: torch.Tensor, e_flat: torch.Tensor, pos_c: torch.Tensor, keep: torch.Tensor,
             ids: torch.Tensor, cap: int) -> torch.Tensor:
    """(len(ids), cap, D): :func:`moe_ffn`'s dispatch buffer of the experts
    ``ids`` (a run of consecutive expert ids), the kept entries scattered
    to their slots.  A kept entry owns its slot, every other one adds
    zeros, so the sum's order cannot change a value."""
    top_k = e_flat.shape[0] // xf.shape[0]
    le, own = _local_experts(e_flat, ids)
    xt = xf.repeat_interleave(top_k, dim=0)
    contrib = torch.where((own & keep)[:, None], xt, torch.zeros_like(xt))
    return torch.zeros((ids.shape[0], cap, xf.shape[1]), dtype=xf.dtype,
                       device=xf.device).index_put((le, pos_c), contrib, accumulate=True)


@dispatch.register_fake
def _(xf, e_flat, pos_c, keep, ids, cap):
    return xf.new_empty((ids.shape[0], cap, xf.shape[1]))


@torch.library.custom_op("repro_torch::moe_dispatch_backward", mutates_args=())
def dispatch_backward(g_buf: torch.Tensor, e_flat: torch.Tensor, pos_c: torch.Tensor,
                      keep: torch.Tensor, ids: torch.Tensor, top_k: int) -> torch.Tensor:
    """The gradient of :func:`dispatch` with respect to ``xf``: each
    token's kept entries' slots of ``g_buf``, summed."""
    le, own = _local_experts(e_flat, ids)
    picked = g_buf[le, pos_c]
    return _sum_terms(torch.where((own & keep)[:, None], picked, torch.zeros_like(picked)),
                      top_k)


@dispatch_backward.register_fake
def _(g_buf, e_flat, pos_c, keep, ids, top_k):
    return g_buf.new_empty((e_flat.shape[0] // top_k, g_buf.shape[2]))


def _dispatch_setup(ctx, inputs, output):
    _, e_flat, pos_c, keep, ids, _ = inputs
    ctx.save_for_backward(e_flat, pos_c, keep, ids)
    ctx.top_k = e_flat.shape[0] // inputs[0].shape[0]


def _dispatch_grad(ctx, g):
    e_flat, pos_c, keep, ids = ctx.saved_tensors
    return dispatch_backward(g, e_flat, pos_c, keep, ids, ctx.top_k), None, None, None, None, None


dispatch.register_autograd(_dispatch_grad, setup_context=_dispatch_setup)


@torch.library.custom_op("repro_torch::moe_combine", mutates_args=())
def combine(out_e: torch.Tensor, e_flat: torch.Tensor, pos_c: torch.Tensor, w: torch.Tensor,
            ids: torch.Tensor, top_k: int) -> torch.Tensor:
    """(T, D): each token's terms ``out_e[e, pos] · w`` of the experts
    ``ids`` summed in a fixed order (:func:`moe_ffn`'s combine on those
    experts; ``w`` the gates with the dropped entries' zeroed)."""
    le, own = _local_experts(e_flat, ids)
    terms = out_e[le, pos_c] * w[:, None]
    return _sum_terms(torch.where(own[:, None], terms, torch.zeros_like(terms)), top_k)


@combine.register_fake
def _(out_e, e_flat, pos_c, w, ids, top_k):
    return out_e.new_empty((e_flat.shape[0] // top_k, out_e.shape[2]))


@torch.library.custom_op("repro_torch::moe_combine_backward", mutates_args=())
def combine_backward(g_y: torch.Tensor, out_e: torch.Tensor, e_flat: torch.Tensor,
                     pos_c: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                     top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`combine` with respect to ``out_e`` and
    ``w``."""
    le, own = _local_experts(e_flat, ids)
    g_t = g_y.repeat_interleave(top_k, dim=0)
    g_terms = torch.where(own[:, None], g_t * w[:, None], torch.zeros_like(g_t))
    g_out = torch.zeros_like(out_e).index_put((le, pos_c), g_terms, accumulate=True)
    g_w = torch.where(own, (g_t * out_e[le, pos_c]).sum(-1), torch.zeros_like(w))
    return g_out, g_w


@combine_backward.register_fake
def _(g_y, out_e, e_flat, pos_c, w, ids, top_k):
    return torch.empty_like(out_e), torch.empty_like(w)


def _combine_setup(ctx, inputs, output):
    out_e, e_flat, pos_c, w, ids, top_k = inputs
    ctx.save_for_backward(out_e, e_flat, pos_c, w, ids)
    ctx.top_k = top_k


def _combine_grad(ctx, g):
    out_e, e_flat, pos_c, w, ids = ctx.saved_tensors
    g_out, g_w = combine_backward(g, out_e, e_flat, pos_c, w, ids, ctx.top_k)
    return g_out, None, None, g_w, None, None


combine.register_autograd(_combine_grad, setup_context=_combine_setup)


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
