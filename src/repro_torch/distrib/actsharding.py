"""Activation-sharding policy: explicit layout pins at attention/FFN
boundaries: a port of the JAX package's ``distrib/actsharding.py``.

Why this exists (the reference's finding): left alone, the partitioner
infers the attention internals' layout from the TP-sharded QKV
projections, and when ``n_kv_heads`` does not divide the model axis it
splits ``head_dim`` and all-reduces the score matrix.

The policy constrains, Megatron-style:

* q heads      -> ``model`` axis (dropped if H doesn't divide),
* k/v kv-heads -> ``model`` if divisible else REPLICATED,
* token-major activations (B, S, d) -> batch over dp axes; optionally
  sequence over ``model`` ("sp" flavor) between blocks,
* logits stay vocab-sharded.

The policy is a context set by the launcher or the dry run (models stay
pure): with no policy every hook returns its argument untouched and adds
nothing to a ``torch.export`` capture.  Under a policy ``constrain``
calls the op ``repro_torch::constrain`` (a copy on a plain tensor): on a
DTensor its one sharding strategy is the spec's placements, so DTensor
redistributes the input to them, as ``with_sharding_constraint`` pins a
layout; a body captured under a policy keeps the op as a node (the
Forge body cache is keyed by the policy, ``models/_forge.py``).
"""
from __future__ import annotations

# the models import this module: torch.distributed.tensor is imported
# only once a policy is in use
import contextlib
import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

_POLICY: List["ActivationPolicy"] = []


@dataclass
class ActivationPolicy:
    mesh: Any  # DeviceMesh
    tp_axis: str = "model"
    #: shard the sequence dim of (B,S,d) activations over model between
    #: blocks (sequence parallelism, off by default)
    sequence_parallel: bool = False
    enabled: bool = True
    #: restrict to a subset of kinds (None = all), e.g. {"logits"} pins
    #: only the LM-head output
    only: Optional[frozenset] = None

    def spec_for(self, kind: str, shape) -> Optional[tuple]:
        from .sharding import dp_axes, safe_pspec

        if self.only is not None and kind not in self.only:
            return None
        dp = dp_axes(self.mesh)
        tp = self.tp_axis
        nd = len(shape)
        if kind == "heads":  # (B, H, S, D): q heads over model
            pat = (dp, tp, None, None)
        elif kind == "kv":  # (B, KVH, S, D): shard if divisible else repl
            pat = (dp, tp, None, None)
        elif kind == "tokens":  # (B, S, d)
            pat = (dp, tp if self.sequence_parallel else None, None)
        elif kind == "ffn_hidden":  # (B, S, f): hidden over model
            pat = (dp, None, tp)
        elif kind == "logits":  # (B, S, V): vocab over model
            pat = (dp, None, tp)
        elif kind == "moe_tokens":  # (T, D) flat token stream
            pat = (dp, None)
        elif kind == "moe_dispatch":  # (E, C, D/F) expert-major buffers
            # GShard layout: experts over model (EP) AND capacity over the
            # data axes, so dispatch/combine become all-to-all
            pat = (tp, dp, None)
        else:
            return None
        if len(pat) != nd:
            return None
        return safe_pspec(shape, pat, self.mesh)

    def key(self) -> str:
        """What a body captured under this policy depends on."""
        return (f"tp{self.tp_axis}/sp{self.sequence_parallel}/on{self.enabled}/"
                f"only{sorted(self.only) if self.only is not None else None}/"
                f"mesh{tuple(self.mesh.mesh_dim_names)}{tuple(self.mesh.shape)}")


def current() -> Optional[ActivationPolicy]:
    return _POLICY[-1] if _POLICY else None


@contextlib.contextmanager
def use_policy(policy: Optional[ActivationPolicy]):
    if policy is None:
        yield
        return
    _POLICY.append(policy)
    try:
        yield
    finally:
        _POLICY.pop()


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Pin ``x`` to the policy's layout for ``kind``; ``x`` itself
    without an active policy (smoke tests and single-device runs)."""
    pol = current()
    if pol is None or not pol.enabled:
        return x
    spec = pol.spec_for(kind, x.shape)
    if spec is None:
        return x
    return _constrain_op(x, shard_dims(spec, pol.mesh))


def gathered(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` whole on every device: ``x`` itself unless
    it is a DTensor sharding ``dim``, which is then gathered (``Replicate``
    on those mesh dims, through ``repro_torch::constrain``).  Where GSPMD
    reshards by itself, DTensor needs it done first:

    * before a head split (attention then runs with every head on each
      device): DTensor refuses to view a dim whose shard count does not
      divide the heads (40 on a 16-way model axis), and heads over one
      mesh dim beside rows over another become, once the products
      flatten (rows, heads), a strided shard that its ``bmm`` has no
      strategy for (and that it cannot gather under fake tensors);
    * before a greedy ``argmax`` over the vocabulary: over a sharded dim
      DTensor converts the winners' indices with offsets it cannot read
      under fake tensors (the dry run)."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    pl = x.placements
    if not any(isinstance(p, Shard) and p.dim == dim for p in pl):
        return x
    return _constrain_op(x, [p.dim if isinstance(p, Shard) and p.dim != dim else -1 for p in pl])


def _mesh_dims_sharding(x: torch.Tensor, dim: int) -> List[int]:
    """The mesh dims over which the DTensor ``x`` shards dim ``dim``."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]


def head_layout(shards: int, n_heads: int, n_kv_heads: int) -> Tuple[str, int]:
    """How attention takes its heads when its projections' outputs are
    split into ``shards`` tensor-parallel shards (the plan's ``model``
    axis): ``(mode, kv_heads)``, ``kv_heads`` the K/V heads it runs with.
    ``"replicated"``: one shard.  ``"heads"``: the shards divide
    ``n_heads`` and ``n_kv_heads``, heads sharded with no gather.
    ``"kv_repeated"``: they divide only ``n_heads`` (GQA); K/V are
    gathered and each KV head repeated to ``lcm(n_kv_heads, shards)``
    heads, sharded with the queries (the same values: exact).
    ``"gathered"``: they do not divide ``n_heads``; heads gathered, as
    before tensor parallelism (a plan records this in ``fallbacks``).
    The one rule the models and ``ShardingPlan.attention_layout`` apply."""
    if shards == 1:
        return "replicated", n_kv_heads
    if n_heads % shards:
        return "gathered", n_kv_heads
    if n_kv_heads % shards:
        return "kv_repeated", math.lcm(n_kv_heads, shards)
    return "heads", n_kv_heads


def split_heads(x: torch.Tensor, n_heads: int, keep: bool) -> torch.Tensor:
    """(B, S, n·D) -> (B, n, S, D).  With ``keep`` a DTensor's sharded
    last dim (a column-parallel projection's output) stays sharded: its
    heads are sharded over those mesh dims, and attention runs on each
    device's local heads (the caller's :func:`head_layout` found that the
    shards divide ``n_heads``).  Otherwise the dim is :func:`gathered`
    first."""
    B, S, _ = x.shape
    if not keep:
        x = gathered(x, 2)
    return x.view(B, S, n_heads, -1).transpose(1, 2)


def shard_count(x: torch.Tensor, dim: int) -> int:
    """How many shards dim ``dim`` of ``x`` is split into (1 for a plain
    tensor)."""
    if type(x) is torch.Tensor or not hasattr(x, "placements"):
        return 1
    n = 1
    for i in _mesh_dims_sharding(x, dim % x.ndim):
        n *= x.device_mesh.size(i)
    return n


def kv_heads_like(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``k`` (B, KVH, S, D) with its heads sharded as ``q``'s (B, H, S, D)
    are: ``k`` itself where they already are; else (``"kv_repeated"`` of
    :func:`head_layout`) ``k`` gathered, each KV head repeated to the
    layout's KV heads (query head h still reads KV head h // (H / KVH))
    and sharded as ``q``."""
    if type(q) is torch.Tensor or shard_count(q, 1) == 1:
        return k
    if _mesh_dims_sharding(k, 1) == _mesh_dims_sharding(q, 1):
        return k
    k = gathered(k, 1)
    B, KVH, S, D = k.shape
    rep = head_layout(shard_count(q, 1), q.shape[1], KVH)[1] // KVH
    k = k.unsqueeze(2).expand(B, KVH, rep, S, D).reshape(B, KVH * rep, S, D)
    return _constrain_op(k, shard_dims_of(q))


def settled(args: Any) -> Any:
    """``args`` with every DTensor that holds a pending reduction (a
    ``Partial`` placement, such as a vocab-sharded embedding's masked
    lookup) reduced to ``Replicate`` on those mesh dims: a Forge body's
    capture and call take its arguments so, since a pending reduction's
    state does not survive ``torch.export``.  The reduction is the input
    redistribution of ``repro_torch::constrain``, not an autograd
    ``redistribute``, whose backward cannot turn a gradient's pending sum
    back into a masked one.  Plain tensors pass as they are."""
    from torch.utils import _pytree as pytree

    leaves = pytree.tree_leaves(args)
    if all(type(t) is torch.Tensor or not isinstance(t, torch.Tensor) for t in leaves):
        return args
    from torch.distributed.tensor import DTensor, Partial, Shard

    def one(t):
        if isinstance(t, DTensor) and any(isinstance(p, Partial) for p in t.placements):
            return _constrain_op(t, [p.dim if isinstance(p, Shard) else -1
                                     for p in t.placements])
        return t

    return pytree.tree_map(one, args)


#: the mesh axes a plan's FSDP shards parameters over (``dp_axes``); every
#: other mesh axis is tensor-parallel
DP_AXES = ("pod", "data")


def fsdp_gathered(params: Any) -> Any:
    """``params`` with every DTensor's shards over the data-parallel mesh
    axes gathered (``Replicate`` there; the ``model`` axis stays): FSDP's
    all-gather before a parameter is used, whose backward reduce-scatters
    the gradient back to the shards.  The reference leaves it to GSPMD
    ("XLA inserts per-layer all-gathers"); DTensor, op by op, would rather
    move the activations off their batch sharding.  Each Forge body's
    parameters (its first argument) are gathered as it is called, so a
    step holds one layer's gathered weights at a time."""
    from torch.utils import _pytree as pytree

    leaves = pytree.tree_leaves(params)
    if all(type(t) is torch.Tensor or not isinstance(t, torch.Tensor) for t in leaves):
        return params
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names or ()
        pl = [Replicate() if isinstance(p, Shard) and names[i] in DP_AXES else p
              for i, p in enumerate(t.placements)]
        return t if tuple(pl) == tuple(t.placements) else t.redistribute(t.device_mesh, pl)

    return pytree.tree_map(one, params)


def pin(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """The DTensor ``x`` placed with, per mesh dim, its dim ``dims[i]``
    sharded there (-1: replicated), through ``repro_torch::constrain``:
    DTensor redistributes it (a pending sum reduced, or scattered where a
    dim is to be sharded), and the gradient comes back pinned as ``x``
    was (a pending sum as replicated)."""
    return _constrain_op(x, list(dims))


def shard_dims(spec: Sequence[Any], mesh: Any) -> List[int]:
    """Per mesh dim, the tensor dim ``spec`` shards over it, or -1."""
    from torch.distributed.tensor import Shard

    from .sharding import placements

    return [p.dim if isinstance(p, Shard) else -1 for p in placements(spec, mesh)]


@torch.library.custom_op("repro_torch::constrain", mutates_args=())
def _constrain_op(x: torch.Tensor, dims: List[int]) -> torch.Tensor:
    return x.clone()


@_constrain_op.register_fake
def _(x, dims):
    return torch.empty_like(x)


def _constrain_setup(ctx, inputs, output):
    ctx.dims = shard_dims_of(inputs[0])


def _constrain_backward(ctx, g):
    """The gradient pinned back to the input's layout (the pin run in
    reverse): the op before it meets its gradient as it placed its
    output."""
    if ctx.dims is None or type(g) is torch.Tensor:
        return g, None
    return _constrain_op(g, ctx.dims), None


_constrain_op.register_autograd(_constrain_backward, setup_context=_constrain_setup)


def merged_heads(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, H·D), just merged from heads, whose gradient comes back
    placed as ``x`` is when its heads were whole on every device (a
    gathered split): the op after it may run on a slice of the merged dim
    (a row-parallel product), and the view back to heads could not split
    40 heads off a 16-way shard of the gradient.  ``x`` itself otherwise."""
    dims = shard_dims_of(x)
    if dims is None or x.ndim - 1 in dims:
        return x
    return _constrain_op(x, dims)


def shard_dims_of(x: torch.Tensor) -> Optional[List[int]]:
    """Per mesh dim, the tensor dim the DTensor ``x`` shards over it, or
    -1 (a pending sum counts as replicated); None for a plain tensor."""
    if type(x) is torch.Tensor:
        return None
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return None
    return [p.dim if isinstance(p, Shard) else -1 for p in x.placements]


def register_constrain_strategy() -> None:
    """DTensor's one strategy for ``repro_torch::constrain``: input and
    output at the placements ``dims`` names.  ``dims`` enters the
    strategy cache's key (``static_argnum=1``)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy, RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    def strategy(op_schema):
        src, dims = op_schema.args_schema[0], op_schema.args_schema[1]
        pl = tuple(Replicate() if d < 0 else Shard(d) for d in dims)
        meta = src.strategies[0].output_spec.tensor_meta
        spec = DTensorSpec(src.mesh, pl, tensor_meta=meta)
        return OpStrategy([OpSpec(output_specs=spec, input_specs=(spec,),
                                  redistribute_cost=[generate_redistribute_costs(src, spec)])])

    from torch.distributed.tensor import DTensor

    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        torch.ops.repro_torch.constrain.default, strategy,
        schema_info=RuntimeSchemaInfo(static_argnum=1))
