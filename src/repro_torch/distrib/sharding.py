"""Sharding plans: DP / FSDP / TP / EP / SP over a ``DeviceMesh``: a port
of the JAX package's ``distrib/sharding.py``.

A :class:`ShardingPlan` maps every parameter, optimizer-state, input and
cache leaf to a partition spec using family-aware trailing-dim rules
(the reference's tables, copied):

* **TP** — attention heads, FFN hidden, vocab over the ``model`` axis,
* **EP** — MoE expert dim over ``model``,
* **FSDP/ZeRO** — params *additionally* sharded over the data axes
  (``("pod","data")`` multi-pod),
* **SP (sequence parallel for serving)** — decode KV caches shard the
  *sequence* dim over ``model``,
* batch dims over ``("pod", "data")``.

A spec is what the reference's ``PartitionSpec`` holds: per tensor dim a
mesh axis, a tuple of axes or ``None`` (:class:`P`).  :func:`placements`
turns it into DTensor placements, one per mesh dim: ``Shard(d)`` on every
mesh dim named for tensor dim ``d``, ``Replicate()`` elsewhere.  Axes
that share a dim (``("pod", "data")``) shard it on each of those mesh
dims, and DTensor splits such a dim in mesh-dim order: the shard sizes
are the reference's whatever the tuple's order, the device holding each
shard may differ where the tuple is not in mesh order (``vocab_fsdp``'s
``("model", "pod", "data")``).

Every spec passes through :func:`safe_pspec`, which drops mesh axes that
do not divide the dim (recorded in ``plan.fallbacks``).

Leaf paths are the reference's ``jax.tree_util.keystr`` strings
(:func:`keystr`: ``['blocks'][0]['attn']['wq']``, ``.mu[...]`` for a
NamedTuple field), since the rules match ``'name'`` inside them.  The
port's trees hold per-layer lists where the reference stacks layers; a
per-layer leaf gets the stacked leaf's spec without its leading layer
dim.

DTensor has no sharding strategy for the port's kernel ops
(``repro_torch::fused_linear`` ...) nor for the opaque ``forge_op`` /
``scan_op`` nodes: :func:`register_kernel_shardings` gives them theirs,
so that a planned call does one device's share of the work, as XLA
partitions the reference's products:

* ``fused_linear``, per mesh dim: all replicated; rows sharded where
  ``x``'s rows already are; on a tensor-parallel (non data-parallel) mesh
  dim, column-parallel where ``w`` is sharded on its columns (``x``
  replicated, ``b`` and the output sharded on the columns: the epilogue
  is per column, so exact), and row-parallel where ``w`` is sharded on
  its rows and there is no activation (``x`` sharded on its last dim, the
  output a pending sum; the bias enters as a pending sum too, each device
  adding ``b / n``, which is exact for the power-of-two axes used here);
  its backward op takes the same layout, so each gradient is computed on
  the forward's shards (a weight's gradient over sharded rows, and an
  input's over a sharded contraction, a pending sum);
* flash attention and its backward, and the mLSTM core and its backward:
  per mesh dim all replicated, rows sharded, or heads (dim 1) sharded,
  each where the first input already is;
* the other kernel and opaque ops: rows (dim 0 of their batch-major
  tensors) sharded in and out where the first input's rows already are,
  or all replicated; a backward op's gradient of a replicated argument
  (the sLSTM loop's recurrent weight) is then a pending sum;
* the MoE's local ops (expert parallelism, ``models/moe.py``): one
  layout each, per mesh dim by its role: the token rows sharded where
  they are, the experts where the expert ids are (:data:`_MOE_OPS`);

any other input placement is redistributed to one of them.  Two plain
ops the models reach that DTensor lacks a strategy for get one too
(``searchsorted``: the sorted sequence replicated; ``log_sigmoid``
forward and backward: pointwise).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from .actsharding import DP_AXES, head_layout

Axis = Any  # str | tuple[str, ...] | None


class P(tuple):
    """A partition spec: per tensor dim a mesh axis name, a tuple of
    names or ``None`` (the reference's ``PartitionSpec``, which also
    writes a one-axis tuple as the axis)."""

    def __new__(cls, *parts: Axis) -> "P":
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else tuple(p)) if isinstance(p, (tuple, list)) else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (the reference's
    ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh: Any, axis: Axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def dp_axes(mesh: Any) -> Axis:
    """The data-parallel axes: ('pod','data') on multi-pod meshes."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def safe_pspec(shape: Sequence[int], spec: Sequence[Axis], mesh: Any,
               log: Optional[List[str]] = None, tag: str = "") -> P:
    """Drop axes that don't divide their dim (fallback to replication)."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        n = mesh_axis_size(mesh, tuple(ax) if isinstance(ax, (tuple, list)) else ax)
        if dim % n == 0 and dim > 0:
            out.append(tuple(ax) if isinstance(ax, (tuple, list)) else ax)
        else:
            out.append(None)
            if log is not None:
                log.append(f"{tag}: dim {dim} % {ax}({n}) != 0 -> replicated")
    return P(*out)


def placements(spec: Sequence[Axis], mesh: Any) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.  A
    mesh dim of size 1 holds the whole tensor dim: ``Replicate()`` there
    (the same layout; ``torch.export`` of a DTensor sharded over a size-1
    mesh dim fails)."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    taken = set()
    for d, ax in enumerate(spec):
        for a in (() if ax is None else ax if isinstance(ax, (tuple, list)) else (ax,)):
            i = names.index(a)
            if i in taken:
                raise ValueError(f"mesh axis {a!r} shards two dims of spec {spec}")
            taken.add(i)
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): one leaf of
    the trees the plan's ``*_shardings`` return."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.spec, self.mesh)


def keystr(path: Sequence[Any]) -> str:
    """A pytree path as ``jax.tree_util.keystr`` writes it: ``['key']``
    for a dict entry, ``[i]`` for a list or tuple item, ``.name`` for a
    NamedTuple or dataclass field."""
    parts = []
    for k in path:
        if isinstance(k, pytree.MappingKey):
            parts.append(f"[{k.key!r}]")
        elif isinstance(k, pytree.SequenceKey):
            parts.append(f"[{k.idx}]")
        elif isinstance(k, pytree.GetAttrKey):
            parts.append(f".{k.name}")
        else:
            parts.append(str(k))
    return "".join(parts)


def flatten_with_paths(tree: Any) -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(keystr path, leaf)], spec)`` of ``tree``."""
    flat, spec = pytree.tree_flatten_with_path(tree)
    return [(keystr(kp), leaf) for kp, leaf in flat], spec


# --------------------------------------------------------------------------
# parameter rules: leaf-name -> trailing-dim axis pattern
# "F" is the FSDP placeholder (resolves to dp axes or None);
# "M" is the tensor/model axis.
# --------------------------------------------------------------------------

_PARAM_RULES: List[Tuple[str, Tuple]] = [
    # MoE experts (3-D trailing): expert dim -> model (EP)
    ("router", (None, "M")),
    ("w_gate3", ("M", "F", None)),  # (E, d, f) — placeholder, see below
    # attention
    ("wq", ("F", "M")),
    ("wk", ("F", "M")),
    ("wv", ("F", "M")),
    ("wo", ("M", "F")),
    ("bq", ("M",)),
    ("bk", ("M",)),
    ("bv", ("M",)),
    # FFN
    ("w_gate", ("F", "M")),
    ("w_up", ("F", "M")),
    ("w_down", ("M", "F")),
    ("w_fc", ("F", "M")),
    ("w_out", ("M", "F")),
    ("b_fc", ("M",)),
    ("b_out", (None,)),
    # embeddings (per-arch overrides below; see ShardingPlan.param_pattern)
    ("embed", ("M", "F")),
    ("lm_head", ("F", "M")),
    # RG-LRU / xLSTM projections
    ("wx", ("F", "M")),
    ("wy", ("F", "M")),
    ("wi", ("F", "M")),
    ("wr", ("F", "M")),
    ("w_if", ("F", None)),
    ("conv", (None, "M")),
    ("lam", ("M",)),
    # norms / small
    ("scale", (None,)),
    ("bias", (None,)),
    ("r", (None, None, None)),
]

_MOE_3D = {"w_gate", "w_up", "w_down"}  # under a 'moe' path → (E, ·, ·)


@dataclass
class ShardingPlan:
    mesh: Any  # DeviceMesh
    cfg: ModelConfig
    fsdp: bool = True
    seq_shard_cache: bool = True  # SP for decode KV caches
    moe_fsdp_dim: str = "contract"  # 'contract' | 'output'
    vocab_fsdp: bool = False  # lm_head FSDP on vocab dim
    fallbacks: List[str] = field(default_factory=list)

    # -- leaf-level rules -------------------------------------------------------

    def _resolve(self, pattern: Tuple, ndim: int) -> Tuple:
        dp = dp_axes(self.mesh)

        def one(a):
            if a == "F":
                return dp if self.fsdp else None
            if a == "M":
                return "model"
            if a == "MF":  # tp+dp jointly on one dim (vocab-style)
                return ("model", *dp) if self.fsdp else "model"
            return a

        conc = tuple(one(a) for a in pattern)
        if len(conc) < ndim:  # stacked-layer leading dims replicate
            conc = (None,) * (ndim - len(conc)) + conc
        return conc[:ndim] if len(conc) > ndim else conc

    def param_pattern(self, path: str, leaf) -> Tuple:
        ndim = len(leaf.shape)
        last_name = None
        for name, pat in _PARAM_RULES:
            if f"'{name}'" in path:
                last_name = (name, pat)
        if last_name is None:
            return (None,) * ndim
        name, pat = last_name
        if name == "lm_head" and self.vocab_fsdp:
            pat = (None, "MF")  # never shard the head's contraction dim
        if name == "embed" and self.vocab_fsdp:
            pat = ("F", "M")
        # MoE expert tensors: (…, E, a, b) -> expert dim over model (EP);
        # ``moe_fsdp_dim`` picks where the dp axes live: "contract" (the
        # GShard default) or "output"
        if name in _MOE_3D and "'moe'" in path and "'shared'" not in path:
            dp = dp_axes(self.mesh)
            f = dp if self.fsdp else None
            if self.moe_fsdp_dim == "output":
                pat = ("model", None, f)
            else:  # contract
                pat = ("model", f, None) if name in ("w_gate", "w_up") \
                    else ("model", None, f)
            if len(pat) < ndim:
                pat = (None,) * (ndim - len(pat)) + pat
            return pat
        return self._resolve(pat, ndim)

    def param_spec(self, path: str, leaf) -> P:
        pat = self.param_pattern(path, leaf)
        return safe_pspec(leaf.shape, pat, self.mesh, self.fallbacks, tag=f"param{path}")

    def params_shardings(self, params_tree: Any) -> Any:
        flat, spec = flatten_with_paths(params_tree)
        out = pytree.tree_unflatten(
            [NamedSharding(self.mesh, self.param_spec(path, leaf)) for path, leaf in flat], spec)
        notes = []
        if self.attention_layout()["mode"] == "gathered":
            notes.append(f"attention: n_heads {self.cfg.n_heads} % model({self._model_size()}) "
                         "!= 0 -> heads gathered")
        if self.cfg.family == "moe" and self.cfg.n_experts % self._model_size():
            # the expert stacks replicated: each device runs every expert
            # on its share of the capacity (models/moe.py)
            notes.append(f"moe: n_experts {self.cfg.n_experts} % model({self._model_size()}) "
                         "!= 0 -> experts replicated")
        self.fallbacks.extend(n for n in notes if n not in self.fallbacks)
        return out

    # -- optimizer states ------------------------------------------------------

    def opt_state_shardings(self, opt_state: Any, params_tree: Any) -> Any:
        """Shape-match states to their param's spec (Adafactor-aware).
        ``params_tree`` is laid out as the state is (for the port's
        Adafactor: ``optim.adafactor.stack_layers`` of the params)."""
        by_shape_path = {path: (leaf, self.param_pattern(path, leaf))
                         for path, leaf in flatten_with_paths(params_tree)[0]}

        def spec_for(path, leaf) -> P:
            # find the param whose path is a suffix of this state path
            for ppath, (pleaf, ppat) in by_shape_path.items():
                if path.endswith(ppath):
                    pshape = tuple(pleaf.shape)
                    lshape = tuple(leaf.shape)
                    if lshape == pshape:
                        return safe_pspec(lshape, ppat, self.mesh)
                    if lshape == pshape[:-1]:  # Adafactor vr
                        return safe_pspec(lshape, ppat[:-1], self.mesh)
                    if lshape == pshape[:-2] + pshape[-1:]:  # vc
                        return safe_pspec(lshape, ppat[:-2] + ppat[-1:], self.mesh)
                    break
            return P()

        flat, spec = flatten_with_paths(opt_state)
        return pytree.tree_unflatten(
            [NamedSharding(self.mesh, spec_for(path, leaf)) for path, leaf in flat], spec)

    # -- inputs / caches -------------------------------------------------------------

    def batch_spec(self, leaf) -> P:
        dp = dp_axes(self.mesh)
        shape = leaf.shape
        pat = (dp,) + (None,) * (len(shape) - 1)
        return safe_pspec(shape, pat, self.mesh, self.fallbacks, "batch")

    def batch_shardings(self, batch: Any) -> Any:
        return pytree.tree_map(lambda leaf: NamedSharding(self.mesh, self.batch_spec(leaf)),
                               batch)

    def cache_spec(self, path: str, leaf) -> P:
        dp = dp_axes(self.mesh)
        shape = leaf.shape
        nd = len(shape)
        sp = "model" if self.seq_shard_cache else None
        if ("'k'" in path or "'v'" in path or "self_k" in path
                or "self_v" in path or "cross_k" in path or "cross_v" in path):
            if nd == 5:  # (L, B, KVH, S, hd): batch->dp, seq->model (SP)
                pat = (None, dp, None, sp, None)
            elif nd == 4:  # (B, KVH, S, hd) hybrid window cache
                pat = (dp, None, sp, None)
            else:
                pat = (dp,) + (None,) * (nd - 1)
        elif "'C'" in path and nd == 4:  # mLSTM matrix memory (B,H,dv,dk)
            pat = (dp, None, "model", None)
        elif nd >= 2:
            pat = (dp,) + (None,) * (nd - 2) + ("model",)
        elif nd == 1:
            pat = (dp,)
        else:
            pat = ()
        return safe_pspec(shape, pat, self.mesh, self.fallbacks, f"cache{path}")

    def cache_shardings(self, cache: Any) -> Any:
        flat, spec = flatten_with_paths(cache)
        return pytree.tree_unflatten(
            [NamedSharding(self.mesh, self.cache_spec(path, leaf)) for path, leaf in flat], spec)

    def scalar_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def _model_size(self) -> int:
        return mesh_axis_size(self.mesh, "model") if "model" in self.mesh.mesh_dim_names else 1

    def attention_layout(self) -> Dict[str, Any]:
        """How a planned call's attention takes its heads over ``model``:
        :func:`~repro_torch.distrib.actsharding.head_layout`, the rule the
        models apply to the shards they meet, as ``{"mode", "kv_heads"}``.
        The ``"gathered"`` case is recorded in ``fallbacks`` when the
        params are placed (:meth:`params_shardings`), where ``safe_pspec``
        records the leaves' own.  Windowed and cached attention always
        gathers."""
        mode, kv_heads = head_layout(self._model_size(), self.cfg.n_heads,
                                     self.cfg.n_kv_heads)
        return {"mode": mode, "kv_heads": kv_heads}

    def summary(self) -> str:
        return (f"plan[{self.cfg.name}] mesh={axis_sizes(self.mesh)} "
                f"fsdp={self.fsdp} sp_cache={self.seq_shard_cache} "
                f"fallbacks={len(self.fallbacks)}")


def plan_for(cfg: ModelConfig, mesh: Any, *, fsdp: Optional[bool] = None,
             seq_shard_cache: bool = True,
             moe_fsdp_dim: str = "contract",
             vocab_fsdp: bool = False) -> ShardingPlan:
    if fsdp is None:
        # FSDP on for models whose bf16 params exceed ~1 GB/device under pure TP
        tp = mesh_axis_size(mesh, "model")
        fsdp = cfg.param_count() * 2 / tp > 1e9
    return ShardingPlan(mesh=mesh, cfg=cfg, fsdp=fsdp,
                        seq_shard_cache=seq_shard_cache,
                        moe_fsdp_dim=moe_fsdp_dim, vocab_fsdp=vocab_fsdp)


# --------------------------------------------------------------------------
# placing tensors
# --------------------------------------------------------------------------


def _is_sharding(x: Any) -> bool:
    return isinstance(x, NamedSharding)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """``tree``'s tensors as DTensors placed as ``shardings`` (a tree of
    :class:`NamedSharding` like ``tree``, from the plan's
    ``*_shardings``) says.  A real tensor is split from its full value
    (``distribute_tensor``: every rank passes the same full tensor and
    slices its own shard, with no communication); a
    fake or meta tensor (the dry run) becomes its local shard, allocated
    empty, with no communication; meta tensors are placed only under
    ``FakeTensorMode`` (their shards are fake)."""
    register_kernel_shardings()
    flat, spec = pytree.tree_flatten(tree)
    shards = pytree.tree_flatten(shardings, is_leaf=_is_sharding)[0]
    if len(shards) != len(flat):
        raise ValueError(f"{len(flat)} leaves against {len(shards)} shardings")
    out = []
    for t, sh in zip(flat, shards):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        pl = sh.placements
        if t.device.type == "meta" or is_fake(t):
            local = local_stand_in(t, sh.mesh, pl)
            if not is_fake(local.to_local()):
                raise ValueError("meta tensors are placed under FakeTensorMode only")
            out.append(local)
        else:  # every rank holds the same full value: each slices its own shard
            out.append(distribute_tensor(t, sh.mesh, list(pl), src_data_rank=None))
    return pytree.tree_unflatten(out, spec)


def local_stand_in(t: torch.Tensor, mesh: DeviceMesh, pl: Sequence[Placement]) -> DTensor:
    """A DTensor of ``t``'s global shape and dtype whose local shard is an
    empty tensor of the shard's shape (specs divide evenly): under
    ``FakeTensorMode`` nothing is allocated."""
    shape = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(i)
    local = torch.empty(shape, dtype=t.dtype, device=mesh.device_type)
    return DTensor.from_local(local, mesh, list(pl), run_check=False,
                              shape=t.shape, stride=t.stride())


def replicate_plain():
    """The context a planned call runs in: plain tensors the model makes
    itself (RoPE tables, masks, folded constants) meet DTensors as
    replicated values, as GSPMD replicates an unsharded array."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


# --------------------------------------------------------------------------
# sharding strategies of the kernel and opaque ops
# --------------------------------------------------------------------------

#: op -> per argument: True for a batch-major tensor (rows on dim 0),
#: False for a replicated tensor (weights, the page pool), None for a
#: non-tensor argument; every output is batch-major
_ROW_OPS: Dict[str, Tuple[Optional[bool], ...]] = {
    # q, k_pages, v_pages, page_table, pos, window, scale
    "repro_torch::paged_attention": (True, False, False, True, True, None, None),
    "repro_torch::rg_lru": (True, True, True),  # x, a, h0
    "repro_torch::rg_lru_chunked": (True, True, True),
    "repro_torch::rms_norm": (True, False, None),  # x, w, eps
    # pre, r, c, n, h, m, live
    "forge_scan::slstm": (True, False, True, True, True, True, True),
    # the same, then the gradients of (hs, c, n, h, m)
    "forge_scan::slstm_backward": (True, False, True, True, True, True, True) + (True,) * 5,
}
#: row ops with outputs that are not batch-major -> per output: True for
#: batch-major, False for the gradient of a replicated argument (a sum
#: over the rows: a pending sum where the rows are sharded)
_ROW_OUTPUTS: Dict[str, Tuple[bool, ...]] = {
    # d pre, d r, d c, d n, d h, d m
    "forge_scan::slstm_backward": (True, False, True, True, True, True),
}
#: head-major ops (every tensor argument and output (B, H, ...)) -> the
#: index of their first non-tensor argument (the rest is static)
_HEAD_OPS: Dict[str, int] = {
    "repro_torch::flash_attention": 3,  # q, k, v, scale, scale_mode, causal
    "repro_torch::flash_attention_backward": 4,  # q, k, v, g, ...
    "repro_torch::forge_mlstm": 5,  # q, k, v, i_pre, f_pre
    "repro_torch::forge_mlstm_backward": 6,  # q, k, v, i_pre, f_pre, g
}
_REGISTERED: set = set()


def _row_strategy(rows: Tuple[Optional[bool], ...], outputs: Tuple[bool, ...]):
    """The op's two layouts: every tensor replicated, or its batch-major
    tensors' rows sharded over the mesh dims on which the first input's
    rows already are (the others replicated), batch-major outputs
    likewise and the others (``outputs``) pending sums there.  Unlike
    ``register_sharding``, which lets each mesh dim pick a layout on its
    own, this never shards rows over a mesh dim that holds another dim
    (heads over ``model``): the plain backward's products would flatten
    (rows, heads) into a strided shard, which DTensor cannot gather under
    fake tensors."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    def strategy(op_schema):
        first = op_schema.args_schema[0]
        mesh = first.mesh
        src = first.strategies[0].output_spec.placements
        rep = (Replicate(),) * mesh.ndim
        sharded = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                        for p in src)
        layouts = [rep] + ([sharded] if sharded != rep else [])
        specs = []
        for pl in layouts:
            ins, costs = [], []
            for row, arg in zip(rows, op_schema.args_schema):
                if row is None or not isinstance(arg, OpStrategy):
                    continue
                want = DTensorSpec(mesh, pl if row else rep,
                                   tensor_meta=arg.strategies[0].output_spec.tensor_meta)
                ins.append(want)
                costs.append(generate_redistribute_costs(arg, want))
            summed = tuple(Partial() if isinstance(p, Shard) else p for p in pl)
            outs = tuple(DTensorSpec(mesh, pl if rowwise else summed) for rowwise in outputs)
            specs.append(OpSpec(output_specs=outs[0] if len(outs) == 1 else outs,
                                input_specs=tuple(ins), redistribute_cost=costs))
        return OpStrategy(specs)

    return strategy


def _placed(arg) -> Tuple[Placement, ...]:
    """The placements an op argument (an ``OpStrategy``) arrives with."""
    return arg.strategies[0].output_spec.placements


def _is_shard(p: Placement, dim: int) -> bool:
    return isinstance(p, Shard) and p.dim == dim


def _per_dim_strategy(op_schema, per_dim: Sequence[Sequence[Tuple[Tuple, Tuple]]]):
    """The op's layouts: every combination of one candidate a mesh dim.
    A candidate is ``(placement of each tensor argument, placement of
    each output)`` on its mesh dim."""
    import itertools

    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    args = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
    mesh = args[0].mesh
    specs = []
    for combo in itertools.product(*per_dim):
        ins = [DTensorSpec(mesh, tuple(c[0][j] for c in combo),
                           tensor_meta=a.strategies[0].output_spec.tensor_meta)
               for j, a in enumerate(args)]
        outs = tuple(DTensorSpec(mesh, tuple(c[1][j] for c in combo))
                     for j in range(len(combo[0][1])))
        specs.append(OpSpec(output_specs=outs[0] if len(outs) == 1 else outs,
                            input_specs=tuple(ins),
                            redistribute_cost=[generate_redistribute_costs(a, w)
                                               for a, w in zip(args, ins)]))
    return OpStrategy(specs)


def _linear_layouts(mesh_dim: str, xp: Placement, wp: Placement, act) -> List[str]:
    """The layouts ``fused_linear`` may take on one mesh dim, given how
    ``x`` and ``w`` arrive: ``"replicated"``; ``"rows"`` where ``x``'s
    rows are sharded; on a tensor-parallel (not data-parallel) dim
    ``"column"`` where ``w`` is sharded on its columns, or ``"row"``
    where on its rows and there is no activation."""
    out = ["replicated"] + (["rows"] if _is_shard(xp, 0) else [])
    if mesh_dim not in DP_AXES:
        if _is_shard(wp, 1):
            out.append("column")
        elif _is_shard(wp, 0) and act is None:
            out.append("row")
    return out


_R, _S0, _S1, _P = Replicate(), Shard(0), Shard(1), Partial()
#: layout -> ((x, w, b) in, (y,) out): the row-parallel output is a
#: pending sum, and its bias enters as one (each device adds b / n)
_LINEAR_FWD = {"replicated": ((_R, _R, _R), (_R,)), "rows": ((_S0, _R, _R), (_S0,)),
               "column": ((_R, _S1, _S0), (_S1,)), "row": ((_S1, _S0, _P), (_P,))}
#: layout -> ((x, w, b, g) in, (dx, dw, db) out) of the backward op, on
#: the forward's shards: a gradient summed over sharded rows or a
#: sharded contraction is a pending sum
_LINEAR_BWD = {"replicated": ((_R, _R, _R, _R), (_R, _R, _R)),
               "rows": ((_S0, _R, _R, _S0), (_S0, _P, _P)),
               "column": ((_R, _S1, _S0, _S1), (_P, _S1, _S0)),
               "row": ((_S1, _S0, _R, _R), (_S1, _S0, _R))}


def _linear_strategy(table):
    """The strategy of ``fused_linear(x, w, b, act)`` (``table`` =
    :data:`_LINEAR_FWD`) or of its backward op ``(x, w, b, g, act)``
    (:data:`_LINEAR_BWD`): per mesh dim, each layout of
    :func:`_linear_layouts` (module docstring)."""

    def strategy(op_schema):
        x, w, b = op_schema.args_schema[:3]
        act = op_schema.args_schema[-1]
        names = x.mesh.mesh_dim_names or ()
        per_dim = []
        for i, (xp, wp) in enumerate(zip(_placed(x), _placed(w))):
            opts = []
            for layout in _linear_layouts(names[i], xp, wp, act):
                ins, outs = table[layout]
                opts.append((ins[:2] + (ins[2:] if b is not None else ins[3:]), outs))
            per_dim.append(opts)
        return _per_dim_strategy(op_schema, per_dim)

    return strategy


def _head_strategy(op_schema):
    """A head-major op: per mesh dim every tensor replicated, or rows
    (dim 0) or heads (dim 1) sharded where the first input's are; the
    outputs alike.  The strategy of flash attention, the mLSTM core and
    their backward ops, which run on local heads: DTensor never sees
    their products flatten (rows, heads)."""
    from torch.distributed.tensor._op_schema import OpStrategy

    args = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
    n_out = len(op_schema.op._schema.returns)
    per_dim = []
    for p in _placed(args[0]):
        opts = [Replicate()] + [Shard(d) for d in (0, 1) if _is_shard(p, d)]
        per_dim.append([((o,) * len(args), (o,) * n_out) for o in opts])
    return _per_dim_strategy(op_schema, per_dim)


def _searchsorted_strategy(op_schema):
    """``searchsorted(sorted, values)``: a 1-D sorted sequence
    replicated, the values and the output as the values are placed (a
    pending sum reduced); a batched sequence: everything replicated."""
    seq, values = op_schema.args_schema[:2]
    per_dim = []
    for p in _placed(values):
        keep = p if seq.ndim == 1 and isinstance(p, Shard) else Replicate()
        per_dim.append([((Replicate(), keep), (keep,))])
    return _per_dim_strategy(op_schema, per_dim)


def _pointwise_like_first(op_schema):
    """Every tensor argument and output at the first argument's
    placements, a pending sum reduced (``log_sigmoid_forward`` /
    ``_backward``: elementwise, with a buffer of the input's shape)."""
    from torch.distributed.tensor._op_schema import OpStrategy

    args = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
    n_out = len(op_schema.op._schema.returns)
    per_dim = []
    for p in _placed(args[0]):
        keep = p if isinstance(p, Shard) else Replicate()
        per_dim.append([((keep,) * len(args), (keep,) * n_out)])
    return _per_dim_strategy(op_schema, per_dim)


#: the MoE's local ops (``models/moe.py``, expert parallelism) -> (index
#: of the argument whose dim 0 holds the token rows (entries), index of
#: the expert ids or None, per tensor argument its placement on a rows
#: mesh dim and on an experts mesh dim, the same per output, the index of
#: the first non-tensor argument)
_MOE_OPS: Dict[str, Tuple] = {
    "repro_torch::moe_expert_counts": (0, None, ((_S0, _R),), ((_S0, _R),), 1),
    "repro_torch::moe_positions": (0, None, ((_S0, _R), (_S0, _R)), ((_S0, _R),), 2),
    # xf, e_flat, pos_c, keep, ids -> the buffer
    "repro_torch::moe_dispatch": (
        1, 4, ((_S0, _R), (_S0, _R), (_S0, _R), (_S0, _R), (_R, _S0)), ((_P, _S0),), 5),
    # g_buf, e_flat, pos_c, keep, ids -> d xf
    "repro_torch::moe_dispatch_backward": (
        1, 4, ((_R, _S0), (_S0, _R), (_S0, _R), (_S0, _R), (_R, _S0)), ((_S0, _P),), 5),
    # out_e, e_flat, pos_c, w, ids -> y
    "repro_torch::moe_combine": (
        1, 4, ((_R, _S0), (_S0, _R), (_S0, _R), (_S0, _R), (_R, _S0)), ((_S0, _P),), 5),
    # g_y, out_e, e_flat, pos_c, w, ids -> d out_e, d w
    "repro_torch::moe_combine_backward": (
        2, 5, ((_S0, _R), (_R, _S0), (_S0, _R), (_S0, _R), (_S0, _R), (_R, _S0)),
        ((_P, _S0), (_S0, _P)), 6),
}


def _moe_strategy(rows_arg: int, ids_arg: Optional[int], ins: Tuple, outs: Tuple):
    """The one layout of a MoE local op: a mesh dim over which the
    ``rows_arg`` argument's dim 0 is sharded is a rows dim, one over which
    the ``ids_arg`` argument's is an experts dim, and each tensor takes
    its placement for that role (:data:`_MOE_OPS`); replicated on the
    other mesh dims."""

    def strategy(op_schema):
        rows = _placed(op_schema.args_schema[rows_arg])
        ids = _placed(op_schema.args_schema[ids_arg]) if ids_arg is not None else None
        per_dim = []
        for i, rp in enumerate(rows):
            role = 0 if _is_shard(rp, 0) else 1 if ids is not None and _is_shard(ids[i], 0) \
                else None
            if role is None:
                per_dim.append([((_R,) * len(ins), (_R,) * len(outs))])
            else:
                per_dim.append([(tuple(p[role] for p in ins), tuple(p[role] for p in outs))])
        return _per_dim_strategy(op_schema, per_dim)

    return strategy


#: plain ATen ops DTensor has no strategy for -> (strategy, static argnum)
_ATEN_STRATEGIES = {
    "searchsorted.Tensor": (_searchsorted_strategy, 2),
    "log_sigmoid_forward.default": (_pointwise_like_first, 100),
    "log_sigmoid_backward.default": (_pointwise_like_first, 100),
}


def register_kernel_shardings() -> None:
    """Give DTensor a strategy for every kernel op and opaque op the
    port's models reach (:data:`_ROW_OPS`, :data:`_HEAD_OPS`, fused
    linear), for the plain ops it lacks one for (:data:`_ATEN_STRATEGIES`)
    and for ``constrain``'s op (``distrib/actsharding.py``).  Idempotent;
    the ops are made when the
    kernel and model modules are imported, which this does first."""
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo

    from .. import models  # noqa: F401  (defines the opaque ops and the MoE's local ops)
    from ..kernels import (flash_attention, fused_linear, paged_attention,  # noqa: F401
                           rg_lru, rms_norm)
    from . import actsharding

    register = DTensor._op_dispatcher.sharding_propagator.register_op_strategy

    def op_of(qualname):
        ns, name = qualname.split("::")
        packet, _, overload = name.partition(".")
        return getattr(getattr(getattr(torch.ops, ns), packet), overload or "default")

    for qualname, rows in _ROW_OPS.items():
        if qualname in _REGISTERED:
            continue
        op = op_of(qualname)
        if len(rows) != len(op._schema.arguments):
            raise AssertionError(f"{qualname}: {len(rows)} rows for {op._schema}")
        outputs = _ROW_OUTPUTS.get(qualname, (True,) * len(op._schema.returns))
        register(op, _row_strategy(rows, outputs))
        _REGISTERED.add(qualname)
    tables = [(q, _head_strategy, n) for q, n in _HEAD_OPS.items()]
    tables.append(("repro_torch::fused_linear", _linear_strategy(_LINEAR_FWD), 3))
    tables.append(("repro_torch::fused_linear_backward", _linear_strategy(_LINEAR_BWD), 4))
    tables += [(q, _moe_strategy(*spec[:4]), spec[4]) for q, spec in _MOE_OPS.items()]
    tables += [(f"aten::{name}", fn, n) for name, (fn, n) in _ATEN_STRATEGIES.items()]
    for qualname, fn, static in tables:
        if qualname in _REGISTERED:
            continue
        register(op_of(qualname), fn, schema_info=RuntimeSchemaInfo(static_argnum=static))
        _REGISTERED.add(qualname)
    if "constrain" not in _REGISTERED:
        actsharding.register_constrain_strategy()
        _REGISTERED.add("constrain")
    if "strided_offsets" not in _REGISTERED:
        _real_strided_offsets()
        _REGISTERED.add("strided_offsets")


def _real_strided_offsets() -> None:
    """Make DTensor compute a strided shard's offsets on real tensors.

    Flattening (B, S) where B is split over one mesh dim and S over a
    later one (B / ``data`` smaller than ``model``: a prefill's 32 rows on
    16 data shards, a multi-pod batch) gives a ``_StridedShard``.
    DTensor plans a redistribution of one (and scores every strategy that
    would need one) by listing the shard's indices: ``arange(B·S)`` split
    and read back with ``tolist``.  Under ``FakeTensorMode`` (a dry run, a
    planned body's capture) that ``arange`` is fake, and ``tolist`` makes
    one unbacked symbol an element: minutes at S = 32768, and symbols that
    a later ``torch.export`` finds pending.  The indices depend on sizes
    only, so for a plain ``int`` size they are computed on a real tensor,
    with the same result, outside every dispatch mode (the dry run's
    counter sees no such op); a symbolic size is left to DTensor."""
    from torch.distributed.tensor import placement_types
    from torch.utils._python_dispatch import _disable_current_modes

    cls = getattr(placement_types, "_StridedShard", None)
    inner = getattr(cls, "local_shard_size_and_offset", None)
    if inner is None:
        return

    def local_shard_size_and_offset(self, curr_local_size, *args, **kwargs):
        if not isinstance(curr_local_size, int):
            return inner(self, curr_local_size, *args, **kwargs)
        with _disable_current_modes():
            return inner(self, curr_local_size, *args, **kwargs)

    cls.local_shard_size_and_offset = local_shard_size_and_offset


__all__ = ["P", "NamedSharding", "ShardingPlan", "plan_for", "safe_pspec", "dp_axes",
           "mesh_axis_size", "placements", "keystr", "distribute_tree", "replicate_plain",
           "register_kernel_shardings"]
