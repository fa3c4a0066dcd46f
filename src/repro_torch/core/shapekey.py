"""Shape generalization — ShapeKeys, bucket policies, pad-and-mask plans
and bucket counters (the port of the JAX package's ``core/shapekey.py``).

A server sees a stream of calls whose polymorphic extents vary — the
batch size and, for prefill, the prompt length — but a Forge program is
specialised to its shapes (``torch.export`` freezes them).  This module
makes that specialisation an explicit, bounded compilation axis:

* a :class:`PolyAxis` names one polymorphic dimension of a program: axis
  specs (``vmap``-``in_axes``-style tree prefixes) marking which input
  and output dims carry it, and its own :class:`BucketPolicy` (``exact``
  | ``pow2`` | fixed ``ladder``) mapping a concrete extent to a
  canonical bucket extent;
* a :class:`ShapeKey` is the per-axis tuple of :class:`AxisKey` (policy,
  bucket extent, label) that keys a
  :class:`~repro_torch.core.compiler.BucketedModule`'s program table: one
  cell's program serves every call that pads into it;
* a :class:`PadPlan` pads a call's flat inputs up to the bucket extents
  along every polymorphic axis and slices the outputs back (the
  pad-and-mask call; ``pad_args`` pads a whole argument tree).

``infer_poly_axes`` derives a state tree's per-leaf batch axes by
differencing two instantiations (the contiguous fronts' cache axes).
``BucketStats`` keeps the bucket, pool, page and fault counters and the
recency trail of valid extents that :func:`propose_rungs` fits a ladder
re-fit to.  Axis specs follow ``torch.utils._pytree``'s flatten order: a
dict's leaves come in insertion order (JAX sorts the keys).
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

AxisSpec = Union[None, int, tuple, list, dict]


# --------------------------------------------------------------------------
# bucket policies
# --------------------------------------------------------------------------


class BucketPolicy:
    """Maps a concrete polymorphic extent to its canonical bucket extent."""

    name: str = "?"

    def bucket(self, n: int) -> int:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover
        return f"<bucket policy {self.name!r}>"


@dataclass(frozen=True, repr=False)
class ExactPolicy(BucketPolicy):
    """No generalization: one program per concrete extent (the baseline)."""

    name: str = field(default="exact", init=False)

    def bucket(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"polymorphic extent must be >= 1, got {n}")
        return n


@dataclass(frozen=True, repr=False)
class Pow2Policy(BucketPolicy):
    """Next power of two, floored at ``min_bucket``.

    The floor (default 2) trims the ladder's low end: a dedicated B=1
    program would cost a full compile to save one padded row, so B=1
    rides the B=2 bucket.  ``max_bucket`` (when set) is the admission
    bound — extents beyond it raise.
    """

    min_bucket: int = 2
    max_bucket: Optional[int] = None
    name: str = field(default="pow2", init=False)

    def bucket(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"polymorphic extent must be >= 1, got {n}")
        b = max(self.min_bucket, 1 << (n - 1).bit_length())
        if self.max_bucket is not None and b > self.max_bucket:
            if n <= self.max_bucket:
                return self.max_bucket
            raise ValueError(f"extent {n} exceeds max_bucket={self.max_bucket}")
        return b


@dataclass(frozen=True, repr=False)
class LadderPolicy(BucketPolicy):
    """Smallest rung of a fixed ladder that fits the extent."""

    rungs: Tuple[int, ...] = ()
    name: str = field(default="ladder", init=False)

    def __post_init__(self):
        if not self.rungs or list(self.rungs) != sorted(set(self.rungs)):
            raise ValueError(f"ladder rungs must be strictly increasing, got {self.rungs}")

    def bucket(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"polymorphic extent must be >= 1, got {n}")
        for r in self.rungs:
            if n <= r:
                return r
        raise ValueError(f"extent {n} exceeds top ladder rung {self.rungs[-1]} "
                         f"(admission bound)")


def get_bucket_policy(policy: Union[str, BucketPolicy]) -> BucketPolicy:
    """Resolve ``"exact" | "pow2" | "ladder:4,8,16"`` or pass through."""
    if isinstance(policy, BucketPolicy):
        return policy
    if policy == "exact":
        return ExactPolicy()
    if policy == "pow2":
        return Pow2Policy()
    if isinstance(policy, str) and policy.startswith("ladder:"):
        try:
            rungs = tuple(int(x) for x in policy[len("ladder:"):].split(","))
        except ValueError:
            raise ValueError(f"bad ladder spec {policy!r}") from None
        return LadderPolicy(rungs=rungs)
    raise ValueError(f"unknown bucket policy {policy!r}; "
                     f"available: exact | pow2 | ladder:<r1,r2,...>")


@dataclass(frozen=True)
class AxisKey:
    """One axis of a :class:`ShapeKey`: (policy name, bucket extent, label)."""

    policy: str
    extent: int
    label: str = "B"

    def __str__(self) -> str:
        return f"{self.policy}:{self.label}{self.extent}"


class ShapeKey:
    """Canonical name of one bucket cell: one :class:`AxisKey` per
    polymorphic dimension; the key of a BucketedModule's program table."""

    __slots__ = ("axes",)

    def __init__(self, axes: Sequence[AxisKey]):
        axes = tuple(axes)
        if not axes or not all(isinstance(a, AxisKey) for a in axes):
            raise ValueError(f"ShapeKey needs one AxisKey per polymorphic axis, got {axes!r}")
        object.__setattr__(self, "axes", axes)

    # immutable: ShapeKeys are dict keys of the program table
    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError(f"ShapeKey is immutable (tried to set {name!r})")

    def __delattr__(self, name: str) -> None:
        raise AttributeError(f"ShapeKey is immutable (tried to del {name!r})")

    @property
    def extent(self) -> int:
        """The first axis's extent (the 1-D view)."""
        return self.axes[0].extent

    @property
    def extents(self) -> Tuple[int, ...]:
        return tuple(a.extent for a in self.axes)

    @property
    def n_axes(self) -> int:
        return len(self.axes)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ShapeKey) and self.axes == other.axes

    def __hash__(self) -> int:
        return hash(self.axes)

    def __str__(self) -> str:
        return "x".join(str(a) for a in self.axes)

    def __repr__(self) -> str:  # pragma: no cover
        return f"ShapeKey({self.axes!r})"


@dataclass(frozen=True)
class PolyAxis:
    """One polymorphic dimension of a bucketed program: where it appears
    in the inputs (``in_axes``) and outputs (``out_axes``, the dims the
    pad-and-mask call slices back) and the policy bounding its bucket
    set."""

    in_axes: AxisSpec = 0
    out_axes: AxisSpec = 0
    policy: Union[str, BucketPolicy] = "pow2"
    label: str = "B"

    def __post_init__(self) -> None:
        object.__setattr__(self, "policy", get_bucket_policy(self.policy))


# --------------------------------------------------------------------------
# axis specs (vmap in_axes-style tree prefixes)
# --------------------------------------------------------------------------


def flatten_axes(spec: AxisSpec, tree: Any) -> List[Optional[int]]:
    """Broadcast a ``vmap``-style axis spec over ``tree``: one axis per leaf.

    ``spec`` may be an int / ``None`` (applies to every leaf below), or a
    tuple / list / dict mirroring the container structure of ``tree`` at
    that level (dicts in ``torch.utils._pytree``'s insertion order).
    """
    if spec is None or isinstance(spec, int):
        return [spec] * len(pytree.tree_leaves(tree))
    if isinstance(spec, (tuple, list)):
        if not isinstance(tree, (tuple, list)) or len(spec) != len(tree):
            raise ValueError(
                f"axis spec {type(spec).__name__}[{len(spec)}] does not match tree node "
                f"{type(tree).__name__}[{len(tree) if isinstance(tree, (tuple, list)) else '?'}]")
        out: List[Optional[int]] = []
        for s, t in zip(spec, tree):
            out.extend(flatten_axes(s, t))
        return out
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(spec) != set(tree):
            raise ValueError(f"axis spec keys {sorted(map(str, spec))} do not match tree keys "
                             f"{sorted(map(str, tree)) if isinstance(tree, dict) else '?'}")
        out = []
        for k in tree:  # torch's pytree flattens dicts in insertion order
            out.extend(flatten_axes(spec[k], tree[k]))
        return out
    raise ValueError(f"bad axis spec leaf {spec!r} (want int | None)")


def infer_extent(flat_leaves: Sequence[Any], flat_axes: Sequence[Optional[int]]) -> int:
    """The (single) polymorphic extent of a flat input list."""
    extent: Optional[int] = None
    for leaf, ax in zip(flat_leaves, flat_axes):
        if ax is None:
            continue
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))
        if ax >= len(shape):
            raise ValueError(f"polymorphic axis {ax} out of range for leaf shape {shape}")
        n = int(shape[ax])
        if extent is None:
            extent = n
        elif n != extent:
            raise ValueError(f"inconsistent polymorphic extents: {extent} vs {n} "
                             f"(axis {ax}, shape {shape})")
    if extent is None:
        raise ValueError("no batch-polymorphic inputs: the axis spec marks no leaf")
    return extent


def flatten_axes_nd(specs: Sequence[AxisSpec], tree: Any) -> List[Tuple[Optional[int], ...]]:
    """Per-leaf axis vectors for N polymorphic dimensions.

    ``specs`` holds one ``vmap``-style axis spec per polymorphic
    dimension; the result has one tuple per leaf of ``tree``, whose i-th
    entry is the leaf dim carrying polymorphic axis i (or None).  Two
    polymorphic dimensions may not claim the same dim of one leaf.
    """
    if not specs:
        raise ValueError("flatten_axes_nd needs at least one axis spec")
    per_axis = [flatten_axes(s, tree) for s in specs]
    leaves = [tuple(v) for v in zip(*per_axis)]
    for lv, leaf in zip(leaves, pytree.tree_leaves(tree)):
        marked = [a for a in lv if a is not None]
        # normalize negatives against the leaf's rank so e.g. 0 and -2 on
        # a 2-D leaf are caught as the same dim
        ndim = getattr(leaf, "ndim", None)
        if ndim is None:
            ndim = len(np.shape(leaf))
        norm = [a % ndim if ndim else a for a in marked]
        if len(norm) != len(set(norm)):
            raise ValueError(f"two polymorphic axes claim the same leaf dim: {lv}")
    return leaves


def infer_extents(flat_leaves: Sequence[Any], flat_axes_nd: Sequence[Tuple[Optional[int], ...]],
                  n_axes: int) -> Tuple[int, ...]:
    """Concrete extent of each of the N polymorphic axes."""
    return tuple(infer_extent(flat_leaves, [lv[i] for lv in flat_axes_nd])
                 for i in range(n_axes))


def infer_poly_axes(builder: Callable[[int], Any], n1: int = 2, n2: int = 3) -> Any:
    """Infer per-leaf batch axes of a pytree by differencing two builds.

    ``builder(n)`` must return the pytree instantiated for batch ``n``
    (e.g. ``lambda b: model.init_cache(cfg, b, max_len, device="meta")``;
    on the ``meta`` device, the analogue of ``jax.eval_shape``, nothing is
    allocated).  A leaf whose shape differs between the two builds in
    exactly one dimension — with extents ``n1`` / ``n2`` — is
    batch-polymorphic on that axis; a leaf with identical shapes is
    batch-free.  Returns an axes pytree of the same structure, usable as
    an ``in_axes`` spec.
    """
    t1, t2 = builder(n1), builder(n2)
    l1, td1 = pytree.tree_flatten(t1)
    l2, td2 = pytree.tree_flatten(t2)
    if td1 != td2:
        raise ValueError("builder returns different tree structures")
    axes: List[Optional[int]] = []
    for a, b in zip(l1, l2):
        s1, s2 = tuple(a.shape), tuple(b.shape)
        if len(s1) != len(s2):
            raise ValueError(f"leaf rank changed with batch: {s1} vs {s2}")
        diff = [i for i, (x, y) in enumerate(zip(s1, s2)) if x != y]
        if not diff:
            axes.append(None)
        elif len(diff) == 1 and s1[diff[0]] == n1 and s2[diff[0]] == n2:
            axes.append(diff[0])
        else:
            raise ValueError(f"cannot infer batch axis from shapes {s1} vs {s2}")
    return pytree.tree_unflatten(axes, td1)


# --------------------------------------------------------------------------
# pad-and-mask execution plans
# --------------------------------------------------------------------------


def _pad_leaf(x: Any, axis: Optional[int], extent: int, mode: str) -> Any:
    """``x`` padded to ``extent`` along ``axis``: ``edge`` repeats the last
    slice, ``zero`` appends zeros (any dtype, on the tensor's device)."""
    if axis is None:
        return x
    n = int(x.shape[axis])
    if n == extent:
        return x
    if n > extent:
        raise ValueError(f"extent {n} exceeds bucket extent {extent}")
    if mode not in ("edge", "zero"):
        raise ValueError(f"unknown pad mode {mode!r}")
    x = torch.as_tensor(x)
    shape = list(x.shape)
    shape[axis] = extent - n
    if mode == "edge":
        tail = x.narrow(axis, n - 1, 1).expand(shape)
    else:
        tail = x.new_zeros(shape)
    return torch.cat([x, tail], dim=axis)


def _slice_leaf(x: Any, axis: Optional[int], n_valid: int) -> Any:
    if axis is None or int(x.shape[axis]) == n_valid:
        return x
    return x.narrow(axis, 0, n_valid)


def _as_axis_tuple(v: Any) -> Tuple[Any, ...]:
    """Normalize a scalar (1-D) field to a 1-tuple."""
    return v if isinstance(v, tuple) else (v,)


@dataclass(frozen=True)
class PadPlan:
    """Pad flat inputs to the bucket extents; mask (slice) outputs back.

    ``n_valid`` / ``extent`` carry one entry per polymorphic axis, and
    each per-leaf axis entry is the tuple of leaf dims carrying those
    axes (None = axis absent from that leaf).  The 1-D form
    (``n_valid=3, extent=8, in_axes=(0, None)``) normalizes itself.  The
    "mask" is output-side slicing: padded rows and columns execute but
    their results never escape (DESIGN.md, the inertness argument).
    """

    n_valid: Tuple[int, ...]
    extent: Tuple[int, ...]
    in_axes: Tuple[Tuple[Optional[int], ...], ...]
    out_axes: Tuple[Tuple[Optional[int], ...], ...]
    mode: str = "edge"

    def __post_init__(self) -> None:
        object.__setattr__(self, "n_valid", _as_axis_tuple(self.n_valid))
        object.__setattr__(self, "extent", _as_axis_tuple(self.extent))
        if len(self.n_valid) != len(self.extent):
            raise ValueError(f"n_valid {self.n_valid} / extent {self.extent} axis "
                             f"count mismatch")
        n = len(self.extent)
        for name in ("in_axes", "out_axes"):
            leaves = tuple(_as_axis_tuple(lv) for lv in getattr(self, name))
            for lv in leaves:
                if len(lv) != n:
                    raise ValueError(f"{name} leaf entry {lv} does not carry {n} axes")
            object.__setattr__(self, name, leaves)

    @property
    def n_valid_cells(self) -> int:
        """Real cells per call: product of the valid extents."""
        return int(np.prod(self.n_valid))

    @property
    def n_padded(self) -> int:
        """Padding cells per call (bucket cells minus real cells)."""
        return int(np.prod(self.extent)) - self.n_valid_cells

    def _pad_one(self, x: Any, leaf_axes: Tuple[Optional[int], ...]) -> Any:
        for ext, ax in zip(self.extent, leaf_axes):
            x = _pad_leaf(x, ax, ext, self.mode)
        return x

    def _slice_one(self, x: Any, leaf_axes: Tuple[Optional[int], ...]) -> Any:
        for nv, ax in zip(self.n_valid, leaf_axes):
            x = _slice_leaf(x, ax, nv)
        return x

    def pad(self, flat_inputs: Sequence[Any]) -> List[Any]:
        if len(flat_inputs) != len(self.in_axes):
            raise ValueError(f"pad plan expects {len(self.in_axes)} inputs, "
                             f"got {len(flat_inputs)}")
        return [self._pad_one(x, lv) for x, lv in zip(flat_inputs, self.in_axes)]

    def unpad(self, flat_outputs: Sequence[Any]) -> List[Any]:
        if len(flat_outputs) != len(self.out_axes):
            raise ValueError(f"pad plan expects {len(self.out_axes)} outputs, "
                             f"got {len(flat_outputs)}")
        return [self._slice_one(x, lv) for x, lv in zip(flat_outputs, self.out_axes)]


def pad_args(args: Tuple[Any, ...], in_axes: Any, extent: Union[int, Tuple[int, ...]], *,
             mode: str = "edge") -> Tuple[Any, ...]:
    """Pad a pytree argument tuple up to the bucket extents.

    ``extent`` an int: ``in_axes`` is one ``vmap``-style spec (1-D);
    ``extent`` a tuple: ``in_axes`` is a same-length sequence of specs,
    one per polymorphic axis.
    """
    if isinstance(extent, tuple):
        specs, extents = tuple(in_axes), extent
    else:
        specs, extents = (in_axes,), (extent,)
    flat, spec = pytree.tree_flatten(args)
    axes_nd = flatten_axes_nd(specs, args)
    padded = []
    for x, lv in zip(flat, axes_nd):
        for ext, ax in zip(extents, lv):
            x = _pad_leaf(x, ax, ext, mode)
        padded.append(x)
    return pytree.tree_unflatten(padded, spec)


# --------------------------------------------------------------------------
# bucket transparency counters
# --------------------------------------------------------------------------


@dataclass
class BucketStats:
    """Bucket-hit / pad-waste / compile-split / pool counters of one
    BucketedModule.

    ``calls`` / ``rows_*`` / ``per_bucket_calls`` count dispatches;
    ``bucket_hits`` / ``compiles`` count program-table lookups.  Updates
    are lock-folded: compile-service workers and the serving thread
    update one object.
    """

    calls: int = 0
    bucket_hits: int = 0
    compiles: int = 0
    compile_s: float = 0.0
    #: request-visible compile stall: seconds a *dispatching* caller spent
    #: blocked on a cold-bucket build (an inline compile, the build-lock
    #: convoy, or an async future it had to wait out).  Disjoint from
    #: ``compile_background_s`` — the split the async path is judged by
    compile_wait_s: float = 0.0
    #: compile seconds absorbed by CompileService workers off the request
    #: path (also folded into ``compile_s``)
    compile_background_s: float = 0.0
    #: dispatches served by a warm dominating bucket while the exact
    #: bucket compiled in the background
    fallback_calls: int = 0
    #: extra padded cells those fallback dispatches executed beyond what
    #: the exact bucket would have padded (the fallback premium)
    fallback_cells_padded: int = 0
    rows_real: int = 0
    rows_padded: int = 0
    per_bucket_calls: Dict[str, int] = field(default_factory=dict)
    #: ShapeKey str -> seconds its Phase 1-4 compile took
    per_bucket_compile_s: Dict[str, float] = field(default_factory=dict)
    #: monotonic dispatch counter — the clock of the recency trail
    dispatch_seq: int = 0
    #: ShapeKey str -> dispatch_seq of that bucket's latest dispatch (the
    #: traffic signal BucketedModule.evict_cold retires against)
    per_bucket_last_dispatch: Dict[str, int] = field(default_factory=dict)
    #: programs retired by evict_cold (their recency trail is dropped too)
    evictions: int = 0
    # -- per-bucket buffer pool counters (BufferPool) ----------------------
    #: acquisitions satisfied by a pooled buffer set
    pool_hits: int = 0
    #: acquisitions that had to build fresh buffers (cold bucket / overlap)
    pool_misses: int = 0
    #: device bytes served from the pool instead of freshly allocated
    pool_bytes_reused: int = 0
    # -- paged-KV pool counters (filled by the paged slot scheduler) -------
    #: KV pages currently referenced (PagePool.pages_in_use snapshot)
    kv_pages_in_use: int = 0
    #: page-pool capacity (allocatable pages; excludes the trash page)
    kv_pages_capacity: int = 0
    #: high-water mark of pages in use across the run
    kv_peak_pages_in_use: int = 0
    #: prefix-tree lookups that matched at least one full page
    kv_prefix_hits: int = 0
    #: prompt tokens whose prefill was skipped via shared-prefix pages
    kv_tokens_reused: int = 0
    # -- fault-tolerance counters (runtime.chaos + the slot scheduler) -----
    #: faults the installed FaultPlan fired across all sites
    faults_injected: int = 0
    #: requests that terminated with a typed error outcome
    requests_failed: int = 0
    #: scheduler ticks served in degraded mode (shed admissions, warm
    #: rungs only) after a tick failure or a watchdog trip
    ticks_degraded: int = 0
    #: tick dispatches re-run after a contained dispatch fault
    dispatch_retries: int = 0
    #: sliding window of recent valid per-axis extents (the observed
    #: distribution :func:`propose_rungs` fits a ladder to); bounded so a
    #: long-running server's trail stays O(1)
    recent_extents: deque = field(default_factory=lambda: deque(maxlen=512))

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def note_fault(self, *, injected: int = 0, request_failed: bool = False,
                   tick_degraded: bool = False, retries: int = 0) -> None:
        """Fold fault-tolerance events (scheduler-side)."""
        with self._lock:
            self.faults_injected += injected
            if request_failed:
                self.requests_failed += 1
            if tick_degraded:
                self.ticks_degraded += 1
            self.dispatch_retries += retries

    def note_lookup(self, *, hit: bool, key: Optional[ShapeKey] = None,
                    compile_s: float = 0.0, background: bool = False) -> None:
        with self._lock:
            if hit:
                self.bucket_hits += 1
                return
            self.compiles += 1
            self.compile_s += compile_s
            if background:
                self.compile_background_s += compile_s
            if key is not None:
                self.per_bucket_compile_s[str(key)] = compile_s

    def note_wait(self, wait_s: float) -> None:
        """Fold one request-visible compile stall into the split."""
        with self._lock:
            self.compile_wait_s += wait_s

    def note_fallback(self, cells_extra: int) -> None:
        with self._lock:
            self.fallback_calls += 1
            self.fallback_cells_padded += int(cells_extra)

    def note_pool(self, *, hit: bool, nbytes: int = 0) -> None:
        with self._lock:
            if hit:
                self.pool_hits += 1
                self.pool_bytes_reused += nbytes
            else:
                self.pool_misses += 1

    def note_dispatch(self, key: ShapeKey, n_valid: Union[int, Tuple[int, ...]],
                      extent: Union[int, Tuple[int, ...]]) -> None:
        """Record one dispatch; ``rows_*`` count cells (the product over
        axes) for N-D fronts."""
        valid_axes = _as_axis_tuple(n_valid)
        valid = int(np.prod(valid_axes))
        total = int(np.prod(_as_axis_tuple(extent)))
        with self._lock:
            if valid > 0:  # warmup / throwaway dispatches carry n_valid=0
                self.recent_extents.append(valid_axes)
            self.calls += 1
            self.rows_real += valid
            self.rows_padded += total - valid
            k = str(key)
            self.per_bucket_calls[k] = self.per_bucket_calls.get(k, 0) + 1
            # a monotonic counter rather than wall time, so "least recently
            # dispatched" is deterministic and testable
            self.dispatch_seq += 1
            self.per_bucket_last_dispatch[k] = self.dispatch_seq

    def note_eviction(self, key: ShapeKey) -> None:
        """Drop a retired bucket's recency trail (evict_cold)."""
        with self._lock:
            self.evictions += 1
            self.per_bucket_last_dispatch.pop(str(key), None)

    @property
    def hit_rate(self) -> float:
        total = self.bucket_hits + self.compiles
        return self.bucket_hits / total if total else 0.0

    @property
    def pad_waste(self) -> float:
        """Fraction of executed cells (rows x ... per axis) that were
        padding."""
        total = self.rows_real + self.rows_padded
        return self.rows_padded / total if total else 0.0

    @property
    def pool_hit_rate(self) -> float:
        total = self.pool_hits + self.pool_misses
        return self.pool_hits / total if total else 0.0


def propose_rungs(observed: Sequence[int], max_rungs: int = 4, *,
                  cap: Optional[int] = None) -> Tuple[int, ...]:
    """Propose ladder rungs fitting an observed extent distribution.

    ``observed`` is a recency trail of valid extents (one axis of
    :attr:`BucketStats.recent_extents`).  Rungs sit at evenly spaced
    quantiles of the distribution, so each rung absorbs about the same
    share of recent traffic.  The top rung always covers
    ``max(observed)``, and ``cap`` when given (the scheduler's admission
    bound), so a re-fit never shrinks the ladder below what admission may
    request.  Returns a strictly increasing tuple for :class:`LadderPolicy`.
    """
    if max_rungs < 1:
        raise ValueError(f"max_rungs must be >= 1, got {max_rungs}")
    vals = sorted(int(v) for v in observed if int(v) > 0)
    if not vals:
        if cap is None:
            raise ValueError("propose_rungs needs observations or a cap")
        return (int(cap),)
    top = max(vals[-1], int(cap) if cap is not None else 0)
    rungs = set()
    for i in range(1, max_rungs):
        q = vals[min(len(vals) - 1, (i * len(vals)) // max_rungs)]
        if q < top:
            rungs.add(q)
    rungs.add(top)
    return tuple(sorted(rungs))
