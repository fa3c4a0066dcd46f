"""Shape generalization — ShapeKeys and bucket policies (the port of the
JAX package's ``core/shapekey.py``, the part the paged serve fronts use).

A server sees a stream of calls whose polymorphic extents vary — the
batch size and, for prefill, the prompt length — but a Forge program is
specialised to its shapes (``torch.export`` freezes them).  This module
makes that specialisation an explicit, bounded compilation axis:

* a :class:`PolyAxis` names one polymorphic dimension of a program: an
  axis spec (``vmap``-``in_axes``-style tree prefix) marking which input
  dims carry it, and its own :class:`BucketPolicy` (``exact`` | ``pow2``
  | fixed ``ladder``) mapping a concrete extent to a canonical bucket
  extent;
* a :class:`ShapeKey` is the per-axis tuple of :class:`AxisKey` (policy,
  bucket extent, label) that keys a
  :class:`~repro_torch.core.compiler.BucketedModule`'s program table: one
  cell's program serves every call whose state is padded into it.

``infer_poly_axes`` derives a state tree's per-leaf batch axes by
differencing two instantiations (the contiguous fronts' cache axes).
The JAX module's pad-and-mask plans (``PadPlan``, ``pad_args``) are not
ported: the serve fronts hold bucket-shaped state themselves.  Axis
specs follow ``torch.utils._pytree``'s flatten order: a dict's leaves
come in insertion order (JAX sorts the keys).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
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
    def extents(self) -> Tuple[int, ...]:
        return tuple(a.extent for a in self.axes)

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
    in the inputs (``in_axes``) and the policy bounding its bucket set."""

    in_axes: AxisSpec = 0
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
# bucket transparency counters
# --------------------------------------------------------------------------


@dataclass
class BucketStats:
    """Bucket-hit / pad-waste counters of one BucketedModule.

    ``calls`` / ``rows_*`` / ``per_bucket_calls`` count dispatches;
    ``bucket_hits`` / ``compiles`` count program-table lookups.
    """

    calls: int = 0
    bucket_hits: int = 0
    compiles: int = 0
    compile_s: float = 0.0
    rows_real: int = 0
    rows_padded: int = 0
    per_bucket_calls: Dict[str, int] = field(default_factory=dict)
    #: ShapeKey str -> seconds its Phase 1-4 compile took
    per_bucket_compile_s: Dict[str, float] = field(default_factory=dict)

    def note_lookup(self, *, hit: bool, key: Optional[ShapeKey] = None,
                    compile_s: float = 0.0) -> None:
        if hit:
            self.bucket_hits += 1
        else:
            self.compiles += 1
            self.compile_s += compile_s
            if key is not None:
                self.per_bucket_compile_s[str(key)] = compile_s

    def note_dispatch(self, key: ShapeKey, n_valid: Union[int, Tuple[int, ...]],
                      extent: Union[int, Tuple[int, ...]]) -> None:
        """Record one dispatch; ``rows_*`` count cells (the product over
        axes) for N-D fronts."""
        valid = int(np.prod(n_valid))
        total = int(np.prod(extent))
        self.calls += 1
        self.rows_real += valid
        self.rows_padded += total - valid
        k = str(key)
        self.per_bucket_calls[k] = self.per_bucket_calls.get(k, 0) + 1
