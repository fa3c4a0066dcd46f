"""The ForgeCompiler — four-phase orchestration (paper Figure 1).

``ForgeCompiler.compile(fn, *example_args)`` runs

  Phase 1  capture          trace_to_graph (torch.export, tied weights)
  Phase 2  optimization     run_forge_passes (fixpoint)
  Phase 3  lowering         lower_to_rgir (typed register IR)
  Phase 4  analysis+codegen backend build (scheduling, liveness,
                            linear-scan allocation, executor)

and returns a :class:`CompiledModule` — callable on the same pytree
signature as ``fn`` — plus the transparent :class:`CompilationResult`
(nodes before/after, the cost model's breakdown and fused-op counts,
per-pass profile, buffer and transition statistics, phase timings).
A :class:`~repro_torch.core.passes.PipelineConfig` sets Phase 2 (α, λ,
π, ι, pass enables) and the default backend.

Phase 4 goes through the content-addressed compile cache
(``core/cache.py``): a build is memoized under the lowered program's
RGIR fingerprint, in memory and, with a store attached, on disk.  Phases
1-4 of every compile run under one process-wide build lock
(:data:`BUILD_LOCK`): concurrent ``torch.export`` calls from compile
workers are not known to be sound.

``ForgeCompiler.compile_bucketed`` builds a :class:`BucketedModule`: one
compiled program per :class:`~repro_torch.core.shapekey.ShapeKey` cell,
resolved by the call's extents (the serve fronts' shape generalization),
called pad-and-mask, optionally compiled in the background by a
:class:`~repro_torch.core.compile_service.CompileService` while calls
pad into the nearest warm dominating bucket, with a per-bucket
:class:`BufferPool`; ``BucketedModule.refit_policy`` swaps an axis's
ladder in place under the old policy name (the scheduler's re-fit).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .backends import ExecutorLike, get_backend
from .cache import (
    CompileCache,
    UncacheableProgram,
    fingerprint_program,
    get_compile_cache,
    make_cache_key,
)
from .capture import CaptureResult, trace_to_graph
from .compile_service import CompileService, get_compile_service
from .cost_model import CostBreakdown, score_graph
from .executor import ExecutorStats
from .graph import Graph
from .lowering import RGIRProgram, lower_to_rgir
from .passes import PassRecord, PipelineConfig, run_forge_passes
from .shapekey import (
    AxisKey,
    AxisSpec,
    BucketPolicy,
    BucketStats,
    PadPlan,
    PolyAxis,
    ShapeKey,
    flatten_axes,
    flatten_axes_nd,
    get_bucket_policy,
    infer_extent,
    pad_args,
)

#: one compile at a time in the process: Phases 1-4 of
#: :meth:`ForgeCompiler.compile` (re-entrant: a step's first eager run
#: compiles its block bodies under it)
BUILD_LOCK = threading.RLock()


@dataclass
class CompilationResult:
    """The paper's transparency struct (§1.3 Limitation 2)."""

    nodes_before: int = 0
    nodes_after: int = 0
    fused_ops: int = 0
    attention_fused: int = 0
    pass_records: List[PassRecord] = field(default_factory=list)
    # phase timings (ms)
    capture_ms: float = 0.0
    optimize_ms: float = 0.0
    lower_ms: float = 0.0
    backend_ms: float = 0.0
    total_ms: float = 0.0
    executor_stats: Optional[ExecutorStats] = None
    #: the cost model's breakdown of the optimized graph (paper Eq. 18)
    cost: Optional[CostBreakdown] = None
    tied_weights: int = 0
    #: the Phase-2 configuration the program was compiled under
    config: Optional[PipelineConfig] = None
    impl: Optional[str] = None
    backend: str = "interpret"
    #: compile-cache provenance: Phase 4 came from the cache (memory or
    #: disk); from the disk tier (executor rebuilt from a stored entry)
    cache_hit: bool = False
    cache_disk_hit: bool = False
    cache_key: Optional[str] = None
    #: the compiler's cache counters when this compile finished
    cache_hits: int = 0
    cache_misses: int = 0
    #: the bucket cell this program serves (BucketedModule), else None
    shape_key: Optional[str] = None
    #: seconds of Phase 4 spent on the warm run and the CUDA graph
    #: captures (segment_jit on the card; 0 elsewhere), inside backend_ms
    capture_s: float = 0.0

    @property
    def node_reduction(self) -> float:
        if self.nodes_before == 0:
            return 0.0
        return 1.0 - self.nodes_after / self.nodes_before

    def pass_table(self) -> List[Dict[str, Any]]:
        """Aggregated per-pass rows (paper Table 10)."""
        agg: Dict[str, Dict[str, Any]] = {}
        for r in self.pass_records:
            row = agg.setdefault(r.name, {"pass": r.name, "time_ms": 0.0,
                                          "delta_nodes": 0, "runs": 0, "detail": {}})
            row["time_ms"] += r.time_ms
            row["delta_nodes"] += r.node_delta
            row["runs"] += 1
            for k, v in r.detail.items():
                if isinstance(v, (int, float)):
                    row["detail"][k] = row["detail"].get(k, 0) + v
        return list(agg.values())

    def summary(self) -> str:
        lines = [
            f"nodes: {self.nodes_before} -> {self.nodes_after} "
            f"({-100 * self.node_reduction:+.1f}%)",
            f"fused ops: {self.fused_ops} (attention: {self.attention_fused})",
            f"phases (ms): capture={self.capture_ms:.1f} optimize={self.optimize_ms:.1f} "
            f"lower={self.lower_ms:.1f} backend={self.backend_ms:.1f} "
            f"total={self.total_ms:.1f}",
        ]
        if self.executor_stats:
            s = self.executor_stats
            lines.append(
                f"vregs={s.n_vregs} buffers={s.n_buffers} rho_buf={s.rho_buf:.1%} "
                f"delta {s.delta_before}->{s.delta_after} "
                f"(-{s.transition_reduction:.1%}) segments={s.n_segments} "
                f"backend={self.backend} cache={'hit' if self.cache_hit else 'miss'}"
                + (f" bucket={self.shape_key}" if self.shape_key else "")
            )
        return "\n".join(lines)


class CompiledModule:
    """A compiled function: pytree-aware wrapper over the executor.

    ``program`` is the lowered RGIR program (Phase 3's output) and
    ``static_inputs`` / ``input_names`` the parameter positions among its
    flat inputs: :meth:`with_backend` builds another Phase 4 from them
    without capturing the function again."""

    def __init__(self, executor: ExecutorLike, capture: CaptureResult,
                 result: CompilationResult, graph: Graph, *,
                 program: Optional[RGIRProgram] = None,
                 static_inputs: Tuple[int, ...] = (),
                 input_names: Optional[List[str]] = None,
                 reorder: bool = True):
        self.executor = executor
        self.capture = capture
        self.result = result
        self.graph = graph
        self.program = program
        self.static_inputs = static_inputs
        self.input_names = input_names
        self.reorder = reorder

    def with_backend(self, backend: str) -> "CompiledModule":
        """The same lowered program on another Phase-4 backend (a fresh
        executor; on the card, segment_jit captures at its first call)."""
        if self.program is None:
            raise ValueError("this module keeps no lowered program")
        executor = get_backend(backend).build(self.program, static_inputs=self.static_inputs,
                                              input_names=self.input_names,
                                              reorder=self.reorder)
        result = dataclasses.replace(self.result, backend=backend,
                                     executor_stats=executor.stats, capture_s=0.0)
        return CompiledModule(executor, self.capture, result, self.graph,
                              program=self.program, static_inputs=self.static_inputs,
                              input_names=self.input_names, reorder=self.reorder)

    @staticmethod
    def _flatten_inputs_of(capture: CaptureResult, args: Sequence[Any]) -> List[Any]:
        flat, spec = pytree.tree_flatten(tuple(args))
        return CompiledModule._filter_flat_of(capture, flat, spec)

    @staticmethod
    def _filter_flat_of(capture: CaptureResult, flat: List[Any], spec: Any) -> List[Any]:
        """Validate a pre-flattened input list and drop tied duplicates."""
        if spec != capture.in_spec:
            raise TypeError(f"input pytree mismatch: expected {capture.in_spec}, "
                            f"got {spec}")
        tied = capture.tied_map
        if tied:
            flat = [x for i, x in enumerate(flat) if i not in tied]
        return flat

    def _flatten_inputs(self, args: Sequence[Any]) -> List[Any]:
        return self._flatten_inputs_of(self.capture, args)

    def _filter_flat_inputs(self, flat: List[Any], spec: Any) -> List[Any]:
        return self._filter_flat_of(self.capture, flat, spec)

    def _unflatten_outputs(self, outs: List[Any]) -> Any:
        return pytree.tree_unflatten(outs, self.capture.out_spec)

    def __call__(self, *args: Any) -> Any:
        """Interpreted flat-dispatch execution (paper Listing 9)."""
        outs = self.executor.execute(*self._flatten_inputs(args))
        return pytree.tree_unflatten(outs, self.capture.out_spec)

    def as_fn(self) -> Callable:
        """Callable on the original pytree signature."""
        return self.__call__

    @property
    def stats(self) -> ExecutorStats:
        return self.executor.stats


def _static_inputs(cap: CaptureResult, args: Sequence[Any],
                   static_argnums: Sequence[int]) -> Tuple[Tuple[int, ...], List[str]]:
    """Positions of the leaves of ``args[i]`` (i in ``static_argnums``)
    among the program's flat inputs (tied duplicates dropped), and every
    flat input's name (its pytree path, e.g. ``args[0]['embed']``)."""
    paths, _ = pytree.tree_flatten_with_path(tuple(args))
    raw_static = set()
    offset = 0
    for i, a in enumerate(args):
        n = len(pytree.tree_leaves(a))
        if i in static_argnums:
            raw_static.update(range(offset, offset + n))
        offset += n
    keep = [i for i in range(len(paths)) if i not in cap.tied_map]
    names = [f"args{pytree.keystr(paths[i][0])}" for i in keep]
    return tuple(j for j, i in enumerate(keep) if i in raw_static), names


class ForgeCompiler:
    """Four-phase compiler facade (paper Figure 1).

    ``config`` sets Phase 2 (:class:`PipelineConfig`; its ``impl`` is
    forwarded into the fused nodes: None dispatches by device, ``"ref"``
    runs the kernels' plain versions); ``impl`` is a shorthand for
    ``config.impl``.  Phase 4 is delegated to the pluggable
    :class:`~repro_torch.core.backends.Backend` named by ``backend``
    (``interpret`` | ``reference`` | ``segment_jit``), which wins over
    ``config.backend``.  ``reorder=False`` is the unscheduled build:
    liveness and allocation run on the program order.  The backend build
    is memoized in ``cache`` (default: the process-global
    :func:`~repro_torch.core.cache.get_compile_cache` when
    ``config.compile_cache``), keyed by the lowered program's RGIR
    fingerprint.
    """

    def __init__(self, config: Optional[PipelineConfig] = None, *, reorder: bool = True,
                 backend: Optional[str] = None, impl: Optional[str] = None,
                 cache: Optional[CompileCache] = None):
        config = config or PipelineConfig()
        if impl is not None:
            config = dataclasses.replace(config, impl=impl)
        self.config = config
        self.impl = config.impl
        self.reorder = reorder
        self.backend_name = backend or config.backend
        get_backend(self.backend_name)  # fail fast on unknown names
        self.cache = cache if cache is not None else (
            get_compile_cache() if config.compile_cache else None)

    def compile(self, fn: Callable, *example_args: Any,
                shape_key: Optional[ShapeKey] = None,
                static_argnums: Sequence[int] = ()) -> CompiledModule:
        """Compile ``fn`` specialised to ``example_args``' shapes, dtypes
        and device.  ``shape_key`` names the bucket cell when a
        :class:`BucketedModule` compiles (it joins the compile-cache key).
        ``static_argnums`` names the arguments that are parameters: a
        backend that captures the program on the card (segment_jit, which
        captures here, from the example arguments) reads them at the
        caller's address and refuses a call that moved them."""
        with BUILD_LOCK:
            return self._compile(fn, example_args, shape_key, static_argnums)

    def _phase4(self, prog: RGIRProgram, static: Tuple[int, ...], names: List[str],
                flat_example: List[Any], shape_key: Optional[ShapeKey]):
        """(executor, cache_hit, disk_hit, cache_key): a memory hit (the
        backend adopts it for this caller), a disk hit (rebuilt from the
        stored analysis against ``prog``), or a full build, stored."""
        backend = get_backend(self.backend_name)
        if self.cache is None:
            return backend.build(prog, static_inputs=static, input_names=names,
                                 reorder=self.reorder), False, False, None
        try:
            cache_key = make_cache_key(self.backend_name, self.reorder,
                                       fingerprint_program(prog), shape_key)
        except UncacheableProgram:
            # traced constants (a compile inside an enclosing trace): no
            # stable content address, bypass the cache
            return backend.build(prog, static_inputs=static, input_names=names,
                                 reorder=self.reorder), False, False, None
        from_disk: List[bool] = []

        def loader(entry):
            ex = backend.build_from_entry(prog, entry, static_inputs=static,
                                          input_names=names, reorder=self.reorder)
            if ex is not None:
                from_disk.append(True)
            return ex

        executor = self.cache.get(cache_key, loader if self.cache.store is not None else None)
        if executor is not None:
            if not from_disk:
                executor = backend.adopt(executor, static_inputs=static, input_names=names,
                                         flat_inputs=flat_example)
            return executor, True, bool(from_disk), cache_key
        executor = backend.build(prog, static_inputs=static, input_names=names,
                                 reorder=self.reorder)
        disk_entry = None
        if self.cache.store is not None:
            try:
                disk_entry = backend.export_entry(prog, executor)
            except Exception:
                disk_entry = None
        self.cache.put(cache_key, executor, disk_entry=disk_entry)
        return executor, False, False, cache_key

    def _compile(self, fn: Callable, example_args: Tuple[Any, ...],
                 shape_key: Optional[ShapeKey], static_argnums: Sequence[int]) -> CompiledModule:
        t_total = time.perf_counter()

        cap = trace_to_graph(fn, *example_args)  # Phase 1
        g = cap.graph
        nodes_before = g.num_nodes()

        t0 = time.perf_counter()  # Phase 2
        records = run_forge_passes(g, cfg=self.config)
        optimize_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()  # Phase 3
        prog = lower_to_rgir(g)
        lower_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()  # Phase 4 (a compile-cache hit: a lookup)
        static, names = _static_inputs(cap, example_args, static_argnums)
        flat_example = CompiledModule._flatten_inputs_of(cap, example_args)
        executor, cache_hit, disk_hit, cache_key = self._phase4(prog, static, names,
                                                                flat_example, shape_key)
        prepare = getattr(executor, "prepare", None)
        if prepare is not None:  # segment_jit: capture on the card now
            prepare(*flat_example)
        backend_ms = (time.perf_counter() - t0) * 1e3

        cost = score_graph(g, self.config.precision)
        result = CompilationResult(
            nodes_before=nodes_before,
            nodes_after=g.num_nodes(),
            fused_ops=cost.n_fused,
            attention_fused=cost.n_attn_fused,
            pass_records=records,
            capture_ms=cap.capture_ms,
            optimize_ms=optimize_ms,
            lower_ms=lower_ms,
            backend_ms=backend_ms,
            total_ms=(time.perf_counter() - t_total) * 1e3,
            # on a hit the executor may be shared: report its analysis
            # stats but not the run counters other modules accumulated
            executor_stats=(executor.stats.fresh_snapshot() if cache_hit
                            else executor.stats),
            cost=cost,
            tied_weights=len(cap.tied_map),
            config=self.config,
            impl=self.impl,
            backend=self.backend_name,
            cache_hit=cache_hit,
            cache_disk_hit=disk_hit,
            cache_key=cache_key,
            cache_hits=self.cache.stats.hits if self.cache else 0,
            cache_misses=self.cache.stats.misses if self.cache else 0,
            shape_key=str(shape_key) if shape_key is not None else None,
            capture_s=executor.stats.capture_s,
        )
        return CompiledModule(executor, cap, result, g, program=prog, static_inputs=static,
                              input_names=names, reorder=self.reorder)

    def compile_bucketed(
        self,
        fn: Callable,
        *example_args: Any,
        axes: Optional[Sequence[PolyAxis]] = None,
        in_axes: AxisSpec = 0,
        out_axes: AxisSpec = 0,
        policy: Union[str, BucketPolicy] = "pow2",
        pad_mode: str = "edge",
        prime: bool = False,
        static_argnums: Sequence[int] = (),
        async_compile: bool = False,
        service: Optional[CompileService] = None,
    ) -> "BucketedModule":
        """A shape-generalized multi-program front over ``fn``.

        ``axes`` holds one :class:`PolyAxis` per polymorphic dimension
        (e.g. batch × sequence for whole-prompt prefill); the 1-D short
        form ``in_axes``/``out_axes``/``policy`` marks one batch axis.
        With ``example_args`` their cell compiles now; otherwise the
        first call per cell pays the compile (or, with
        ``async_compile``, a background worker does).  ``prime`` runs
        ``fn`` once eagerly before each capture (see
        :class:`BucketedModule`); ``static_argnums`` goes to every cell's
        :meth:`compile`.
        """
        mod = BucketedModule(self, fn, axes=axes, in_axes=in_axes, out_axes=out_axes,
                             policy=policy, pad_mode=pad_mode, prime=prime,
                             static_argnums=static_argnums, async_compile=async_compile,
                             service=service)
        if example_args:
            mod.program_for(*example_args)
        return mod


def _tree_nbytes(tree: Any) -> int:
    """Total bytes of the tensors of a pytree."""
    return sum(int(t.numel()) * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def bucket_pool_key(key: ShapeKey) -> Any:
    """Canonical :class:`BufferPool` key of one bucket program.

    The one contract shared by pool writers and reapers: the serve path
    parks caches under the bucket's batch extent (``key.extent``, a plain
    int — what ``policy.bucket(B)`` hands it before a ShapeKey exists),
    N-D fronts under the full extents tuple.
    :meth:`BucketedModule.evict_cold` releases through the same helper,
    so a keying change cannot strand pooled buffers.
    """
    return key.extent if key.n_axes == 1 else key.extents


class BufferPool:
    """Per-bucket buffer pool (DESIGN.md §Buffer pooling).

    Repeat admissions to a bucket would build bucket-sized pytrees (the
    serve path's KV cache) on every acquisition; this pool keeps released
    sets on a per-key free list so the next admission to the same bucket
    reuses the device buffers.  Keys are arbitrary hashables — the serve
    path keys by bucket extent.

    ``acquire(key, build, reset=...)`` pops a pooled set and passes it
    through ``reset`` (the serve path's in-place refill of the init
    values, so the device buffers are recycled in place); a miss — a cold
    bucket, or more concurrent generations than pooled sets — calls
    ``build()``.  A failing ``reset`` falls back to ``build()`` rather
    than failing the admission.  Hit / miss / bytes counters fold into
    the owning :class:`BucketStats`.
    """

    def __init__(self, stats: Optional[BucketStats] = None, *, max_per_key: int = 4):
        self.stats = stats if stats is not None else BucketStats()
        self.max_per_key = max_per_key
        self._free: Dict[Any, List[Any]] = {}
        self._nbytes: Dict[Any, int] = {}
        self._lock = threading.Lock()

    def acquire(self, key: Any, build: Callable[[], Any],
                reset: Optional[Callable[[Any], Any]] = None) -> Any:
        with self._lock:
            entries = self._free.get(key)
            tree = entries.pop() if entries else None
        if tree is not None and reset is not None:
            try:
                tree = reset(tree)
            except Exception:  # unresettable buffers: rebuild below
                tree = None
        if tree is None:
            tree = build()
            with self._lock:
                self._nbytes.setdefault(key, _tree_nbytes(tree))
            self.stats.note_pool(hit=False)
            return tree
        self.stats.note_pool(hit=True, nbytes=self._nbytes.get(key, 0))
        return tree

    def release(self, key: Any, tree: Any) -> None:
        """Return a buffer set to ``key``'s free list (dropped when full)."""
        if tree is None:
            return
        with self._lock:
            entries = self._free.setdefault(key, [])
            if len(entries) < self.max_per_key:
                entries.append(tree)

    def pooled(self, key: Any) -> int:
        """Free-list depth of ``key``."""
        with self._lock:
            entries = self._free.get(key)
            return len(entries) if entries else 0

    def drop(self, key: Any) -> int:
        """Release ``key``'s free list (cold-bucket eviction); returns the
        number of sets dropped.  A no-op for unknown keys."""
        with self._lock:
            entries = self._free.pop(key, None)
            self._nbytes.pop(key, None)
        return len(entries) if entries else 0


class BucketedModule:
    """Shape-generalized multi-program front (DESIGN.md §Shape).

    Holds a per-bucket program table over N polymorphic axes: a call with
    concrete extents ``(n_1, …, n_N)`` goes by its :class:`ShapeKey`
    (per-axis ``policy.bucket(n_i)``) to the cell's compiled program —
    Phases 1-4 run on the first miss only — and runs pad-and-mask
    (:meth:`__call__`): inputs padded up to the bucket extents along every
    polymorphic axis, outputs sliced back to the valid rows and columns.
    The serve fronts hold bucket-shaped state themselves and resolve
    programs with :meth:`program_for`, which takes bucket-shaped
    arguments only.  The table is bounded by the product of the per-axis
    policies.

    ``async_compile``: a cold dispatch submits its exact key to the
    :class:`CompileService` and pads into the nearest warm dominating
    bucket instead of blocking; it blocks only when no warm bucket
    dominates the call (the first program).

    ``prime=True`` calls ``fn`` once eagerly on a cell's arguments
    before capturing it: a step that calls Forge-compiled block bodies
    (``models/_forge.py``) compiles them at their first call, and one
    ``torch.export`` cannot run inside another, so they must compile
    before the capture traces through their executors.

    Axis specs may be per-leaf trees (the contiguous fronts mark each
    cache leaf's batch axis, from ``shapekey.infer_poly_axes``).  The JAX
    package's ladder re-fit (``refit_policy``) waits for the SLO
    scheduler.
    """

    def __init__(self, compiler: ForgeCompiler, fn: Callable, *,
                 axes: Optional[Sequence[PolyAxis]] = None, in_axes: AxisSpec = 0,
                 out_axes: AxisSpec = 0, policy: Union[str, BucketPolicy] = "pow2",
                 pad_mode: str = "edge", prime: bool = False,
                 static_argnums: Sequence[int] = (), async_compile: bool = False,
                 service: Optional[CompileService] = None):
        self.compiler = compiler
        self.fn = fn
        self.prime = prime
        self.static_argnums = tuple(static_argnums)
        self.async_compile = bool(async_compile)
        self.service: Optional[CompileService] = (
            service if service is not None
            else (get_compile_service() if async_compile else None))
        if axes is None:
            axes = (PolyAxis(in_axes=in_axes, out_axes=out_axes, policy=policy),)
        self.axes: Tuple[PolyAxis, ...] = tuple(axes)
        if not self.axes:
            raise ValueError("BucketedModule needs at least one PolyAxis")
        self.policy = self.axes[0].policy
        self.pad_mode = pad_mode
        self.programs: Dict[ShapeKey, CompiledModule] = {}
        self.stats = BucketStats()
        #: per-bucket buffer pool (counters fold into ``stats``): the serve
        #: path parks each generation's KV cache here
        self.pool = BufferPool(self.stats)
        self._plans: Dict[ShapeKey, Tuple[Tuple[Tuple[Optional[int], ...], ...], ...]] = {}
        self._lock = threading.Lock()
        #: per-key build locks: concurrent first dispatches to one cold
        #: bucket wait for one build instead of duplicating it
        self._build_locks: Dict[ShapeKey, threading.Lock] = {}

    # -- dispatch ---------------------------------------------------------

    def shape_key_for(self, *args: Any) -> Tuple[ShapeKey, Any]:
        """(ShapeKey, concrete extent(s)) of an argument tuple: the extent
        is an int for 1-D fronts, a per-axis tuple for N-D fronts."""
        key, ns = self._shape_key_flat(pytree.tree_leaves(args), args)
        return key, (ns[0] if len(ns) == 1 else ns)

    def _shape_key_flat(self, flat: List[Any], args: Tuple[Any, ...]
                        ) -> Tuple[ShapeKey, Tuple[int, ...]]:
        ns: List[int] = []
        keys: List[AxisKey] = []
        for pa in self.axes:
            n = infer_extent(flat, flatten_axes(pa.in_axes, args))
            ns.append(n)
            keys.append(AxisKey(pa.policy.name, pa.policy.bucket(n), pa.label))
        return ShapeKey(tuple(keys)), tuple(ns)

    def program_for(self, *args: Any) -> Tuple[CompiledModule, ShapeKey, Any]:
        """Resolve the bucket program of bucket-shaped ``args``; compile
        Phases 1-4 on the first miss."""
        key, n = self.shape_key_for(*args)
        if (n if isinstance(n, tuple) else (n,)) != key.extents:
            raise ValueError(f"extents {n} are not the bucket extents {key.extents} of "
                             f"{key}: pad the arguments to the bucket first")
        return self._program_for_key(key, args), key, n

    def _program_for_key(self, key: ShapeKey, args: Tuple[Any, ...], *,
                         background: bool = False) -> CompiledModule:
        with self._lock:
            mod = self.programs.get(key)
            if mod is None:
                build_lock = self._build_locks.setdefault(key, threading.Lock())
        if mod is not None:
            if not background:
                self.stats.note_lookup(hit=True)
            return mod
        # everything below is request-visible stall unless a service
        # worker is doing it: the split compile_wait_s is judged by
        t_wait = time.perf_counter()
        with build_lock:
            with self._lock:
                mod = self.programs.get(key)
            if mod is not None:  # a concurrent dispatch built it first
                if not background:
                    self.stats.note_lookup(hit=True)
                    self.stats.note_wait(time.perf_counter() - t_wait)
                return mod
            t0 = time.perf_counter()
            padded = pad_args(args, tuple(pa.in_axes for pa in self.axes), key.extents,
                              mode=self.pad_mode)
            with BUILD_LOCK:
                if self.prime:
                    with torch.no_grad():
                        self.fn(*padded)
                mod = self.compiler.compile(self.fn, *padded, shape_key=key,
                                            static_argnums=self.static_argnums)
            with self._lock:
                self.programs[key] = mod
            self.stats.note_lookup(hit=False, key=key, compile_s=time.perf_counter() - t0,
                                   background=background)
            if not background:
                self.stats.note_wait(time.perf_counter() - t_wait)
        return mod

    # -- async compile service -------------------------------------------

    def _service_key(self, key: ShapeKey) -> str:
        # the module's identity joins the key: two fronts can share one
        # CompileService without colliding on equal ShapeKeys
        return f"bucketed@{id(self):#x}|{key}"

    def has_program(self, key: ShapeKey) -> bool:
        with self._lock:
            return key in self.programs

    def lookup_program(self, key: ShapeKey) -> Optional[CompiledModule]:
        """Table read without stats side effects (scheduler probes)."""
        with self._lock:
            return self.programs.get(key)

    def warm_keys(self) -> List[ShapeKey]:
        """Every ShapeKey with a compiled program (scheduler probes)."""
        with self._lock:
            return list(self.programs.keys())

    def key_for_extents(self, extents: Union[int, Sequence[int]]) -> ShapeKey:
        """The ShapeKey of a given per-axis bucket-extent assignment."""
        if isinstance(extents, int):
            extents = (extents,)
        if len(extents) != len(self.axes):
            raise ValueError(f"expected {len(self.axes)} extents, got {len(extents)}")
        return ShapeKey(tuple(AxisKey(pa.policy.name, int(e), pa.label)
                              for pa, e in zip(self.axes, extents)))

    def nearest_warm(self, ns: Union[int, Sequence[int]]) -> Optional[ShapeKey]:
        """Smallest warm bucket that *dominates* the concrete extents.

        The fallback-domination rule (DESIGN.md): a warm bucket is a legal
        pad-up target iff every axis extent is >= the concrete extent —
        the dispatch then runs as an ordinary padded call of that bucket.
        Among legal buckets the one with the fewest cells (ties: the
        lexicographically smallest extents) wins, minimizing the fallback
        pad premium.
        """
        if isinstance(ns, int):
            ns = (ns,)
        ns = tuple(int(n) for n in ns)
        best: Optional[ShapeKey] = None
        best_rank: Tuple[int, Tuple[int, ...]] = (0, ())
        for k in self.warm_keys():
            ext = k.extents
            if len(ext) != len(ns) or any(e < n for e, n in zip(ext, ns)):
                continue
            rank = (int(np.prod(ext)), ext)
            if best is None or rank < best_rank:
                best, best_rank = k, rank
        return best

    def submit_key(self, key: ShapeKey, args: Optional[Tuple[Any, ...]] = None,
                   args_fn: Optional[Callable[[], Tuple[Any, ...]]] = None, *,
                   foreground: bool = True) -> Future:
        """Queue ``key``'s compile on the service; returns its future.

        ``args_fn`` defers example-argument construction (e.g. a
        bucket-sized KV cache) to the worker thread so submission itself
        stays cheap.  An already-warm key returns a resolved future.
        """
        if self.service is None:
            raise RuntimeError("BucketedModule has no CompileService")
        mod = self.lookup_program(key)
        if mod is not None:
            fut: Future = Future()
            fut.set_result(mod)
            return fut
        if args is None and args_fn is None:
            raise TypeError("submit_key needs args or args_fn")

        def build() -> CompiledModule:
            # the serving thread runs its steps under no_grad: so does the
            # worker, so that both capture the same program
            with torch.no_grad():
                a = args if args is not None else args_fn()
                return self._program_for_key(key, a, background=True)

        return self.service.submit(self._service_key(key), build, foreground=foreground)

    def _resolve_dispatch(self, key: ShapeKey, ns: Tuple[int, ...], args: Tuple[Any, ...]
                          ) -> Tuple[CompiledModule, ShapeKey]:
        """The (program, bucket) a concrete call executes under.

        Inline: the exact bucket, compiled on a miss.  Async: the exact
        bucket when warm; otherwise submit it to the service and pad into
        :meth:`nearest_warm`, blocking on the future only when no warm
        bucket dominates.
        """
        if not self.async_compile or self.service is None:
            return self._program_for_key(key, args), key
        mod = self.lookup_program(key)
        if mod is not None:
            self.stats.note_lookup(hit=True)
            return mod, key
        fut = self.submit_key(key, args=args, foreground=True)
        warm = self.nearest_warm(ns)
        if warm is not None:
            mod = self.lookup_program(warm)
            if mod is not None:
                self.stats.note_fallback(int(np.prod(warm.extents)) - int(np.prod(key.extents)))
                return mod, warm
        t0 = time.perf_counter()
        mod = self.service.result(fut)
        self.stats.note_wait(time.perf_counter() - t0)
        return mod, key

    def _plan_for(self, mod: CompiledModule, key: ShapeKey, ns: Tuple[int, ...],
                  args: Tuple[Any, ...]) -> PadPlan:
        plan_axes = self._plans.get(key)
        if plan_axes is None:
            tied = mod.capture.tied_map
            in_nd = flatten_axes_nd([pa.in_axes for pa in self.axes], args)
            in_axes = tuple(a for i, a in enumerate(in_nd) if i not in tied)
            # broadcast each axis's out spec over the output tree (a dummy
            # instance carries the structure), zipped into per-leaf vectors
            n_out = mod.capture.out_spec.num_leaves
            dummy = pytree.tree_unflatten(list(range(n_out)), mod.capture.out_spec)
            per_axis = [flatten_axes(pa.out_axes, dummy) for pa in self.axes]
            out_axes = tuple(tuple(v) for v in zip(*per_axis))
            plan_axes = self._plans[key] = (in_axes, out_axes)
        return PadPlan(n_valid=ns, extent=key.extents, in_axes=plan_axes[0],
                       out_axes=plan_axes[1], mode=self.pad_mode)

    def __call__(self, *args: Any) -> Any:
        """Pad-and-mask call: the call's bucket program (or, async, a warm
        dominating one) on the arguments padded to its extents; the
        outputs sliced back to the call's extents."""
        # one pytree flatten feeds dispatch and execution
        flat, spec = pytree.tree_flatten(args)
        key, ns = self._shape_key_flat(flat, args)
        mod, use_key = self._resolve_dispatch(key, ns, args)
        flat = mod._filter_flat_inputs(flat, spec)
        plan = self._plan_for(mod, use_key, ns, args)
        outs = mod.executor.execute_padded(flat, plan=plan)
        self.stats.note_dispatch(use_key, ns, use_key.extents)
        return mod._unflatten_outputs(outs)

    # -- eviction ---------------------------------------------------------

    def evict_cold(self, max_programs: int) -> List[ShapeKey]:
        """Retire the least recently dispatched programs beyond a budget.

        Trims the table to ``max_programs`` entries by the
        ``BucketStats.per_bucket_last_dispatch`` recency trail
        (never-dispatched programs go first), releasing each evicted
        bucket's pooled buffers and its compile-cache memory entry (the
        coherence drop: the cache stops pinning a dead executor — on the
        card, its CUDA graphs and their pool).  The disk entry, if any,
        survives: a later dispatch of an evicted bucket replays it from
        disk, or else rebuilds it (a fresh ``compiles``).  Returns the
        evicted ShapeKeys.
        """
        if max_programs < 0:
            raise ValueError(f"max_programs must be >= 0, got {max_programs}")
        with self._lock:
            excess = len(self.programs) - max_programs
            if excess <= 0:
                return []
            last = self.stats.per_bucket_last_dispatch
            victims = sorted(self.programs, key=lambda k: last.get(str(k), 0))[:excess]
            victim_mods = [self.programs.pop(k) for k in victims]
            for k in victims:
                self._plans.pop(k, None)
                self._build_locks.pop(k, None)
        for k, m in zip(victims, victim_mods):
            self.pool.drop(bucket_pool_key(k))
            self.stats.note_eviction(k)
            ck = m.result.cache_key
            if ck is not None and self.compiler.cache is not None:
                self.compiler.cache.drop(ck)
        return victims

    def refit_policy(self, new_policy: Union[str, BucketPolicy], axis: int = 0) -> BucketPolicy:
        """Swap one polymorphic axis's bucket policy in place (a re-fit).

        The new policy keeps the old policy's name: AxisKeys embed the
        name, so a rename would orphan every program, pooled buffer set and
        compile-cache entry at extents both policies map to.  With the
        name pinned, a kept rung's program, pool and cache entries stay
        addressable, and a dropped rung's program stays a legal
        :meth:`nearest_warm` pad-up target (domination compares extents
        only) until :meth:`evict_cold` retires it.  Returns the installed
        policy."""
        new_policy = get_bucket_policy(new_policy)
        with self._lock:
            old_axis = self.axes[axis]
            # pin the name (a frozen dataclass: the same escape hatch the
            # policies' own field defaults rely on)
            object.__setattr__(new_policy, "name", old_axis.policy.name)
            axes = list(self.axes)
            axes[axis] = PolyAxis(in_axes=old_axis.in_axes, out_axes=old_axis.out_axes,
                                  policy=new_policy, label=old_axis.label)
            self.axes = tuple(axes)
            if axis == 0:  # keep the 1-D view coherent
                self.policy = new_policy
        return new_policy

    # -- transparency -----------------------------------------------------

    @property
    def last_result(self) -> Optional[CompilationResult]:
        """The most recently compiled bucket's CompilationResult."""
        with self._lock:
            mods = list(self.programs.values())
        return mods[-1].result if mods else None

    def bucket_table(self) -> Dict[str, ExecutorStats]:
        """ShapeKey string -> that bucket program's executor stats."""
        with self._lock:
            return {str(k): m.stats for k, m in self.programs.items()}


def forge_compile(fn: Callable, *example_args: Any, config: Optional[PipelineConfig] = None,
                  impl: Optional[str] = None, backend: Optional[str] = None,
                  reorder: bool = True) -> CompiledModule:
    """One-shot convenience API: ``forge_compile(f, x, backend="reference")``."""
    return ForgeCompiler(config, reorder=reorder, backend=backend, impl=impl).compile(
        fn, *example_args)


def forge_compile_bucketed(
    fn: Callable,
    *example_args: Any,
    axes: Optional[Sequence[PolyAxis]] = None,
    in_axes: AxisSpec = 0,
    out_axes: AxisSpec = 0,
    policy: Union[str, BucketPolicy] = "pow2",
    pad_mode: str = "edge",
    async_compile: bool = False,
    service: Optional[CompileService] = None,
    config: Optional[PipelineConfig] = None,
    backend: Optional[str] = None,
    cache: Optional[CompileCache] = None,
) -> BucketedModule:
    """Shape-generalized convenience API: one program per ShapeKey cell.

    ``forge_compile_bucketed(f, x, in_axes=0, policy="pow2")`` compiles
    ``x``'s bucket now and further buckets on demand; pass
    ``axes=(PolyAxis(...), ...)`` for multi-axis (e.g. batch × sequence)
    bucketing.
    """
    return ForgeCompiler(config, backend=backend, cache=cache).compile_bucketed(
        fn, *example_args, axes=axes, in_axes=in_axes, out_axes=out_axes, policy=policy,
        pad_mode=pad_mode, async_compile=async_compile, service=service)
