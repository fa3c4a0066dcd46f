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

``ForgeCompiler.compile_bucketed`` builds a :class:`BucketedModule`: one
compiled program per :class:`~repro_torch.core.shapekey.ShapeKey` cell,
resolved by the call's extents (the serve fronts' shape generalization).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from .backends import ExecutorLike, get_backend
from .capture import CaptureResult, trace_to_graph
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
    PolyAxis,
    ShapeKey,
    flatten_axes,
    infer_extent,
)


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
                f"backend={self.backend}"
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
        if spec != capture.in_spec:
            raise TypeError(f"input pytree mismatch: expected {capture.in_spec}, "
                            f"got {spec}")
        tied = capture.tied_map
        if tied:
            flat = [x for i, x in enumerate(flat) if i not in tied]
        return flat

    def _flatten_inputs(self, args: Sequence[Any]) -> List[Any]:
        return self._flatten_inputs_of(self.capture, args)

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
    liveness and allocation run on the program order.
    """

    def __init__(self, config: Optional[PipelineConfig] = None, *, reorder: bool = True,
                 backend: Optional[str] = None, impl: Optional[str] = None):
        config = config or PipelineConfig()
        if impl is not None:
            config = dataclasses.replace(config, impl=impl)
        self.config = config
        self.impl = config.impl
        self.reorder = reorder
        self.backend_name = backend or config.backend
        get_backend(self.backend_name)  # fail fast on unknown names

    def compile(self, fn: Callable, *example_args: Any,
                shape_key: Optional[ShapeKey] = None,
                static_argnums: Sequence[int] = ()) -> CompiledModule:
        """Compile ``fn`` specialised to ``example_args``' shapes, dtypes
        and device.  ``shape_key`` names the bucket cell when a
        :class:`BucketedModule` compiles (transparency only).
        ``static_argnums`` names the arguments that are parameters: a
        backend that captures the program on the card (segment_jit, which
        captures here, from the example arguments) reads them at the
        caller's address and refuses a call that moved them."""
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

        t0 = time.perf_counter()  # Phase 4
        static, names = _static_inputs(cap, example_args, static_argnums)
        executor = get_backend(self.backend_name).build(prog, static_inputs=static,
                                                        input_names=names,
                                                        reorder=self.reorder)
        prepare = getattr(executor, "prepare", None)
        if prepare is not None:  # segment_jit: capture on the card now
            prepare(*CompiledModule._flatten_inputs_of(cap, example_args))
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
            executor_stats=executor.stats,
            cost=cost,
            tied_weights=len(cap.tied_map),
            config=self.config,
            impl=self.impl,
            backend=self.backend_name,
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
        policy: Union[str, BucketPolicy] = "pow2",
        prime: bool = False,
        static_argnums: Sequence[int] = (),
    ) -> "BucketedModule":
        """A shape-generalized multi-program front over ``fn``.

        ``axes`` holds one :class:`PolyAxis` per polymorphic dimension
        (e.g. batch × sequence for whole-prompt prefill); the 1-D short
        form ``in_axes``/``policy`` marks one batch axis.  With
        ``example_args`` their cell compiles now; otherwise the first
        call per cell pays the compile.  ``prime`` runs ``fn`` once
        eagerly before each capture (see :class:`BucketedModule`);
        ``static_argnums`` goes to every cell's :meth:`compile`.
        """
        mod = BucketedModule(self, fn, axes=axes, in_axes=in_axes, policy=policy, prime=prime,
                             static_argnums=static_argnums)
        if example_args:
            mod.program_for(*example_args)
        return mod


class BucketedModule:
    """Shape-generalized multi-program front.

    Holds a per-bucket program table over N polymorphic axes: arguments
    with concrete extents ``(n_1, …, n_N)`` go by their :class:`ShapeKey`
    (per-axis ``policy.bucket(n_i)``) to the cell's compiled program —
    Phases 1-4 run on the first miss only.  The caller holds state that
    is already bucket-shaped (the serve fronts pad their slot tables and
    masks themselves), so a program runs the arguments as given.  The
    table is bounded by the product of the per-axis policies.

    ``prime=True`` calls ``fn`` once eagerly on a cell's arguments
    before capturing it: a step that calls Forge-compiled block bodies
    (``models/_forge.py``) compiles them at their first call, and one
    ``torch.export`` cannot run inside another, so they must compile
    before the capture traces through their executors.

    Axis specs may be per-leaf trees (the contiguous fronts mark each
    cache leaf's batch axis, from ``shapekey.infer_poly_axes``).  The JAX
    package's pad-and-mask ``__call__``, async compile service,
    cold-bucket eviction, ladder re-fit and per-bucket buffer pool are
    not ported: the serve fronts use none of them.
    """

    def __init__(self, compiler: ForgeCompiler, fn: Callable, *,
                 axes: Optional[Sequence[PolyAxis]] = None, in_axes: AxisSpec = 0,
                 policy: Union[str, BucketPolicy] = "pow2", prime: bool = False,
                 static_argnums: Sequence[int] = ()):
        self.compiler = compiler
        self.fn = fn
        self.prime = prime
        self.static_argnums = tuple(static_argnums)
        if axes is None:
            axes = (PolyAxis(in_axes=in_axes, policy=policy),)
        self.axes: Tuple[PolyAxis, ...] = tuple(axes)
        if not self.axes:
            raise ValueError("BucketedModule needs at least one PolyAxis")
        self.policy = self.axes[0].policy
        self.programs: Dict[ShapeKey, CompiledModule] = {}
        self.stats = BucketStats()

    def shape_key_for(self, *args: Any) -> Tuple[ShapeKey, Any]:
        """(ShapeKey, concrete extent(s)) of an argument tuple: the extent
        is an int for 1-D fronts, a per-axis tuple for N-D fronts."""
        flat = pytree.tree_leaves(args)
        ns: List[int] = []
        keys: List[AxisKey] = []
        for pa in self.axes:
            n = infer_extent(flat, flatten_axes(pa.in_axes, args))
            ns.append(n)
            keys.append(AxisKey(pa.policy.name, pa.policy.bucket(n), pa.label))
        return ShapeKey(tuple(keys)), (ns[0] if len(ns) == 1 else tuple(ns))

    def program_for(self, *args: Any) -> Tuple[CompiledModule, ShapeKey, Any]:
        """Resolve the bucket program of bucket-shaped ``args``; compile
        Phases 1-4 on the first miss."""
        key, n = self.shape_key_for(*args)
        if (n if isinstance(n, tuple) else (n,)) != key.extents:
            raise ValueError(f"extents {n} are not the bucket extents {key.extents} of "
                             f"{key}: pad the arguments to the bucket first")
        mod = self.programs.get(key)
        if mod is not None:
            self.stats.note_lookup(hit=True)
            return mod, key, n
        t0 = time.perf_counter()
        if self.prime:
            with torch.no_grad():
                self.fn(*args)
        mod = self.compiler.compile(self.fn, *args, shape_key=key,
                                    static_argnums=self.static_argnums)
        self.programs[key] = mod
        self.stats.note_lookup(hit=False, key=key, compile_s=time.perf_counter() - t0)
        return mod, key, n

    def lookup_program(self, key: ShapeKey) -> Optional[CompiledModule]:
        """Table read without stats side effects (scheduler probes)."""
        return self.programs.get(key)

    def key_for_extents(self, extents: Union[int, Sequence[int]]) -> ShapeKey:
        """The ShapeKey of a given per-axis bucket-extent assignment."""
        if isinstance(extents, int):
            extents = (extents,)
        if len(extents) != len(self.axes):
            raise ValueError(f"expected {len(self.axes)} extents, got {len(extents)}")
        return ShapeKey(tuple(AxisKey(pa.policy.name, int(e), pa.label)
                              for pa, e in zip(self.axes, extents)))


def forge_compile(fn: Callable, *example_args: Any, config: Optional[PipelineConfig] = None,
                  impl: Optional[str] = None, backend: Optional[str] = None,
                  reorder: bool = True) -> CompiledModule:
    """One-shot convenience API: ``forge_compile(f, x, backend="reference")``."""
    return ForgeCompiler(config, reorder=reorder, backend=backend, impl=impl).compile(
        fn, *example_args)
