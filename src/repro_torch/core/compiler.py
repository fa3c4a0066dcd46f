"""The ForgeCompiler — four-phase orchestration (paper Figure 1).

``ForgeCompiler.compile(fn, *example_args)`` runs

  Phase 1  capture          trace_to_graph (torch.export, tied weights)
  Phase 2  optimization     run_forge_passes (fixpoint)
  Phase 3  lowering         lower_to_rgir (typed register IR)
  Phase 4  analysis+codegen backend build (scheduling, liveness,
                            linear-scan allocation, executor)

and returns a :class:`CompiledModule` — callable on the same pytree
signature as ``fn`` — plus the transparent :class:`CompilationResult`
(nodes before/after, fused-op counts, per-pass profile, buffer and
transition statistics, phase timings).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from torch.utils import _pytree as pytree

from .backends import ExecutorLike, get_backend
from .capture import CaptureResult, trace_to_graph
from .executor import ExecutorStats
from .graph import Graph
from .lowering import lower_to_rgir
from .passes import PassRecord, run_forge_passes


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
    tied_weights: int = 0
    impl: Optional[str] = None
    backend: str = "interpret"

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
    """A compiled function: pytree-aware wrapper over the executor."""

    def __init__(self, executor: ExecutorLike, capture: CaptureResult,
                 result: CompilationResult, graph: Graph):
        self.executor = executor
        self.capture = capture
        self.result = result
        self.graph = graph

    def _flatten_inputs(self, args: Sequence[Any]) -> List[Any]:
        flat, spec = pytree.tree_flatten(tuple(args))
        if spec != self.capture.in_spec:
            raise TypeError(f"input pytree mismatch: expected {self.capture.in_spec}, "
                            f"got {spec}")
        tied = self.capture.tied_map
        if tied:
            flat = [x for i, x in enumerate(flat) if i not in tied]
        return flat

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


def _count_fused(g: Graph) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for n in g.nodes.values():
        if n.is_fused:
            counts[n.op] = counts.get(n.op, 0) + 1
    return counts


class ForgeCompiler:
    """Four-phase compiler facade (paper Figure 1).

    ``impl`` is forwarded into the fused nodes (None dispatches by device,
    ``"ref"`` runs the kernels' plain versions).  Phase 4 is delegated to
    the pluggable :class:`~repro_torch.core.backends.Backend` named by
    ``backend`` (``interpret`` | ``reference``).
    """

    def __init__(self, *, impl: Optional[str] = None, backend: str = "interpret"):
        self.impl = impl
        self.backend_name = backend
        get_backend(backend)  # fail fast on unknown names

    def compile(self, fn: Callable, *example_args: Any) -> CompiledModule:
        """Compile ``fn`` specialised to ``example_args``' shapes, dtypes
        and device."""
        t_total = time.perf_counter()

        cap = trace_to_graph(fn, *example_args)  # Phase 1
        g = cap.graph
        nodes_before = g.num_nodes()

        t0 = time.perf_counter()  # Phase 2
        records = run_forge_passes(g, impl=self.impl)
        optimize_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()  # Phase 3
        prog = lower_to_rgir(g)
        lower_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()  # Phase 4
        executor = get_backend(self.backend_name).build(prog)
        backend_ms = (time.perf_counter() - t0) * 1e3

        fused = _count_fused(g)
        result = CompilationResult(
            nodes_before=nodes_before,
            nodes_after=g.num_nodes(),
            fused_ops=sum(fused.values()),
            attention_fused=fused.get("forge.sdpa", 0),
            pass_records=records,
            capture_ms=cap.capture_ms,
            optimize_ms=optimize_ms,
            lower_ms=lower_ms,
            backend_ms=backend_ms,
            total_ms=(time.perf_counter() - t_total) * 1e3,
            executor_stats=executor.stats,
            tied_weights=len(cap.tied_map),
            impl=self.impl,
            backend=self.backend_name,
        )
        return CompiledModule(executor, cap, result, g)


def forge_compile(fn: Callable, *example_args: Any, impl: Optional[str] = None,
                  backend: str = "interpret") -> CompiledModule:
    """One-shot convenience API: ``forge_compile(f, x, backend="reference")``."""
    return ForgeCompiler(impl=impl, backend=backend).compile(fn, *example_args)
