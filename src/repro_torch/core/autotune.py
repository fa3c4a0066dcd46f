"""The autotuning compiler (paper §4.7) — the port of ``repro.core.autotune``.

Systematically searches the configuration space

    𝒞 = { α ∈ {0.2, 0.4, 0.6, 0.8, 1.0},
          λ ∈ {auto, hints, off},
          π ∈ {bf16, fp32, mixed},
          ι ∈ {1, 2, 3} }

…the paper's 45-candidate grid (α×λ×π = 45 primary candidates at ι=2,
then a refinement sweep over ι on the best α×λ×π cell: 47 in all).  Each
candidate is scored by the heuristic cost model with **no hardware
execution** (paper: under 200 ms a model), and the arg-min configuration
is returned.

Port difference: the JAX package traces the function once per
candidate; here one ``torch.export`` captures it (seconds at a model's
widths) and every candidate's passes run on a :meth:`Graph.copy` of that
capture.  ``TuneCandidate.time_ms`` is a candidate's passes and scoring;
``TuneResult.capture_ms`` is the one export, inside ``total_ms``.

Beyond the paper: ``metric='roofline'`` scores with the calibrated
FLOPs/bytes estimate instead of the heuristic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Tuple

from .capture import trace_to_graph
from .compiler import CompiledModule, ForgeCompiler
from .cost_model import roofline_score, score_graph
from .graph import Graph
from .passes import PipelineConfig, run_forge_passes

ALPHAS = (0.2, 0.4, 0.6, 0.8, 1.0)
LAYOUTS = ("auto", "hints", "off")
PRECISIONS = ("bf16", "fp32", "mixed")
ROUNDS = (1, 2, 3)


@dataclass
class TuneCandidate:
    alpha: float
    layout: str
    precision: str
    max_rounds: int
    score: float
    nodes_after: int
    #: this candidate's passes and scoring (the capture is shared)
    time_ms: float

    def to_config(self) -> PipelineConfig:
        return PipelineConfig(
            alpha=self.alpha,
            layout=self.layout,
            precision=self.precision,
            max_rounds=self.max_rounds,
        )


@dataclass
class TuneResult:
    best: TuneCandidate
    candidates: List[TuneCandidate] = field(default_factory=list)
    #: the whole search, the capture included
    total_ms: float = 0.0
    #: the one ``torch.export`` capture every candidate starts from
    capture_ms: float = 0.0


class AutotuningCompiler:
    """Grid-search wrapper around :class:`ForgeCompiler` (paper Eq. 20)."""

    def __init__(self, metric: str = "heuristic", exhaustive: bool = False):
        assert metric in ("heuristic", "roofline")
        self.metric = metric
        self.exhaustive = exhaustive

    def _score_config(self, graph: Graph, cfg: PipelineConfig) -> Tuple[float, int, float]:
        t0 = time.perf_counter()
        g = graph.copy()
        run_forge_passes(g, cfg=cfg)
        if self.metric == "roofline":
            s = roofline_score(g, cfg.precision)
        else:
            s = score_graph(g, cfg.precision).score
        return s, g.num_nodes(), (time.perf_counter() - t0) * 1e3

    def tune(self, fn: Callable, *example_args: Any) -> TuneResult:
        t_all = time.perf_counter()
        cap = trace_to_graph(fn, *example_args)
        cands: List[TuneCandidate] = []
        # primary sweep: α × λ × π at ι=2  (45 candidates)
        for alpha in ALPHAS:
            for layout in LAYOUTS:
                for precision in PRECISIONS:
                    cfg = PipelineConfig(
                        alpha=alpha, layout=layout, precision=precision,
                        max_rounds=2,
                    )
                    s, n, ms = self._score_config(cap.graph, cfg)
                    cands.append(TuneCandidate(alpha, layout, precision, 2, s, n, ms))
        best = min(cands, key=lambda c: (c.score, -c.alpha))
        # refinement sweep over ι on the winning cell
        for rounds in ROUNDS:
            if rounds == 2:
                continue
            cfg = PipelineConfig(
                alpha=best.alpha, layout=best.layout,
                precision=best.precision, max_rounds=rounds,
            )
            s, n, ms = self._score_config(cap.graph, cfg)
            cands.append(
                TuneCandidate(best.alpha, best.layout, best.precision,
                              rounds, s, n, ms)
            )
        best = min(cands, key=lambda c: (c.score, -c.alpha, c.max_rounds))
        return TuneResult(
            best=best, candidates=cands,
            total_ms=(time.perf_counter() - t_all) * 1e3,
            capture_ms=cap.capture_ms,
        )

    def compile(self, fn: Callable, *example_args: Any) -> CompiledModule:
        """Tune, then compile with the winning configuration."""
        result = self.tune(fn, *example_args)
        mod = ForgeCompiler(result.best.to_config()).compile(fn, *example_args)
        mod.result.config = result.best.to_config()
        mod.tune_result = result  # type: ignore[attr-defined]
        return mod
