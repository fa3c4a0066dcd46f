"""Pass infrastructure — the ``FXPassBase`` analogue.

Every Phase-2 pass subclasses :class:`ForgePass` and implements
``run(graph) -> bool`` (True iff the graph was mutated), exactly mirroring
the paper's single ``run(gm) -> bool`` interface.  The pipeline wraps each
invocation with wall-clock timing and node-delta accounting so the
``CompilationResult`` can report per-pass profiling (paper metric 1).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict

from ..graph import Graph


class ForgePass:
    """Base class for all Phase-2 optimization passes."""

    #: short name used in CompilationResult tables
    name: str = "base"

    def run(self, g: Graph) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


@dataclass
class PassRecord:
    """One timed invocation of one pass (paper Table 10 row)."""

    name: str
    time_ms: float
    nodes_before: int
    nodes_after: int
    modified: bool
    round: int
    detail: Dict[str, Any] = field(default_factory=dict)

    @property
    def node_delta(self) -> int:
        return self.nodes_after - self.nodes_before


def timed_run(p: ForgePass, g: Graph, round_idx: int) -> PassRecord:
    before = g.num_nodes()
    t0 = time.perf_counter()
    modified = bool(p.run(g))
    dt = (time.perf_counter() - t0) * 1e3
    detail = dict(getattr(p, "last_detail", {}) or {})
    return PassRecord(
        name=p.name,
        time_ms=dt,
        nodes_before=before,
        nodes_after=g.num_nodes(),
        modified=modified,
        round=round_idx,
        detail=detail,
    )
