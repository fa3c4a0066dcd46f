"""The ``interpret`` backend — per-instruction Python dispatch.

Wraps :class:`~repro_torch.core.executor.CompiledExecutor`: one
Python-level dispatch per RGIR instruction over the physical buffer file
(paper Listing 9).  Its disk-cache entry is the analysis products
(schedule, liveness, allocation): per-op dispatch has nothing else to
persist, and restoring them skips Phase 4a-c on a restart.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from ..executor import CompiledExecutor, analyze_program, analyzed_from_persisted
from ..lowering import RGIRProgram
from .base import Backend, register_backend


@register_backend
class InterpretBackend(Backend):
    name = "interpret"

    def build(self, prog: RGIRProgram, *, static_inputs: Sequence[int] = (),
              input_names: Optional[Sequence[str]] = None,
              reorder: bool = True) -> CompiledExecutor:
        return CompiledExecutor(analyze_program(prog, reorder=reorder))

    def export_entry(self, prog: RGIRProgram, executor: Any) -> Optional[Dict[str, Any]]:
        if not isinstance(executor, CompiledExecutor):
            return None
        return {"kind": self.name, "n_ops": len(executor.prog.ops), "sched": executor.sched,
                "live": executor.live, "alloc": executor.alloc}

    def build_from_entry(self, prog: RGIRProgram, entry: Dict[str, Any], *,
                         static_inputs: Sequence[int] = (),
                         input_names: Optional[Sequence[str]] = None,
                         reorder: bool = True) -> Optional[CompiledExecutor]:
        if entry.get("kind") != self.name or entry.get("n_ops") != len(prog.ops):
            return None
        analyzed = analyzed_from_persisted(prog, entry["sched"], entry["live"], entry["alloc"])
        if analyzed is None:
            return None
        try:
            return CompiledExecutor(analyzed)
        except Exception:
            return None
