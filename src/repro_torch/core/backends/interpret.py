"""The ``interpret`` backend — per-instruction Python dispatch.

Wraps :class:`~repro_torch.core.executor.CompiledExecutor`: one
Python-level dispatch per RGIR instruction over the physical buffer file
(paper Listing 9).
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..executor import CompiledExecutor, analyze_program
from ..lowering import RGIRProgram
from .base import Backend, register_backend


@register_backend
class InterpretBackend(Backend):
    name = "interpret"

    def build(self, prog: RGIRProgram, *, static_inputs: Sequence[int] = (),
              input_names: Optional[Sequence[str]] = None,
              reorder: bool = True) -> CompiledExecutor:
        return CompiledExecutor(analyze_program(prog, reorder=reorder))
