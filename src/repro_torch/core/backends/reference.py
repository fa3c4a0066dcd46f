"""The ``reference`` backend — the fidelity oracle.

Executes the RGIR stream in *original program order* with one value slot
per virtual register: no scheduling, no buffer sharing, no eager GC.
Nothing Phase 4b/4c could get wrong can corrupt its results, so every
real backend is compared against this one.  Bucketed pad-and-mask calls
route through the shared ``execute_padded`` mixin like every other
backend.

It has no analysis to persist; its disk-cache entry records only its
kind and op count, so a restart rebuilds it from the entry with no full
build counted (the JAX package's reference backend writes no entry).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from ..executor import ExecutorStats, PaddedExecutionMixin
from ..lowering import RGIRProgram
from .base import Backend, register_backend


class ReferenceExecutor(PaddedExecutionMixin):
    """Straight-line evaluator over a one-slot-per-vreg register file."""

    def __init__(self, prog: RGIRProgram):
        self.prog = prog
        self.stats = ExecutorStats(
            n_instructions=len(prog.ops),
            n_accel=sum(1 for op in prog.ops if op.device == "accel"),
            n_host=sum(1 for op in prog.ops if op.device == "host"),
            n_vregs=prog.n_vregs,
            n_buffers=prog.n_vregs,  # dedicated slot per register
            rho_buf=0.0,
            delta_before=prog.device_transitions(),
            delta_after=prog.device_transitions(),
        )

    def execute(self, *flat_inputs: Any) -> List[Any]:
        if len(flat_inputs) != len(self.prog.input_regs):
            raise TypeError(f"reference executor expects {len(self.prog.input_regs)} "
                            f"inputs, got {len(flat_inputs)}")
        env: Dict[int, Any] = dict(self.prog.constants)
        for r, v in zip(self.prog.input_regs, flat_inputs):
            env[r] = v
        for op in self.prog.ops:
            for r, v in zip(op.output_regs, op.execute(env.__getitem__)):
                env[r] = v
        self.stats.note_call(peak=len(env))
        return [env[r] for r in self.prog.output_regs]

    def as_fn(self) -> Callable:
        return self.execute


@register_backend
class ReferenceBackend(Backend):
    name = "reference"

    def build(self, prog: RGIRProgram, *, static_inputs: Sequence[int] = (),
              input_names: Optional[Sequence[str]] = None,
              reorder: bool = True) -> ReferenceExecutor:
        return ReferenceExecutor(prog)

    def export_entry(self, prog: RGIRProgram, executor: Any) -> Optional[Dict[str, Any]]:
        if not isinstance(executor, ReferenceExecutor):
            return None
        return {"kind": self.name, "n_ops": len(executor.prog.ops)}

    def build_from_entry(self, prog: RGIRProgram, entry: Dict[str, Any], *,
                         static_inputs: Sequence[int] = (),
                         input_names: Optional[Sequence[str]] = None,
                         reorder: bool = True) -> Optional[ReferenceExecutor]:
        if entry.get("kind") != self.name or entry.get("n_ops") != len(prog.ops):
            return None
        return ReferenceExecutor(prog)
