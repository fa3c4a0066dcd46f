"""Phase 4d — code generation: the ``CompiledExecutor``.

The port's form of the paper's ``CompiledNPUExecutor`` (Listing 9): a
flat, pre-scheduled instruction stream executed with

* **no attribute lookup** — callables pre-resolved at lowering time,
* **no graph traversal** — straight loop over the scheduled ops,
* **physical-buffer register file** — values are stored under the buffer
  slot assigned by linear-scan allocation, so the executor *exercises*
  the allocation (a double-booked buffer corrupts results and is caught
  by the tests),
* **eager GC** — ``dead_after`` drops a buffer's reference the moment its
  register's last reader retires, so PyTorch's caching allocator can
  reuse the device memory for the next op (paper: "eager GC").

Values are tensors on the caller's device; host- and accel-tagged ops
run on the same CUDA tensors.

:class:`PaddedExecutionMixin` is the pad-and-mask call every backend's
executor shares (a bucket-shaped program run on narrower inputs), and
:func:`analyzed_from_persisted` rehydrates Phase 4a-c from a disk-cache
entry (``core/cache.py``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..runtime import chaos
from .bufalloc import AllocationResult, allocate_from_liveness
from .liveness import LivenessInfo, analyze_liveness
from .lowering import RGIRProgram
from .scheduler import ScheduleResult, compute_segments, schedule, verify_topological


@dataclass
class ExecutorStats:
    n_instructions: int = 0
    n_accel: int = 0
    n_host: int = 0
    n_vregs: int = 0
    n_buffers: int = 0
    rho_buf: float = 0.0
    delta_before: int = 0
    delta_after: int = 0
    #: all-time high-water mark of the physical buffer file (max over calls)
    peak_live_buffers: int = 0
    #: high-water mark of the most recent ``execute()`` call only
    last_peak_live_buffers: int = 0
    #: total ``execute()`` calls on this executor
    total_calls: int = 0
    # -- pad-and-mask (bucketed execution) counters -----------------------
    #: ``execute_padded`` calls routed through this executor
    padded_calls: int = 0
    #: real (valid) cells executed via ``execute_padded``
    rows_valid_total: int = 0
    #: padding cells executed via ``execute_padded`` (pad waste numerator)
    rows_padded_total: int = 0
    #: maximal device-affine runs of the scheduled stream (δ_after + 1)
    n_segments: int = 0
    # -- segment backend statistics (zero for per-op backends) ------------
    #: segments dispatched as one unit each (segment_jit: every segment,
    #: one CUDA graph on the card)
    n_compiled_segments: int = 0
    #: registers whose whole life is inside one segment (never hit a slot)
    n_internal_regs: int = 0
    #: segment dispatches of the most recent ``execute()`` call
    last_segments_executed: int = 0
    #: segment dispatches across all calls
    total_segments_executed: int = 0
    #: seconds of the warm run and the CUDA graph captures (0: none)
    capture_s: float = 0.0

    def __post_init__(self) -> None:
        # per-call counters are folded in under a lock so a shared stats
        # object stays consistent under concurrent calls
        self._lock = threading.Lock()

    def note_call(self, peak: int, segments_executed: int = 0) -> None:
        """Record one ``execute()`` call's counters (thread-safe)."""
        with self._lock:
            self.total_calls += 1
            self.last_peak_live_buffers = peak
            self.peak_live_buffers = max(self.peak_live_buffers, peak)
            self.last_segments_executed = segments_executed
            self.total_segments_executed += segments_executed

    def note_padding(self, rows_valid: int, rows_padded: int) -> None:
        """Record one pad-and-mask call's cell accounting (thread-safe)."""
        with self._lock:
            self.padded_calls += 1
            self.rows_valid_total += rows_valid
            self.rows_padded_total += rows_padded

    @property
    def pad_waste(self) -> float:
        """Fraction of the cells executed by ``execute_padded`` that were
        padding."""
        total = self.rows_valid_total + self.rows_padded_total
        return self.rows_padded_total / total if total else 0.0

    @property
    def transition_reduction(self) -> float:
        if self.delta_before == 0:
            return 0.0
        return 1.0 - self.delta_after / self.delta_before

    def fresh_snapshot(self) -> "ExecutorStats":
        """Copy with the run counters zeroed (analysis fields kept).

        A compile-cache hit hands a *shared* executor to a new module; its
        CompilationResult must not report the execution history other
        modules accumulated on that executor.
        """
        return _dc_replace(self, peak_live_buffers=0, last_peak_live_buffers=0,
                           total_calls=0, last_segments_executed=0,
                           total_segments_executed=0, padded_calls=0,
                           rows_valid_total=0, rows_padded_total=0)


class PaddedExecutionMixin:
    """Pad-and-mask execution: run a bucket-shaped program on narrower
    inputs (DESIGN.md §Shape generalization).

    The program was compiled for canonical bucket extents, one per
    polymorphic axis; a concrete call with fewer rows or columns is
    padded up along every polymorphic axis (the plan, a
    :class:`~repro_torch.core.shapekey.PadPlan`, says where), executed
    full-width, and its outputs sliced back to the valid region — the
    "mask".  Pad waste is folded into the stats as *cells* (the product
    over axes).  Shared by every backend's executor.
    """

    def execute_padded(self, flat_inputs: Sequence[Any], *, plan: Any) -> List[Any]:
        outs = self.execute(*plan.pad(flat_inputs))
        self.stats.note_padding(plan.n_valid_cells, plan.n_padded)
        return plan.unpad(outs)


@dataclass
class AnalyzedProgram:
    """Phase-4 analysis product shared by every backend.

    Scheduling runs *first*, then liveness and linear-scan allocation are
    recomputed on the scheduled order (see DESIGN.md for the soundness
    argument) — ``prog`` is already renumbered into schedule order.
    """

    prog: RGIRProgram
    sched: ScheduleResult
    live: LivenessInfo
    alloc: AllocationResult


def analyze_program(prog: RGIRProgram, *, reorder: bool = True) -> AnalyzedProgram:
    """Run Phase 4a-c: schedule, then liveness + allocation on that order.

    ``reorder=False`` is the unscheduled build: the program order stands,
    and liveness and allocation run on it."""
    sched = schedule(prog)
    if not reorder:
        sched = ScheduleResult(order=list(range(len(prog.ops))),
                               delta_before=sched.delta_before,
                               delta_after=sched.delta_before,
                               segments=compute_segments([op.device for op in prog.ops]))
    verify_topological(prog, sched.order)
    scheduled = prog.renumber(sched.order)
    live = analyze_liveness(scheduled)
    alloc = allocate_from_liveness(live)
    return AnalyzedProgram(prog=scheduled, sched=sched, live=live, alloc=alloc)


def analyzed_from_persisted(prog: RGIRProgram, sched: ScheduleResult, live: LivenessInfo,
                            alloc: AllocationResult) -> Optional[AnalyzedProgram]:
    """Rehydrate Phase-4 analysis from a disk-cache entry.

    ``prog`` is a freshly lowered program whose fingerprint matched the
    persisted entry's cache key; ``renumber`` keeps register ids, so the
    stored schedule, liveness and allocation (keyed by register id and
    scheduled instruction index) apply verbatim.  Returns ``None`` on
    any inconsistency — the caller falls back to a full analysis, never
    trusts a stale entry.
    """
    n = len(prog.ops)
    if sorted(sched.order) != list(range(n)):
        return None
    if sched.segments and sched.segments[-1].stop != n:
        return None
    try:
        verify_topological(prog, sched.order)
        scheduled = prog.renumber(sched.order)
        regs = set(scheduled.input_regs) | set(scheduled.constants)
        for op in scheduled.ops:
            regs.update(op.output_regs)
        if not regs.issubset(live.intervals.keys()):
            return None
    except Exception:
        return None
    return AnalyzedProgram(prog=scheduled, sched=sched, live=live, alloc=alloc)


class CompiledExecutor(PaddedExecutionMixin):
    """Flat instruction-stream executor over a physical buffer file."""

    def __init__(self, analyzed: AnalyzedProgram):
        self.analyzed = analyzed
        self.prog = analyzed.prog
        self.sched = analyzed.sched
        # liveness + allocation on the *scheduled* stream (soundness)
        self.live: LivenessInfo = analyzed.live
        self.alloc: AllocationResult = analyzed.alloc
        self._r2b = self.alloc.reg_to_buf
        self.dead_after = self.live.dead_after

        r2b = self._r2b
        self._const_items: Tuple[Tuple[int, Any], ...] = tuple(
            (r2b[r], v) for r, v in self.prog.constants.items()
        )
        self._input_bufs = [r2b[r] for r in self.prog.input_regs]
        self._output_bufs = [r2b[r] for r in self.prog.output_regs]
        const_slots = {b for b, _ in self._const_items}
        # precompiled dispatch plan: per-op output/free slot indices, so
        # the hot loop does no reg->slot dict walking
        self._op_plans = tuple(
            (
                op,
                tuple(r2b[r] for r in op.output_regs),
                tuple(b for b in (r2b[r] for r in self.dead_after.get(idx, ()))
                      if b not in const_slots),
            )
            for idx, op in enumerate(self.prog.ops)
        )
        occupied = set(const_slots) | set(self._input_bufs)
        peak = len(occupied)
        for idx, op in enumerate(self.prog.ops):
            occupied.update(r2b[r] for r in op.output_regs)
            peak = max(peak, len(occupied))
            occupied.difference_update(r2b[r] for r in self.dead_after.get(idx, ()))
        self._static_peak = peak

        self.stats = ExecutorStats(
            n_instructions=len(self.prog.ops),
            n_accel=sum(1 for op in self.prog.ops if op.device == "accel"),
            n_host=sum(1 for op in self.prog.ops if op.device == "host"),
            n_vregs=self.alloc.n_vregs,
            n_buffers=self.alloc.n_buffers,
            rho_buf=self.alloc.rho_buf,
            delta_before=self.sched.delta_before,
            delta_after=self.sched.delta_after,
            n_segments=self.sched.n_segments,
        )

    def execute(self, *flat_inputs: Any) -> List[Any]:
        """Run the compiled program (paper Listing 9's ``execute``)."""
        if len(flat_inputs) != len(self._input_bufs):
            raise TypeError(f"executor expects {len(self._input_bufs)} inputs, "
                            f"got {len(flat_inputs)}")
        # the fault site fires once per program execution (segment_jit
        # fires it once per segment), before any register write: the
        # caller's inputs are untouched, so the dispatch may be retried.
        # A torch.compile trace of the call (a jit-mode serve step) is no
        # execution: it fires no fault and counts no call
        tracing = torch.compiler.is_dynamo_compiling()
        if not tracing:
            chaos.maybe_fault(chaos.SITE_DISPATCH)
        file: List[Any] = [None] * self.alloc.n_buffers
        for b, v in self._const_items:
            file[b] = v
        for b, v in zip(self._input_bufs, flat_inputs):
            file[b] = v
        r2b = self._r2b
        read = lambda r: file[r2b[r]]  # noqa: E731
        for op, out_slots, free_slots in self._op_plans:
            results = op.execute(read)
            for b, v in zip(out_slots, results):
                file[b] = v
            for b in free_slots:  # eager GC
                file[b] = None
        outs = [file[b] for b in self._output_bufs]
        if not tracing:
            self.stats.note_call(self._static_peak)
        return outs

    def as_fn(self) -> Callable:
        """The executor as a plain callable on flat inputs."""
        return self.execute
