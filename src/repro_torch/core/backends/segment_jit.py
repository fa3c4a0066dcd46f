"""The ``segment_jit`` backend — one CUDA graph per device-affine segment.

The device-affinity schedule (Phase 4c) leaves the RGIR stream as
``δ_after + 1`` maximal same-device runs.  Instead of dispatching each
instruction from Python (the ``interpret`` backend), this backend makes
every *segment* one dispatch unit — the JAX package's ``segment_jit``,
whose accel segments are ``jax.jit`` programs:

* each segment's program is the replay of its ops over a local register
  environment, whose signature is the segment's live-in / live-out
  register sets (derived from the liveness intervals);
* buffer allocation stays linear-scan but is **segment-aware**:
  registers born and killed inside a single segment never occupy a
  physical slot — they exist only in the segment's local environment;
* per-segment slot plans (gather live-ins, clear the registers that die,
  scatter live-outs) are computed once at build.

On CPU tensors each segment runs its replay closure: that is the plain
version, bitwise the ``interpret`` backend's results.

On CUDA tensors **every segment, of either tag, is one CUDA graph**.  On
this card both tags run on the same CUDA tensors, so the ``host`` tag is
scheduling metadata, not a device, and graphing only the ``accel`` ops
(forge nodes, kernel custom ops, bare matmuls) would leave 90-98% of the
ops on the per-op Python path.  :meth:`SegmentExecutor.prepare` (the
compiler calls it with the example arguments, so capture is part of
Phase 4) runs the program once eagerly on a side stream, which builds
the kernels' libraries, cuBLAS's handles and the kernels' lazy scratch
before capture, then captures the segments in program order into one
memory pool: a later segment's graph reads the earlier graphs' output
tensors by address, and no live-in is copied between segments.

* Parameters (``static_inputs``: the fronts pass ``static_argnums=(0,)``,
  every step signature puts ``params`` first) are captured at the
  caller's address; a parameter whose address changes at a later call
  raises, naming it.
* Every other input is copied into the program's own input tensors
  before the replays.
* The outputs are copied out of the pool after the replays, so what a
  call returns stays valid after later calls of the same program.
* Per call there are exactly ``n_segments`` (= δ_after + 1) replays.
* There is no fallback: a segment that cannot be captured (an op that
  syncs the host, an op CUDA graphs cannot hold) raises with its index
  and its first op that cannot be captured; it never falls back to
  per-op replay.  No op of the served programs needs the host: the
  sLSTM ``scan_op`` loop has a fixed trip count and no sync.
* Each segment records the kernel launches its capture met (the
  ``LAUNCHES`` counters), takes them back off and adds them at every
  replay, so the counters keep counting launches on the device.
* The ``dispatch`` fault site (``runtime/chaos.py``) fires once per
  segment, before it runs, on the CPU closures and before each replay
  alike.  A call that faults after segment *k* has read the caller's
  tensors only, and its outputs are not yet copied out, so the caller's
  cache and page store are untouched and the call may be retried; the
  launch counters keep the replays of the segments that ran, which
  ``segment_runs`` counts per segment.

Graphs of one program are replayed in order on the caller's current
stream.  A program's warm run and captures take the kernels' scratch
(paged attention's tickets, the RG-LRU flags) in a scope of their own
(``_build.scratch_scope``), so no two programs' graphs share scratch.

Each thread captures on its own side stream (one per device and
thread), in ``capture_error_mode="thread_local"``: a compile-service
worker can capture a program while the serving thread replays another
one, allocates or synchronizes.  The launches a capture records are
counted on the capturing thread only (``_build.recording``), so the
serving thread's launches in the meantime do not leak into them.

Persistence (the compile cache's disk tier): the entry is the analysis
products only — schedule, liveness, allocation.  A CUDA graph cannot be
serialized, so a disk hit rebuilds the segment closures from the
freshly lowered program with the same fingerprint, and on the card the
graphs are captured again, in Phase 4 from the example arguments as a
fresh build captures them.  The JAX package also persists each
segment's exported XLA program (``_serialize_segment``) and points
XLA's own persistent compilation cache under the cache directory
(``_enable_jax_persistent_cache`` in its serve module); neither has a
counterpart here.  A restart thus saves Phase 4a-c's analysis and
nothing of Phases 1-3 or the capture.

A compile-cache hit shares the executor (as the JAX package does),
except where it cannot serve the new caller: different parameter
positions, or graphs captured with parameters at other addresses — then
the caller gets a new executor over the same analysis (``adopt``).

Not ported: buffer donation.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from ...kernels import _build
from ...runtime import chaos
from ..bufalloc import allocate
from ..executor import (AnalyzedProgram, ExecutorStats, PaddedExecutionMixin, analyze_program,
                        analyzed_from_persisted)
from ..lowering import RGIROp, RGIRProgram
from .base import Backend, register_backend

#: capture counters of this process (read by the serve checks): programs
#: captured, graphs captured, seconds spent in ``prepare``
CAPTURES: Dict[str, float] = {"programs": 0, "graphs": 0, "seconds": 0.0}

_CAPTURE_STREAMS: Dict[Tuple[Optional[int], int], torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per device and thread for every warm run and
    capture of that thread, so the kernels' per-stream scratch made by a
    warm run is the one its capture finds, and a worker thread's capture
    never shares a stream with the serving thread's."""
    key = (device.index, threading.get_ident())
    s = _CAPTURE_STREAMS.get(key)
    if s is None:
        s = _CAPTURE_STREAMS[key] = torch.cuda.Stream(device)
    return s


@contextlib.contextmanager
def capture_scope(device: torch.device, owner: int):
    """This thread's side stream (:func:`_capture_stream`), entered after
    the current stream's work, with a kernel-scratch scope of ``owner``'s
    own: an owner's warm runs and captures run inside one scope, so the
    scratch a warm run makes is the one its capture finds, also where
    autograd's device thread runs a backward on the stream.  Yields the
    stream; on exit the current stream waits for it."""
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream), _build.scratch_scope(owner, stream):
        yield stream
    torch.cuda.current_stream(device).wait_stream(stream)


def capture_graph(fn: Callable[[], Any], pool=None,
                  on_error: Optional[Callable[[Exception], Exception]] = None):
    """``fn()`` captured as one CUDA graph on the current stream; returns
    (graph, ``fn``'s outputs in the graph's pool, the kernel launches the
    capture recorded).  A capture launches nothing: the wrappers it runs
    count into this thread's recorder (and so do other threads' on the
    stream, a backward's on autograd's device thread), and the owner adds
    the delta at each replay.  When ``fn`` or the capture's end fails, the void
    capture is ended quietly and that first error raised (as
    ``on_error(error)`` when given)."""
    graph = torch.cuda.CUDAGraph()
    with _build.recording(torch.cuda.current_stream()) as rec:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outs = fn()
        except Exception as e:
            try:
                graph.capture_end()
            except Exception:  # noqa: BLE001 — the capture is void already
                pass
            if on_error is None:
                raise
            raise on_error(e) from e
        try:
            with warnings.catch_warnings():
                # a capture of views and reshapes launches no kernel: its
                # graph is empty, and replaying it costs nothing
                warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
                graph.capture_end()
        except Exception as e:
            if on_error is None:
                raise
            raise on_error(e) from e
    return graph, outs, rec.delta()


def count_capture(graphs: int, seconds: float) -> None:
    """Add one captured program of ``graphs`` graphs to :data:`CAPTURES`."""
    CAPTURES["programs"] += 1
    CAPTURES["graphs"] += graphs
    CAPTURES["seconds"] += seconds


class SegmentCaptureError(RuntimeError):
    """A segment could not be captured as one CUDA graph."""


@dataclass
class CompiledSegment:
    """One schedulable unit: a maximal device-affine instruction run."""

    index: int
    device: str
    start: int  # scheduled-order instruction range [start, stop)
    stop: int
    live_in: Tuple[int, ...]  # registers read from the buffer file
    live_out: Tuple[int, ...]  # registers written back to the buffer file
    free_after: Tuple[int, ...]  # buffer-file registers that die here
    fn: Callable  # (*live_in values) -> tuple of live_out values
    # -- dispatch plan: slot indices into the flat buffer file ------------
    in_slots: Tuple[int, ...] = ()
    out_slots: Tuple[int, ...] = ()
    free_slots: Tuple[int, ...] = ()


def _make_segment_fn(ops: Sequence[RGIROp], live_in: Tuple[int, ...],
                     live_out: Tuple[int, ...], drop: Sequence[Tuple[int, ...]]) -> Callable:
    """Replay ``ops`` over a local register env: the segment's program.
    ``drop[k]`` are the env registers whose last reader is ``ops[k]``:
    they leave the env there, so a temporary's memory is free for the
    next op (eager GC inside the segment).  ``fn.at[0]`` is the index of
    the op running (or that raised)."""
    plan = tuple(zip(ops, drop))
    at = [0]

    def seg_fn(*vals):
        env: Dict[int, Any] = dict(zip(live_in, vals))
        read = env.__getitem__
        for k, (op, dead) in enumerate(plan):
            at[0] = k
            for r, v in zip(op.output_regs, op.execute(read)):
                env[r] = v
            for r in dead:
                del env[r]
        return tuple(env[r] for r in live_out)

    seg_fn.at = at
    return seg_fn


class SegmentExecutor(PaddedExecutionMixin):
    """Segment-at-a-time executor over the physical buffer file; on the
    card, one CUDA graph replay per segment."""

    def __init__(self, analyzed: AnalyzedProgram, *,
                 static_inputs: Sequence[int] = (),
                 input_names: Optional[Sequence[str]] = None):
        self.analyzed = analyzed
        self.prog = analyzed.prog
        self.sched = analyzed.sched
        self.live = analyzed.live
        n = len(self.prog.ops)
        segments = self.sched.segments

        seg_of = [0] * n
        for si, seg in enumerate(segments):
            for i in range(seg.start, seg.stop):
                seg_of[i] = si

        # registers whose entire life [s, e] sits inside one segment never
        # touch the buffer file: they live in that segment's local env
        intervals = self.live.intervals
        internal: Set[int] = set()
        for r, (s, e) in intervals.items():
            if s < 0 or e >= n or r in self.live.pinned:
                continue
            if seg_of[s] == seg_of[e]:
                internal.add(r)
        self._internal = internal

        # segment-aware linear scan: only buffer-file registers get slots
        lifetimes = {r: iv for r, iv in intervals.items() if r not in internal}
        pinned = set(self.live.pinned)
        for r, (s, _) in lifetimes.items():
            if s < 0:
                pinned.add(r)
        self.alloc = allocate(lifetimes, pinned)
        self._r2b = self.alloc.reg_to_buf

        self._const_items = tuple((self._r2b[r], v) for r, v in self.prog.constants.items())
        self._input_bufs = [self._r2b[r] for r in self.prog.input_regs]
        self._output_bufs = [self._r2b[r] for r in self.prog.output_regs]
        # constant slots are never cleared: the executor pins their values
        const_slots = {b for b, _ in self._const_items}

        dead_after = self.live.dead_after
        self.segments: List[CompiledSegment] = []
        for si, seg in enumerate(segments):
            ops = self.prog.ops[seg.start:seg.stop]
            live_in_set: Set[int] = set()
            defined_here: Set[int] = set()
            for op in ops:
                for r in op.input_regs:
                    if intervals[r][0] < seg.start:
                        live_in_set.add(r)
                defined_here.update(op.output_regs)
            live_out = tuple(sorted(r for r in defined_here if r not in internal))
            live_in = tuple(sorted(live_in_set))
            free_after = tuple(sorted(r for idx in range(seg.start, seg.stop)
                                      for r in dead_after.get(idx, ()) if r not in internal))
            drop = [tuple(dead_after.get(idx, ())) for idx in range(seg.start, seg.stop)]
            self.segments.append(CompiledSegment(
                index=si,
                device=seg.device,
                start=seg.start,
                stop=seg.stop,
                live_in=live_in,
                live_out=live_out,
                free_after=free_after,
                fn=_make_segment_fn(ops, live_in, live_out, drop),
                in_slots=tuple(self._r2b[r] for r in live_in),
                out_slots=tuple(self._r2b[r] for r in live_out),
                free_slots=tuple(b for b in (self._r2b[r] for r in free_after)
                                 if b not in const_slots),
            ))
        self._plans = tuple((s.fn, s.in_slots, s.free_slots, s.out_slots)
                            for s in self.segments)

        occupied = set(const_slots) | set(self._input_bufs)
        peak = len(occupied)
        for s in self.segments:
            occupied.difference_update(self._r2b[r] for r in s.free_after)
            occupied.update(s.out_slots)
            peak = max(peak, len(occupied))
        self._static_peak = peak

        n_in = len(self._input_bufs)
        self._static_inputs = tuple(sorted(set(static_inputs)))
        if any(not 0 <= i < n_in for i in self._static_inputs):
            raise ValueError(f"static input positions {self._static_inputs} out of range "
                             f"for {n_in} inputs")
        self._input_names = (list(input_names) if input_names is not None
                             else [f"input {i}" for i in range(n_in)])
        #: dispatches of each segment, counted as it runs (a call that
        #: faulted after segment k counts segments 0..k-1): what the
        #: kernels' launch counters must add up to
        self.segment_runs: List[int] = [0] * len(self.segments)
        #: the card's replay state, made by prepare(): (graph, launches) per
        #: segment, the program's own input tensors, the parameters'
        #: addresses and the output tensors in the pool
        self._replay: Optional[Tuple[Any, ...]] = None

        self.stats = ExecutorStats(
            n_instructions=n,
            n_accel=sum(1 for op in self.prog.ops if op.device == "accel"),
            n_host=sum(1 for op in self.prog.ops if op.device == "host"),
            n_vregs=self.prog.n_vregs,
            n_buffers=self.alloc.n_buffers,
            rho_buf=(1.0 - self.alloc.n_buffers / self.prog.n_vregs
                     if self.prog.n_vregs else 0.0),
            delta_before=self.sched.delta_before,
            delta_after=self.sched.delta_after,
            n_segments=len(self.segments),
            # every segment is one CUDA graph on the card
            n_compiled_segments=len(self.segments),
            n_internal_regs=len(internal),
        )

    # -- the plain path: the segments' closures over the buffer file ------

    def _run_file(self, flat_inputs: Sequence[Any], faults: bool = True) -> List[Any]:
        """The segments' closures in order; ``faults`` consults the
        ``dispatch`` site before each segment (a call's dispatch, not the
        warm run of :meth:`prepare`)."""
        file: List[Any] = [None] * self.alloc.n_buffers
        for b, v in self._const_items:
            file[b] = v
        for b, v in zip(self._input_bufs, flat_inputs):
            file[b] = v
        for si, (fn, in_slots, free_slots, out_slots) in enumerate(self._plans):
            if faults:
                chaos.maybe_fault(chaos.SITE_DISPATCH)
            out_vals = fn(*[file[b] for b in in_slots])
            if faults:
                self.segment_runs[si] += 1
            # clear BEFORE the stores: a register dying inside this segment
            # may share its slot with a live-out born later in it
            for b in free_slots:
                file[b] = None
            for b, v in zip(out_slots, out_vals):
                file[b] = v
        return [file[b] for b in self._output_bufs]

    # -- the card: capture ------------------------------------------------

    @property
    def captured(self) -> bool:
        return self._replay is not None

    def prepare(self, *flat_inputs: Any) -> None:
        """Capture the program's CUDA graphs from inputs on the card (a
        no-op on CPU inputs or once captured)."""
        if self._replay is not None or not any(
                isinstance(x, torch.Tensor) and x.is_cuda for x in flat_inputs):
            return
        self._check_arity(flat_inputs)
        t0 = time.perf_counter()
        dev = next(x.device for x in flat_inputs if x.is_cuda)
        static = set(self._static_inputs)
        own: List[Tuple[int, torch.Tensor]] = []
        values = list(flat_inputs)
        for i, x in enumerate(flat_inputs):
            if x.device != dev:
                raise ValueError(f"segment_jit: {self._input_names[i]} is on {x.device}, not "
                                 f"{dev}: a captured program reads its inputs on the card")
            if i not in static:
                values[i] = x.clone()  # the program's own input tensor
                own.append((i, values[i]))
        with torch.no_grad(), capture_scope(dev, id(self)) as stream:
            # warm run: the kernels' libraries, cuBLAS's handles and the
            # kernels' per-stream scratch exist before any capture
            self._run_file(values, faults=False)
            stream.synchronize()
            pool = torch.cuda.graph_pool_handle()
            file: List[Any] = [None] * self.alloc.n_buffers
            for b, v in self._const_items:
                file[b] = v
            for b, v in zip(self._input_bufs, values):
                file[b] = v
            graphs = []
            for seg in self.segments:
                graph, outs, launches = self._capture(
                    seg, [file[b] for b in seg.in_slots], pool, stream)
                graphs.append((graph, launches))
                for b in seg.free_slots:
                    file[b] = None
                for b, v in zip(seg.out_slots, outs):
                    file[b] = v
            outputs = [file[b] for b in self._output_bufs]
        params = tuple((i, flat_inputs[i].data_ptr()) for i in self._static_inputs)
        self._replay = (tuple(graphs), tuple(own), params, outputs)
        seconds = time.perf_counter() - t0
        self.stats.capture_s = seconds
        count_capture(len(graphs), seconds)

    def _capture(self, seg: CompiledSegment, args: List[Any], pool, stream):
        """One segment as one CUDA graph (:func:`capture_graph`); a failure
        names the segment's first op that cannot be captured."""
        return capture_graph(lambda: seg.fn(*args), pool,
                             lambda e: self._capture_error(seg, args, stream, e))

    def _capture_error(self, seg: CompiledSegment, args: List[Any], stream,
                       cause: Exception) -> SegmentCaptureError:
        """Name the segment and its first op that cannot be captured: each
        op captured alone in a throwaway graph, in order."""
        env: Dict[int, Any] = dict(zip(seg.live_in, args))
        bad = None
        for k, op in enumerate(self.prog.ops[seg.start:seg.stop]):
            g = torch.cuda.CUDAGraph()
            ok, outs = True, None
            with _build.recording():  # throwaway captures launch nothing
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    outs = op.execute(env.__getitem__)
                except Exception:  # noqa: BLE001 — this op is the one
                    ok = False
                try:
                    g.capture_end()
                except Exception:  # noqa: BLE001
                    ok = False
            if not ok:
                bad = (seg.start + k, op.opcode)
                break
            env.update(zip(op.output_regs, outs))
        where = (f"first bad op {bad[0]} {bad[1]}" if bad is not None
                 else f"no op fails alone (op {seg.start + seg.fn.at[0]} was running)")
        return SegmentCaptureError(
            f"segment {seg.index} ({seg.device}, ops {seg.start}-{seg.stop - 1}) cannot be "
            f"captured as a CUDA graph: {where}: {type(cause).__name__}: {cause}")

    # -- execution -------------------------------------------------------

    def _check_arity(self, flat_inputs: Sequence[Any]) -> None:
        if len(flat_inputs) != len(self._input_bufs):
            raise TypeError(f"executor expects {len(self._input_bufs)} inputs, "
                            f"got {len(flat_inputs)}")

    def execute(self, *flat_inputs: Any) -> List[Any]:
        """Run segment-at-a-time: exactly ``n_segments`` dispatches (on the
        card, graph replays; on the CPU, the segments' closures)."""
        self._check_arity(flat_inputs)
        if self._replay is None:
            self.prepare(*flat_inputs)
        if self._replay is None:
            outs = self._run_file(flat_inputs)
        else:
            outs = self._run_graphs(flat_inputs)
        self.stats.note_call(self._static_peak, segments_executed=len(self.segments))
        return outs

    def _run_graphs(self, flat_inputs: Sequence[Any]) -> List[Any]:
        graphs, own, params, outputs = self._replay
        for i, ptr in params:
            if flat_inputs[i].data_ptr() != ptr:
                raise ValueError(
                    f"segment_jit: parameter {self._input_names[i]} moved since its program "
                    f"was captured; a captured program reads parameters at their address "
                    f"(compile a new program for new parameter tensors)")
        srcs = [flat_inputs[i] for i, _ in own]
        for (i, buf), x in zip(own, srcs):
            if x.shape != buf.shape or x.dtype != buf.dtype or x.device != buf.device:
                raise ValueError(f"segment_jit: {self._input_names[i]} is {tuple(x.shape)} "
                                 f"{x.dtype} on {x.device}, the program was captured at "
                                 f"{tuple(buf.shape)} {buf.dtype} on {buf.device}")
        if own:  # one multi-tensor copy, not a launch per input
            torch._foreach_copy_([buf for _, buf in own], srcs)
        runs = self.segment_runs
        for si, (graph, launches) in enumerate(graphs):
            # fires before this segment replays: the caller's tensors were
            # only read (copied into the program's own inputs), so a
            # retried call replays every segment from the first
            chaos.maybe_fault(chaos.SITE_DISPATCH)
            graph.replay()
            runs[si] += 1
            if launches:
                _build.add_launches(launches)
        outs = [torch.empty_like(o) for o in outputs]
        if outs:
            torch._foreach_copy_(outs, outputs)
        return outs

    def as_fn(self) -> Callable:
        """The executor as a plain callable on flat inputs."""
        return self.execute


@register_backend
class SegmentJitBackend(Backend):
    name = "segment_jit"

    def build(self, prog: RGIRProgram, *, static_inputs: Sequence[int] = (),
              input_names: Optional[Sequence[str]] = None,
              reorder: bool = True) -> SegmentExecutor:
        return SegmentExecutor(analyze_program(prog, reorder=reorder),
                               static_inputs=static_inputs,
                               input_names=input_names)

    # -- persistence: the analysis products (a CUDA graph cannot be
    # serialized; see the module docstring) ------------------------------

    def export_entry(self, prog: RGIRProgram, executor: Any) -> Optional[Dict[str, Any]]:
        if not isinstance(executor, SegmentExecutor):
            return None
        # ``alloc`` is carried for AnalyzedProgram completeness only: the
        # rebuilt executor recomputes its segment-aware scan from ``live``
        # exactly as a fresh build does
        return {"kind": self.name, "n_ops": len(executor.prog.ops), "sched": executor.sched,
                "live": executor.live, "alloc": executor.analyzed.alloc}

    def build_from_entry(self, prog: RGIRProgram, entry: Dict[str, Any], *,
                         static_inputs: Sequence[int] = (),
                         input_names: Optional[Sequence[str]] = None,
                         reorder: bool = True) -> Optional[SegmentExecutor]:
        if entry.get("kind") != self.name or entry.get("n_ops") != len(prog.ops):
            return None
        analyzed = analyzed_from_persisted(prog, entry["sched"], entry["live"], entry["alloc"])
        if analyzed is None:
            return None
        try:
            return SegmentExecutor(analyzed, static_inputs=static_inputs,
                                   input_names=input_names)
        except Exception:
            return None

    def adopt(self, executor: Any, *, static_inputs: Sequence[int] = (),
              input_names: Optional[Sequence[str]] = None,
              flat_inputs: Sequence[Any] = ()) -> Any:
        """Share ``executor`` unless its parameter positions differ, or its
        graphs read parameters at other addresses than ``flat_inputs``':
        then a new executor over the same analysis (captured anew)."""
        if not isinstance(executor, SegmentExecutor):
            return executor
        static = tuple(sorted(set(static_inputs)))
        fits = executor._static_inputs == static
        if fits and executor._replay is not None:
            params = executor._replay[2]
            fits = all(i < len(flat_inputs) and isinstance(flat_inputs[i], torch.Tensor)
                       and flat_inputs[i].data_ptr() == ptr for i, ptr in params)
        if fits:
            return executor
        return SegmentExecutor(executor.analyzed, static_inputs=static,
                               input_names=input_names)
