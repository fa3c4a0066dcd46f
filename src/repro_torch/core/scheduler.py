"""Phase 4c — device-affinity instruction scheduling (paper §4.5.3).

Reorders the RGIR stream to minimize accel↔host device transitions
δ(I) (Eq. 16/17) while respecting data dependencies: a priority-based
topological sort that, among ready instructions, prefers one on the same
device as the most recently scheduled instruction; ties break on original
program order (stable, deterministic — the paper's reproducibility claim
relies on this).

On the paper's NPU each transition costs 0.3–0.8 ms of PCIe/MMIO traffic;
the TPU analogue is kernel-boundary HBM round-trips plus (in the
interpreted executor) per-dispatch host overhead.  δ reduction is reported
exactly as in paper Table 21.

Soundness note: the paper runs liveness → allocation → scheduling; since
reordering changes live intervals, we schedule *first* and re-run
liveness/allocation on the scheduled order (recorded in DESIGN.md).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

from .lowering import RGIRProgram


@dataclass(frozen=True)
class Segment:
    """One maximal device-affine run of the *scheduled* stream.

    ``[start, stop)`` indexes into the scheduled instruction order; every
    instruction inside is on ``device``.  Segments are the unit handed to
    a backend as a single compiled program (nGraph/oneDNN-graph style
    partitions), so by construction ``n_segments == δ_after + 1``.
    """

    start: int  # inclusive, scheduled-order index
    stop: int  # exclusive
    device: str  # 'accel' | 'host'

    def __len__(self) -> int:
        return self.stop - self.start


def compute_segments(devices: Sequence[str]) -> List[Segment]:
    """Partition a device sequence into maximal same-device runs."""
    segments: List[Segment] = []
    start = 0
    for i in range(1, len(devices) + 1):
        if i == len(devices) or devices[i] != devices[start]:
            segments.append(Segment(start=start, stop=i, device=devices[start]))
            start = i
    return segments


@dataclass
class ScheduleResult:
    order: List[int]  # permutation: new position -> old index
    delta_before: int
    delta_after: int
    #: maximal device-affine runs of the scheduled stream (tile [0, n))
    segments: List[Segment] = field(default_factory=list)

    @property
    def transition_reduction(self) -> float:
        if self.delta_before == 0:
            return 0.0
        return 1.0 - self.delta_after / self.delta_before

    @property
    def n_segments(self) -> int:
        return len(self.segments)


def _transitions(devices: List[str]) -> int:
    return sum(1 for a, b in zip(devices, devices[1:]) if a != b)


def schedule(prog: RGIRProgram) -> ScheduleResult:
    """Greedy device-affinity topological sort (paper §4.5.3)."""
    n = len(prog.ops)
    writer: Dict[int, int] = {}
    for i, op in enumerate(prog.ops):
        for r in op.output_regs:
            writer[r] = i

    preds: List[Set[int]] = [set() for _ in range(n)]
    succs: List[Set[int]] = [set() for _ in range(n)]
    for i, op in enumerate(prog.ops):
        for r in op.input_regs:
            w = writer.get(r)
            if w is not None and w != i:
                preds[i].add(w)
                succs[w].add(i)

    indeg = [len(p) for p in preds]
    # two ready heaps keyed by original index (stability)
    ready: Dict[str, List[int]] = {"accel": [], "host": []}
    for i in range(n):
        if indeg[i] == 0:
            heapq.heappush(ready[prog.ops[i].device], i)

    order: List[int] = []
    last_dev = None
    while len(order) < n:
        dev = last_dev if last_dev is not None and ready[last_dev] else None
        if dev is None:
            # fall back to whichever device has the earliest ready op
            candidates = [(h[0], d) for d, h in ready.items() if h]
            if not candidates:
                raise RuntimeError("scheduler: dependency cycle in RGIR")
            _, dev = min(candidates)
        i = heapq.heappop(ready[dev])
        order.append(i)
        last_dev = dev
        for j in succs[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(ready[prog.ops[j].device], j)

    before = _transitions([op.device for op in prog.ops])
    scheduled_devices = [prog.ops[i].device for i in order]
    after = _transitions(scheduled_devices)
    return ScheduleResult(
        order=order,
        delta_before=before,
        delta_after=after,
        segments=compute_segments(scheduled_devices),
    )


def verify_topological(prog: RGIRProgram, order: List[int]) -> None:
    """Property check: every operand is produced before it is consumed."""
    pos = {old: new for new, old in enumerate(order)}
    writer: Dict[int, int] = {}
    for i, op in enumerate(prog.ops):
        for r in op.output_regs:
            writer[r] = i
    for i, op in enumerate(prog.ops):
        for r in op.input_regs:
            w = writer.get(r)
            if w is not None and w != i and pos[w] >= pos[i]:
                raise AssertionError(
                    f"schedule violates dependency: op{w} must precede op{i}"
                )
