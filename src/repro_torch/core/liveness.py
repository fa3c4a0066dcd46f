"""Phase 4a — liveness analysis over the RGIR instruction stream.

For each virtual register r_i we compute the live interval [s_i, e_i]
(paper Eq. 14): s_i is the index of the unique writing instruction, e_i
the index of the last reader.  Program inputs and constants are born at
-1; program outputs die at len(ops) (pinned past the end).  The analyzer
also emits the ``dead_after`` map (instruction index -> registers whose
last use is that instruction) consumed by the executor's eager
register-file GC (paper §4.5.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from .lowering import RGIRProgram


@dataclass
class LivenessInfo:
    #: reg -> (start, end) instruction indices
    intervals: Dict[int, Tuple[int, int]]
    #: instruction index -> regs to free right after it executes
    dead_after: Dict[int, List[int]]
    #: registers that must never be freed / share buffers with others
    pinned: Set[int] = field(default_factory=set)

    def interference_free(self, r1: int, r2: int) -> bool:
        """True iff the two registers can share a physical buffer."""
        s1, e1 = self.intervals[r1]
        s2, e2 = self.intervals[r2]
        return e1 < s2 or e2 < s1


def analyze_liveness(prog: RGIRProgram) -> LivenessInfo:
    n = len(prog.ops)
    start: Dict[int, int] = {}
    end: Dict[int, int] = {}

    for r in prog.input_regs:
        start[r] = -1
        end[r] = -1
    for r in prog.constants:
        start[r] = -1
        end[r] = -1

    for idx, op in enumerate(prog.ops):
        for r in op.input_regs:
            end[r] = max(end.get(r, idx), idx)
            start.setdefault(r, -1)  # defensive: unseen reg treated as input
        for r in op.output_regs:
            start[r] = idx
            end.setdefault(r, idx)

    pinned: Set[int] = set(prog.output_regs)
    for r in prog.output_regs:
        end[r] = n  # outputs live past the last instruction
        start.setdefault(r, -1)

    intervals = {r: (start[r], end[r]) for r in start}

    dead_after: Dict[int, List[int]] = {}
    for r, (s, e) in intervals.items():
        if r in pinned or e >= n or e < 0:
            continue
        dead_after.setdefault(e, []).append(r)

    return LivenessInfo(intervals=intervals, dead_after=dead_after, pinned=pinned)
