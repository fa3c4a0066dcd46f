"""Phase 4b — linear-scan buffer allocation (paper §4.5.2, Listing 8).

Maps N virtual registers to M physical buffer slots (M ≪ N) using the
classic Poletto & Sarkar linear scan over live intervals — O(N log N)
versus the O(N²) graph-coloring the paper attributes to OpenVINO.
Non-interfering intervals share a slot; pinned registers (inputs,
constants, outputs) always get dedicated slots.

ρ_buf = 1 − M/N is the buffer-reduction ratio reported in the paper's
Table 16 (30–48 % for transformer graphs).

This module also hosts the **donation analysis** consumed by the
``segment_jit`` backend (DESIGN.md §segment_jit donation semantics): for
each device-affine segment, which live-in registers can be handed to
XLA as donated arguments so their device buffers are reused in place
for the segment's outputs instead of re-materializing every live-out.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .liveness import LivenessInfo


@dataclass
class AllocationResult:
    reg_to_buf: Dict[int, int]
    n_buffers: int
    n_vregs: int

    @property
    def rho_buf(self) -> float:
        """Buffer reduction ratio (paper Eq. 15)."""
        if self.n_vregs == 0:
            return 0.0
        return 1.0 - self.n_buffers / self.n_vregs


def allocate(
    lifetimes: Dict[int, Tuple[int, int]],
    pinned: Optional[Set[int]] = None,
) -> AllocationResult:
    """Greedy left-to-right linear scan (paper Listing 8 / Algorithm 2)."""
    pinned = pinned or set()
    sorted_regs = sorted(lifetimes, key=lambda r: (lifetimes[r][0], r))

    reg_to_buf: Dict[int, int] = {}
    free_bufs: List[int] = []
    active: List[Tuple[int, int]] = []  # (end, buf)
    next_buf = 0

    for reg in sorted_regs:
        start, end = lifetimes[reg]
        still_alive: List[Tuple[int, int]] = []
        for end_t, buf_id in active:
            if end_t < start:
                free_bufs.append(buf_id)
            else:
                still_alive.append((end_t, buf_id))
        active = still_alive

        if reg in pinned or not free_bufs:
            buf = next_buf
            next_buf += 1
        else:
            buf = free_bufs.pop(0)
        reg_to_buf[reg] = buf
        if reg not in pinned:
            active.append((end, buf))
        # pinned regs never return to the free pool (dedicated slots)

    return AllocationResult(
        reg_to_buf=reg_to_buf, n_buffers=next_buf, n_vregs=len(lifetimes)
    )


def segment_donations(
    live: LivenessInfo,
    reg_avals: Dict[int, Any],
    *,
    live_in: Sequence[int],
    live_out: Sequence[int],
    free_after: Sequence[int],
) -> Tuple[int, ...]:
    """Positions in ``live_in`` that a segment may donate to XLA.

    A live-in register is safely donatable exactly when its buffer is
    dead on segment exit and owned by the executor's scratch arena:

    * it dies **inside** the segment (member of ``free_after``) — its
      last reader is one of the segment's own instructions, so nothing
      after the segment, and no other segment, ever reads it again;
    * it is an intermediate (interval start ≥ 0): program inputs and
      constants are born at −1 and owned by the caller / constant pool,
      and donating them would invalidate buffers the executor does not
      own (e.g. the weights passed to every serve call);
    * it is not pinned (program outputs outlive every segment).

    Safety alone makes donation a no-op unless XLA can actually alias
    the buffer onto an output, which requires an output of identical
    shape/dtype.  Donated positions are therefore matched greedily
    against the multiset of live-out avals — one donated arg per
    compatible live-out — which is the slot-reuse condition of the
    linear scan lifted to the XLA level, and keeps every donated buffer
    usable (no "donated buffers were not usable" churn).
    """
    dying = set(free_after)
    budget = Counter(
        (tuple(reg_avals[r].shape), str(reg_avals[r].dtype))
        for r in live_out
    )
    donate: List[int] = []
    for pos, r in enumerate(live_in):
        if r not in dying or r in live.pinned:
            continue
        if live.intervals[r][0] < 0:  # caller-owned input / constant
            continue
        key = (tuple(reg_avals[r].shape), str(reg_avals[r].dtype))
        if budget[key] > 0:
            budget[key] -= 1
            donate.append(pos)
    return tuple(donate)


def allocate_from_liveness(live: LivenessInfo) -> AllocationResult:
    pinned = set(live.pinned)
    # inputs/constants (born at -1) also get dedicated slots: they are
    # owned by the caller / constant pool, not the scratch arena
    for r, (s, _) in live.intervals.items():
        if s < 0:
            pinned.add(r)
    return allocate(live.intervals, pinned)


def validate_allocation(
    alloc: AllocationResult, live: LivenessInfo
) -> None:
    """Assert no two simultaneously-live registers share a buffer.

    Used by the property tests: for every pair mapped to the same buffer,
    their intervals must not overlap (unless pinned-dedicated).
    """
    by_buf: Dict[int, List[int]] = {}
    for r, b in alloc.reg_to_buf.items():
        by_buf.setdefault(b, []).append(r)
    for b, regs in by_buf.items():
        for i in range(len(regs)):
            for j in range(i + 1, len(regs)):
                r1, r2 = regs[i], regs[j]
                if not live.interference_free(r1, r2):
                    raise AssertionError(
                        f"buffer {b} double-booked: r{r1}{live.intervals[r1]} "
                        f"overlaps r{r2}{live.intervals[r2]}"
                    )
