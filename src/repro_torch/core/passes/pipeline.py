"""Phase-2 pass pipeline — the ``run_fx_passes`` fixpoint loop.

Applies the pass list sequentially, re-running until no pass reports a
mutation or ``MAX_ROUNDS`` is reached (paper default: 2 rounds).  Every
invocation is timed and its node delta recorded
(:class:`~repro_torch.core.passes.base.PassRecord`), feeding the
``CompilationResult`` per-pass profile (paper metric 1, Table 10).

The port carries DCE, CSE, attention fusion and operator fusion;
constant folding, device constants and the layout pass come in a later
slice, so :func:`default_passes` omits them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..graph import Graph
from .base import ForgePass, PassRecord, timed_run
from .dce import DCEPass
from .cse import CSEPass
from .attention_fusion import AttentionFusionPass
from .operator_fusion import OperatorFusionPass


#: fixpoint rounds (paper default)
MAX_ROUNDS = 2


def default_passes(impl: Optional[str] = None) -> List[ForgePass]:
    """DCE, CSE, attention fusion, operator fusion.  ``impl`` is forwarded
    into the fused nodes: None dispatches by device, ``"ref"`` runs the
    kernels' plain versions."""
    return [DCEPass(), CSEPass(), AttentionFusionPass(impl=impl), OperatorFusionPass(impl=impl)]


def run_forge_passes(
    g: Graph,
    passes: Optional[Sequence[ForgePass]] = None,
    *,
    impl: Optional[str] = None,
) -> List[PassRecord]:
    """Run the pipeline to fixpoint; returns the per-pass records."""
    passes = list(passes) if passes is not None else default_passes(impl)
    records: List[PassRecord] = []
    for rnd in range(MAX_ROUNDS):
        any_mod = False
        for p in passes:
            rec = timed_run(p, g, rnd)
            records.append(rec)
            any_mod |= rec.modified
        g.validate()
        if not any_mod:
            break
    return records
