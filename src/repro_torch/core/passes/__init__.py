"""Phase 2 — the composable, inspectable optimization passes.

Pass order mirrors the paper's pipeline (Figure 1 / Table 10):
DCE → CSE → attention fusion → operator fusion, iterated to fixpoint.
"""
from .base import ForgePass, PassRecord, timed_run
from .dce import DCEPass
from .cse import CSEPass
from .attention_fusion import AttentionFusionPass
from .operator_fusion import OperatorFusionPass
from .pipeline import MAX_ROUNDS, default_passes, run_forge_passes

__all__ = [
    "ForgePass",
    "PassRecord",
    "timed_run",
    "DCEPass",
    "CSEPass",
    "AttentionFusionPass",
    "OperatorFusionPass",
    "MAX_ROUNDS",
    "default_passes",
    "run_forge_passes",
]
