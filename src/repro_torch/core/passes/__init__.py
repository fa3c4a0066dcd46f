"""Phase 2 — the composable, inspectable optimization passes.

Pass order mirrors the paper's pipeline (Figure 1 / Table 10):
DCE → CSE → constant folding → device constant → attention fusion →
operator fusion → layout optimization, iterated to fixpoint.
"""
from .base import ForgePass, PassRecord, timed_run
from .dce import DCEPass
from .cse import CSEPass
from .fold import ConstantFoldingPass
from .device_const import DeviceConstantPass
from .attention_fusion import AttentionFusionPass
from .operator_fusion import OperatorFusionPass
from .layout import HOPPER_PREFERRED_TILES, LayoutOptimizationPass
from .pipeline import PipelineConfig, default_passes, run_forge_passes

__all__ = [
    "ForgePass",
    "PassRecord",
    "timed_run",
    "DCEPass",
    "CSEPass",
    "ConstantFoldingPass",
    "DeviceConstantPass",
    "AttentionFusionPass",
    "OperatorFusionPass",
    "HOPPER_PREFERRED_TILES",
    "LayoutOptimizationPass",
    "PipelineConfig",
    "default_passes",
    "run_forge_passes",
]
