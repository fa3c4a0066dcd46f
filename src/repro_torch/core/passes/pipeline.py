"""Phase-2 pass pipeline — the ``run_fx_passes`` fixpoint loop.

Applies the pass list sequentially, re-running until no pass reports a
mutation or ``max_rounds`` is reached (paper default: 2 rounds, the
autotuner's ``iota`` knob).  Every invocation is timed and its node delta
recorded (:class:`~repro_torch.core.passes.base.PassRecord`), feeding the
``CompilationResult`` per-pass profile (paper metric 1, Table 10).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from ..graph import Graph
from .base import ForgePass, PassRecord, timed_run
from .dce import DCEPass
from .cse import CSEPass
from .fold import ConstantFoldingPass
from .device_const import DeviceConstantPass
from .attention_fusion import AttentionFusionPass
from .operator_fusion import OperatorFusionPass
from .layout import LayoutOptimizationPass


@dataclass
class PipelineConfig:
    """The autotuner's configuration space 𝒞 = {α, λ, π, ι} (paper Eq. 19)."""

    #: fusion aggressiveness α ∈ [0, 1]: the first ⌈α·n⌉ of n matches fuse
    alpha: float = 1.0
    #: layout strategy λ: 'auto' runs the layout pass, 'hints' only its
    #: tile annotation, 'off' drops it
    layout: str = "auto"
    #: kernel dispatch precision π hint (the cost model's precision factor)
    precision: Optional[str] = None
    #: max fixpoint iterations ι
    max_rounds: int = 2
    #: kernel impl forwarded into fused node params: None dispatches by
    #: device, "ref" runs the kernels' plain versions
    impl: Optional[str] = None
    #: enable the beyond-paper SwiGLU mega-fusion
    swiglu_fusion: bool = True
    #: Phase-4 code generator: 'interpret' | 'segment_jit' | 'reference'
    backend: str = "interpret"
    #: memoize backend builds in the content-addressed compile cache
    compile_cache: bool = True
    #: enable individual passes (ablation hooks, paper Table 14)
    enable: dict = field(default_factory=dict)

    def enabled(self, name: str) -> bool:
        return bool(self.enable.get(name, True))


def default_passes(cfg: Optional[PipelineConfig] = None) -> List[ForgePass]:
    """DCE, CSE, constant folding, device constants, attention fusion,
    operator fusion and layout, in the paper's order, as ``cfg`` enables
    them."""
    cfg = cfg or PipelineConfig()
    passes: List[ForgePass] = []
    if cfg.enabled("dce"):
        passes.append(DCEPass())
    if cfg.enabled("cse"):
        passes.append(CSEPass())
    if cfg.enabled("constant_folding"):
        passes.append(ConstantFoldingPass())
    if cfg.enabled("device_constant"):
        passes.append(DeviceConstantPass())
    if cfg.enabled("attention_fusion") and cfg.alpha > 0:
        passes.append(AttentionFusionPass(alpha=cfg.alpha, impl=cfg.impl))
    if cfg.enabled("operator_fusion") and cfg.alpha > 0:
        passes.append(OperatorFusionPass(alpha=cfg.alpha, impl=cfg.impl,
                                         enable_swiglu=cfg.swiglu_fusion))
    if cfg.enabled("layout_optimization") and cfg.layout != "off":
        passes.append(LayoutOptimizationPass(rewrite=(cfg.layout != "hints")))
    return passes


def run_forge_passes(
    g: Graph,
    passes: Optional[Sequence[ForgePass]] = None,
    cfg: Optional[PipelineConfig] = None,
) -> List[PassRecord]:
    """Run the pipeline to fixpoint; returns the per-pass records."""
    cfg = cfg or PipelineConfig()
    passes = list(passes) if passes is not None else default_passes(cfg)
    records: List[PassRecord] = []
    for rnd in range(max(1, cfg.max_rounds)):
        any_mod = False
        for p in passes:
            rec = timed_run(p, g, rnd)
            records.append(rec)
            any_mod |= rec.modified
        g.validate()
        if not any_mod:
            break
    return records
