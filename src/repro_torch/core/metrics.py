"""The paper's evaluation metrics (§5) and the fidelity protocol (§6.5).

* **per-pass profiling** — τ(p_k); produced by the pipeline itself
  (``CompilationResult.pass_table``).
* **FGR** (Eq. 22) — CostModel(α=0) / CostModel(α=1): a cost-model-
  internal diagnostic of fusion impact.  NOT a latency ratio (the
  paper's caveat retained).
* **CEI** (Eq. 23) — (L_baseline / L_forge) / T_compile_seconds:
  latency speedup delivered per second of compile time.
* **fidelity** — max-abs logit difference and KL divergence between
  pre- and post-compilation outputs (paper Table 6 protocol), and the
  same between every Phase-4 backend and the ``reference`` oracle.

The bucketed, prefill and ragged-decode fidelity checks of the JAX
package wait for the compile cache and the pad-and-mask call of
``BucketedModule``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from .capture import trace_to_graph
from .compiler import ForgeCompiler
from .cost_model import score_graph
from .passes import PipelineConfig, run_forge_passes

#: the paper's reported fidelity bounds (Table 6)
PAPER_MAX_ABS = 2.1e-5
PAPER_MAX_KL = 8.4e-9


# --------------------------------------------------------------------------
# FGR
# --------------------------------------------------------------------------


def fusion_gain_ratio(
    fn: Callable,
    *example_args: Any,
    config: Optional[PipelineConfig] = None,
) -> Dict[str, float]:
    """FGR = Score(α=0) / Score(α=1)  (paper Eq. 22): two captures of
    ``fn``, one through the pipeline without fusion, one with all of it."""
    base = config or PipelineConfig()

    def _score(alpha: float) -> float:
        cfg = dataclasses.replace(base, alpha=alpha, enable=dict(base.enable))
        g = trace_to_graph(fn, *example_args).graph
        run_forge_passes(g, cfg=cfg)
        return score_graph(g, cfg.precision).score

    s0 = _score(0.0)
    s1 = _score(1.0)
    return {"score_alpha0": s0, "score_alpha1": s1, "fgr": s0 / max(s1, 1e-12)}


# --------------------------------------------------------------------------
# CEI
# --------------------------------------------------------------------------


def compilation_efficiency_index(
    latency_baseline_ms: float,
    latency_forge_ms: float,
    compile_time_ms: float,
) -> float:
    """CEI_B = (L_B / L_forge) / T_compile^(s)  (paper Eq. 23)."""
    speedup = latency_baseline_ms / max(latency_forge_ms, 1e-12)
    return speedup / max(compile_time_ms / 1e3, 1e-12)


# --------------------------------------------------------------------------
# Numerical fidelity (paper §6.5 protocol, Table 6)
# --------------------------------------------------------------------------


@dataclass
class FidelityReport:
    max_abs_diff: float
    kl_divergence: float
    n_elements: int

    def ok(self, max_abs: float = PAPER_MAX_ABS, max_kl: float = PAPER_MAX_KL) -> bool:
        """Check against the paper's reported bounds (Table 6)."""
        return self.max_abs_diff <= max_abs and self.kl_divergence <= max_kl


def _kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> float:
    """Mean KL(P‖Q) over the last axis of logits."""
    p = torch.log_softmax(p_logits.float(), dim=-1)
    q = torch.log_softmax(q_logits.float(), dim=-1)
    return float((p.exp() * (p - q)).sum(-1).mean())


def fidelity(pre_outputs: Any, post_outputs: Any, *,
             logits_are_last_axis: bool = True) -> FidelityReport:
    """Compare pre- vs post-compilation outputs (logit-level, Table 6)."""
    pre_flat = pytree.tree_leaves(pre_outputs)
    post_flat = pytree.tree_leaves(post_outputs)
    if len(pre_flat) != len(post_flat):
        raise ValueError(f"output arity mismatch: {len(pre_flat)} vs {len(post_flat)}")
    max_abs = kl = 0.0
    n = 0
    for a, b in zip(pre_flat, post_flat):
        a, b = a.detach().float(), b.detach().float()
        if a.numel():
            max_abs = max(max_abs, float((a - b).abs().max()))
        if logits_are_last_axis and a.dim() >= 1 and a.shape[-1] > 1:
            kl = max(kl, _kl(a, b))
        n += a.numel()
    return FidelityReport(max_abs_diff=max_abs, kl_divergence=kl, n_elements=n)


def check_compilation_fidelity(
    fn: Callable,
    *concrete_args: Any,
    config: Optional[PipelineConfig] = None,
) -> FidelityReport:
    """End-to-end protocol: run ``fn`` raw vs Forge-compiled, compare."""
    with torch.no_grad():
        pre = fn(*concrete_args)
        mod = ForgeCompiler(config or PipelineConfig()).compile(fn, *concrete_args)
        post = mod(*concrete_args)
    return fidelity(pre, post)


def check_backend_fidelity(
    fn: Callable,
    *concrete_args: Any,
    backends: Sequence[str] = ("interpret", "segment_jit"),
    config: Optional[PipelineConfig] = None,
) -> Dict[str, FidelityReport]:
    """Compare every Phase-4 backend against the ``reference`` oracle.

    The reference backend executes the same lowered program with no
    scheduling and no buffer sharing, so any divergence here isolates a
    Phase-4 (backend-layer) bug from a Phase-1..3 one."""
    cfg = config or PipelineConfig()
    with torch.no_grad():
        oracle = ForgeCompiler(cfg, backend="reference").compile(fn, *concrete_args)
        ref_out = oracle(*concrete_args)
        reports: Dict[str, FidelityReport] = {}
        for name in backends:
            mod = ForgeCompiler(cfg, backend=name).compile(fn, *concrete_args)
            reports[name] = fidelity(ref_out, mod(*concrete_args))
    return reports
