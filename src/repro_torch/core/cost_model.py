"""Heuristic accelerator cost model (paper §4.6, Eq. 18).

    Score(G) = w₁·n_ops + w₂·n_weights + w₃·n_linear + w₄·d_graph
             + w₅·s_params,   × fusion bonuses

Lower scores indicate configurations better suited for accelerator
execution.  As in the paper, this is a *heuristic proxy*: scores are not
proportional to wall-clock latency (the FGR caveat, §5.2) — they weight
per-op dispatch overhead heavily, which fusion collapses, so FGR values
land far above measured speedups by design.

The weights and the multiplicative fusion bonuses are the JAX package's
(``repro/core/cost_model.py``): host-side glue dispatches dominate
unfused graphs, a fused dispatch costs a small fraction of the chain it
replaces, and the static terms (weights, parameters) keep scores
comparable across model scales.  The bonuses fire when attention fusion
/ operator fusion actually rewrote the graph.

Beyond the paper, :func:`roofline_score` is a FLOPs/bytes estimate of one
call on an NVIDIA H100 SXM: the larger of the operations over the bf16
tensor-core peak and the bytes over the HBM3 rate, plus a per-dispatch
overhead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .graph import Graph
from .lowering import ACCEL_OPS, node_flops

# Eq. 18 weights (heuristic calibration — see module docstring)
W_OPS = 1.0  # per-op dispatch overhead
W_WEIGHTS = 0.05  # per weight tensor
W_LINEAR = -0.3  # linear-fraction discount (products run well on tensor cores)
W_DEPTH = 0.10  # critical-path length
W_PARAMS = 0.02  # per-M parameters resident

# multiplicative fusion bonuses
BONUS_ATTENTION = 0.15
BONUS_OPERATOR = 0.55

# precision factors (the π knob): cheaper dispatch at lower precision
PRECISION_FACTOR = {"bf16": 1.0, "fp32": 1.35, "mixed": 1.1, None: 1.0}


@dataclass
class CostBreakdown:
    n_ops: int
    n_weights: int
    linear_frac: float
    depth: int
    params_m: float
    n_fused: int
    n_attn_fused: int
    score: float

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


def _is_linear_class(op: str) -> bool:
    return is_fused_unit(op) or op in ACCEL_OPS


#: op-name prefixes of the fused dispatch units: the Phase-2 fusions
#: (``forge.<kind>``), the opaque units the capture keeps whole
#: (``kernels/ops.forge_op``: ``repro_torch.forge_<name>``) and the RG-LRU
#: scan's custom op, which the JAX package wraps in ``forge_op("rg_lru")``
#: where the port calls the kernel's op directly
FUSED_UNIT_PREFIXES = ("forge.", "repro_torch.forge_", "repro_torch.rg_lru.")


def is_fused_unit(op: str) -> bool:
    """A fused dispatch unit, as the JAX package counts its ``forge.<name>``
    nodes."""
    return op.startswith(FUSED_UNIT_PREFIXES)


def graph_features(g: Graph) -> Dict[str, Any]:
    nodes = list(g.nodes.values())
    n_ops = len(nodes)
    weights = [v for v in g.invars if len(v.shape) >= 2]
    n_linear = sum(1 for n in nodes if _is_linear_class(n.op))
    return {
        "n_ops": n_ops,
        "n_weights": len(weights),
        "linear_frac": (n_linear / n_ops) if n_ops else 0.0,
        "depth": g.depth(),
        "params_m": sum(math.prod(v.shape) for v in weights) / 1e6,
        "n_fused": sum(1 for n in nodes if is_fused_unit(n.op)),
        "n_attn_fused": sum(1 for n in nodes if n.op == "forge.sdpa"),
    }


def score_graph(g: Graph, precision: Optional[str] = None) -> CostBreakdown:
    f = graph_features(g)
    base = (
        W_OPS * f["n_ops"]
        + W_WEIGHTS * f["n_weights"]
        + W_LINEAR * f["linear_frac"] * f["n_ops"]
        + W_DEPTH * f["depth"]
        + W_PARAMS * f["params_m"]
    )
    bonus = 1.0
    if f["n_attn_fused"] > 0:
        bonus *= BONUS_ATTENTION
    if f["n_fused"] - f["n_attn_fused"] > 0:
        bonus *= BONUS_OPERATOR
    score = max(base, 1e-6) * bonus * PRECISION_FACTOR.get(precision, 1.0)
    return CostBreakdown(score=score, **f)


# --------------------------------------------------------------------------
# Beyond-paper: roofline-informed cost estimate (NVIDIA H100 SXM peaks)
# --------------------------------------------------------------------------

#: dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet), FLOP/s
H100_PEAK_FLOPS_BF16 = 989e12
#: HBM3 rate of an H100 SXM (NVIDIA data sheet), B/s
H100_HBM_BYTES_PER_S = 3.35e12
DISPATCH_OVERHEAD_S = 2e-6  # per unfused kernel boundary (est.)


def roofline_score(g: Graph, precision: Optional[str] = "bf16") -> float:
    """Estimated H100 seconds of one call: max(compute, memory) + dispatch.

    Counts FLOPs per node and bytes at every kernel boundary (each
    unfused op writes + re-reads its output); fused nodes keep their
    intermediates on chip, so only their true inputs/outputs reach HBM.
    """
    itemsize = 2 if precision in ("bf16", "mixed") else 4
    flops = bytes_ = 0.0
    n_dispatch = 0
    for node in g.nodes.values():
        flops += node_flops(node)
        n_dispatch += 1
        for v in list(node.outvars) + list(node.invars):
            bytes_ += math.prod(v.shape) * itemsize
    return (max(flops / H100_PEAK_FLOPS_BF16, bytes_ / H100_HBM_BYTES_PER_S)
            + n_dispatch * DISPATCH_OVERHEAD_S)
