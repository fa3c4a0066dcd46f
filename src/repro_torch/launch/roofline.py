"""Roofline terms of a dry-run cell: a port of the JAX package's
``launch/roofline.py``, with NVIDIA H100 constants.

Three terms per (arch × shape × mesh), in seconds:

    compute    = FLOPs_per_device      / 989 TFLOP/s bf16
    memory     = bytes_per_device      / 3.35 TB/s HBM
    collective = collective_B_per_dev  / 450 GB/s NVLink

The reference reads FLOPs and bytes from XLA's cost analysis and parses
collectives out of the optimized HLO.  The port counts them from the
ops one step runs on each device's local shards
(``launch/dryrun.StepCounter``): FLOPs by ``torch.utils.flop_counter``'s
formulas (and the kernel ops' own, registered there), bytes as every
op's inputs read once and outputs written once, and the functional
collectives DTensor issues: :func:`collective_bytes` sums each kind's
output bytes, weighting all-reduce ×2 (ring send+recv), the reference's
per-device wire-traffic model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM5 data sheet figures, for NVIDIA H100 80GB HBM3 at 700 W
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor core
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 450e9  # B/s per direction per GPU, NVLink 4 (900 GB/s both ways)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: wire-bytes weight per collective kind (ring model, per device)
_WEIGHT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(records: Iterable[Tuple[str, Tuple[int, ...], int]]) -> Dict[str, float]:
    """Per-kind output bytes of every collective of a step: ``records``
    are ``(kind, output shape, output bytes)``, one per collective op
    (``StepCounter.collectives``).  ``_counts`` holds the count of each."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    counts: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, _, nbytes in records:
        out[kind] += nbytes
        counts[kind] += 1
    out["_counts"] = counts  # type: ignore[assignment]
    return out


def weighted_bytes(coll: Dict[str, float]) -> float:
    """The wire bytes of :func:`collective_bytes`'s totals (``_WEIGHT``)."""
    return sum(_WEIGHT[k] * coll.get(k, 0.0) for k in _COLLECTIVES)


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per device (the name is the reference's)
    hlo_bytes: float  # per device
    coll_bytes: float  # weighted wire bytes (whole step, per device)
    coll_detail: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0  # 6·N·D (dense) / 6·N_active·D (MoE), per device
    bytes_per_device: float = 0.0  # peak memory

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste detector."""
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """max-term / sum-of-terms (1.0 = one roof is the whole step)."""
        t = [self.t_compute, self.t_memory, self.t_collective]
        s = max(sum(t), 1e-30)
        return max(t) / s

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes, "coll_detail": self.coll_detail,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops_for(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """6·N·D with N = (active) params, D = tokens processed this step.

    train: fwd+bwd = 6·N·D.  prefill: 2·N·D.  decode: 2·N·B (one token)."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * seq * batch
    if shape_kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch  # decode: one new token per sequence
