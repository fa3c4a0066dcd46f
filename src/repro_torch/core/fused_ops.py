"""Dispatch table for fused ``forge.*`` graph nodes (``forge.sdpa``,
``forge.linear_act``, ``forge.swiglu``).

Phase-2 fusion passes replace matched ATen chains with single
``forge.*`` nodes; Phase-3 lowering resolves each to a concrete callable
(the paper's "pre-resolved callable" in the NPUIR instruction).  All fused
callables bottom out in :mod:`repro_torch.kernels.ops`, which launches the
hand-written CUDA kernel for a CUDA tensor and the plain PyTorch version
for a CPU tensor (or for ``impl="ref"``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .graph import GNode


def _dtype(name):
    return getattr(torch, name) if name is not None else None


def _sdpa_callable(node: GNode) -> Callable:
    from ..kernels import ops

    p = node.params
    out_dtype = _dtype(p.get("out_dtype"))

    def fn(*args):
        q, k, v = args[0], args[1], args[2]
        mask = args[3] if len(args) > 3 else None
        if mask is not None and p.get("mask_mode") == "bool":
            # boolean keep-mask -> additive float mask
            mask = torch.where(mask, 0.0, torch.finfo(torch.float32).min)
        return ops.sdpa(
            q, k, v, mask,
            scale=p.get("scale"),
            scale_mode=p.get("scale_mode", "mul"),
            causal=p.get("causal", False),
            groups=p.get("groups", 1),
            impl=p.get("impl"),
            out_dtype=out_dtype,
        )

    return fn


def _linear_act_callable(node: GNode) -> Callable:
    """The fused linear, its residual added after it.  In a planned call
    a row-parallel product is a pending sum, reduced before the residual
    (``settled``; plain tensors pass as they are), as Megatron
    all-reduces after a row-parallel layer: the residual stream and the
    norms after it stay whole."""
    from ..distrib.actsharding import settled
    from ..kernels import ops

    p = node.params
    has_bias = p.get("has_bias", False)
    has_residual = p.get("has_residual", False)
    out_dtype = _dtype(p.get("out_dtype"))

    def fn(*args):
        x, w = args[0], args[1]
        i = 2
        b = r = None
        if has_bias:
            b = args[i]
            i += 1
        if has_residual:
            r = args[i]
        out = settled(ops.fused_linear(x, w, b, act=p.get("act"), impl=p.get("impl")))
        if r is not None:
            out = out + r
        return out.to(out_dtype) if out_dtype is not None else out

    return fn


def _swiglu_callable(node: GNode) -> Callable:
    from ..kernels import ops

    p = node.params
    out_dtype = _dtype(p.get("out_dtype"))

    def fn(x, w_gate, w_up):
        out = ops.swiglu(x, w_gate, w_up, impl=p.get("impl"))
        return out.to(out_dtype) if out_dtype is not None else out

    return fn


_BUILDERS: Dict[str, Callable[[GNode], Callable]] = {
    "forge.sdpa": _sdpa_callable,
    "forge.linear_act": _linear_act_callable,
    "forge.swiglu": _swiglu_callable,
}


def fused_callable(node: GNode) -> Callable:
    """Resolve a ``forge.*`` node to its dispatch callable."""
    builder = _BUILDERS.get(node.op)
    if builder is None:
        raise KeyError(f"no fused callable registered for {node.op!r}")
    return builder(node)
