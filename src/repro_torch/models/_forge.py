"""Forge-pipeline integration glue shared by every model family.

``forge_body(raw_fn, key, example_args)`` captures the block body through
the full four-phase compiler ONCE per (model config, mode, pipeline
configuration, input structure, shapes, dtypes, devices) and returns the
compiled module's callable; families call it when ``cfg.fuse == 'forge'``.
``torch.export`` specialises on shapes, so a new shape is a new compile,
and two pipeline configurations never share a body.

Bodies compile through the process-global compile cache
(``core/cache.py``): identical layers share one Phase-4 build, and with
a disk store attached (``BatchedServer(cache_dir=...)``) a restarted
process replays them from disk.  Compile-service workers compile steps
whose bodies compile at their first call, so a miss compiles under the
compiler's process-wide build lock (``core.compiler.BUILD_LOCK``),
which also guards ``_CACHE``; a hit is one dictionary read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

_CACHE: Dict[str, Any] = {}  # key -> CompiledModule


def _shape_key(tree) -> str:
    flat, spec = pytree.tree_flatten(tree)
    leaves = tuple(
        (tuple(a.shape), str(a.dtype), str(a.device)) if isinstance(a, torch.Tensor)
        else repr(a)
        for a in flat
    )
    return f"{spec}|{leaves}"


def forge_body(
    raw_fn: Callable,
    key_prefix: str,
    example_args: Tuple[Any, ...],
    *,
    enabled: bool = True,
    impl: Optional[str] = None,
    config: Optional[Any] = None,
) -> Callable:
    """Return the Forge-compiled body (or ``raw_fn`` when disabled).

    ``config`` is the :class:`~repro_torch.core.passes.PipelineConfig`
    (default: the paper's pipeline); ``impl``, when given, replaces its
    ``impl``, which is forwarded into the fused nodes: None dispatches by
    device (kernels on the card), ``"ref"`` runs their plain versions.
    """
    if not enabled:
        return raw_fn
    from ..core import ForgeCompiler, PipelineConfig
    from ..core.compiler import BUILD_LOCK

    config = config or PipelineConfig()
    if impl is not None:
        config = dataclasses.replace(config, impl=impl)
    key = f"{key_prefix}/{config!r}/{_shape_key(example_args)}"
    hit = _CACHE.get(key)
    if hit is None:
        with BUILD_LOCK:
            hit = _CACHE.get(key)
            if hit is None:
                hit = ForgeCompiler(config).compile(raw_fn, *example_args)
                _CACHE[key] = hit
    return hit.as_fn()


def compiled_bodies() -> List[Any]:
    """The CompilationResult of every body compiled so far (transparency)."""
    return [mod.result for mod in list(_CACHE.values())]


def clear_cache() -> None:
    from ..core.compiler import BUILD_LOCK

    with BUILD_LOCK:
        _CACHE.clear()
