"""Forge-pipeline integration glue shared by every model family.

``forge_body(raw_fn, key, example_args)`` captures the block body through
the full four-phase compiler ONCE per (model config, mode, pipeline
configuration, input structure, shapes, dtypes, devices) and returns the
compiled module's callable; families call it when ``cfg.fuse == 'forge'``.
``torch.export`` specialises on shapes, so a new shape is a new compile,
and two pipeline configurations never share a body.

Under ``torch.compile`` (``BatchedServer(mode="jit")`` compiles the
whole serve step) Dynamo traces the lookup and the compiled body's
executor: the body an earlier eager call compiled for these shapes is
found again, and its RGIR ops (the fused kernels' custom ops among them)
become nodes of the step's one graph, as ``jax.jit`` traces the
reference's bodies into the jitted step.  A dataclass ``repr`` is not
traceable, so the config parts of the key are strings taken once per
config object (:func:`config_key`) and per ``impl``.

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
import torch.utils.checkpoint
from torch.utils import _pytree as pytree

_CACHE: Dict[str, Any] = {}  # key -> CompiledModule
#: id(config) -> (config, repr(config)): the config is kept so its id
#: stays its own
_CONFIG_KEYS: Dict[int, Tuple[Any, str]] = {}
#: impl -> repr of the default pipeline with that impl
_PIPELINE_KEYS: Dict[Optional[str], str] = {}


def config_key(cfg: Any) -> str:
    """``repr(cfg)``, taken once per config object (a dictionary read
    under Dynamo, which cannot trace a dataclass ``repr``)."""
    hit = _CONFIG_KEYS.get(id(cfg))
    if hit is None or hit[0] is not cfg:
        hit = _CONFIG_KEYS[id(cfg)] = (cfg, repr(cfg))
    return hit[1]


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
    remat: bool = False,
) -> Callable:
    """Return the Forge-compiled body (or ``raw_fn`` when disabled),
    rematerialised in backward when ``remat`` (:func:`rematerialized`).

    ``config`` is the :class:`~repro_torch.core.passes.PipelineConfig`
    (default: the paper's pipeline); ``impl``, when given, replaces its
    ``impl``, which is forwarded into the fused nodes: None dispatches by
    device (kernels on the card), ``"ref"`` runs their plain versions.
    """
    body = _compiled(raw_fn, key_prefix, example_args, impl, config) if enabled else raw_fn
    return rematerialized(body) if remat else body


def rematerialized(body: Callable) -> Callable:
    """``body`` under ``torch.utils.checkpoint`` (``use_reentrant=False``),
    as ``jax.checkpoint`` wraps the reference's bodies: a call that
    builds a graph for backward keeps only the body's inputs, and
    backward runs the body again (the same compiled module: no second
    compile) before differentiating it.  A call that builds no graph
    (grad mode off, as on every serve path, or no input requiring a
    gradient, as in a capture) is the body's own call: remat changes
    nothing there."""

    def remat_body(*args):
        if torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in pytree.tree_leaves(args)):
            return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
        return body(*args)

    return remat_body


def _compiled(raw_fn: Callable, key_prefix: str, example_args: Tuple[Any, ...],
              impl: Optional[str], config: Optional[Any]) -> Callable:
    if config is None:
        pipe_key = _PIPELINE_KEYS.get(impl)
        if pipe_key is None:
            pipe_key = _PIPELINE_KEYS[impl] = repr(_pipeline(None, impl))
    else:
        pipe_key = repr(_pipeline(config, impl))
    key = f"{key_prefix}/{pipe_key}/{_shape_key(example_args)}"
    hit = _CACHE.get(key)
    if hit is None:
        if torch.compiler.is_dynamo_compiling():
            raise RuntimeError(f"forge body {key_prefix!r} at these shapes was never "
                               f"compiled: run the step once before torch.compile traces it")
        from ..core import ForgeCompiler
        from ..core.compiler import BUILD_LOCK

        with BUILD_LOCK:
            hit = _CACHE.get(key)
            if hit is None:
                hit = ForgeCompiler(_pipeline(config, impl)).compile(raw_fn, *example_args)
                _CACHE[key] = hit
    return hit.as_fn()


def _pipeline(config: Optional[Any], impl: Optional[str]) -> Any:
    """``config`` (default: the paper's pipeline) with ``impl`` set."""
    from ..core import PipelineConfig

    config = config or PipelineConfig()
    return dataclasses.replace(config, impl=impl) if impl is not None else config


def compiled_bodies() -> List[Any]:
    """The CompilationResult of every body compiled so far (transparency)."""
    return [mod.result for mod in list(_CACHE.values())]


def clear_cache() -> None:
    from ..core.compiler import BUILD_LOCK

    with BUILD_LOCK:
        _CACHE.clear()
