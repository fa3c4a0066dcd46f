"""Forge-pipeline integration glue shared by every model family.

``forge_body(raw_fn, key, example_args)`` captures the block body through
the full four-phase compiler ONCE per (model config, mode, pipeline
configuration, input structure, shapes, dtypes, devices) and returns the
compiled module's callable; families call it when ``cfg.fuse == 'forge'``.
``torch.export`` specialises on shapes, so a new shape is a new compile,
and two pipeline configurations never share a body.  Nor do bodies
captured under different activation-sharding policies
(``distrib/actsharding.py``).  DTensor arguments (a call placed by a
sharding plan, ``distrib/sharding.py``) key as their global shapes and
their placements; the body is captured on fake DTensors of those
placements, at the global level (its graph is the unplanned call's), and
its ATen ops run on the DTensors.  Its parameters come FSDP-gathered and
its other arguments with their pending reductions done
(``actsharding.fsdp_gathered`` / ``settled``).

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

from ..distrib.actsharding import fsdp_gathered, settled

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
        (tuple(a.shape), str(a.dtype), str(a.device))
        + ((tuple(a.device_mesh.shape), str(a.placements)) if hasattr(a, "placements") else ())
        if isinstance(a, torch.Tensor) else repr(a)
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
    planned = _planned(example_args)
    if planned:
        example_args = _planned_args(example_args)
    body = _compiled(raw_fn, key_prefix, example_args, impl, config) if enabled else raw_fn
    if planned:
        body = _settling(body)
    return rematerialized(body) if remat else body


def _planned(args) -> bool:
    """Whether ``args`` hold a DTensor (a call placed by a sharding plan)."""
    leaves = [t for t in pytree.tree_leaves(args)
              if isinstance(t, torch.Tensor) and type(t) is not torch.Tensor]
    if not leaves:
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in leaves)


def _planned_args(args):
    """A planned call's arguments as its body takes them: the layer's
    parameters (the first argument) FSDP-gathered, the others with their
    pending reductions done (``distrib/actsharding.py``)."""
    return (fsdp_gathered(args[0]),) + tuple(settled(tuple(args[1:])))


def _settling(body: Callable) -> Callable:
    """``body`` taking its DTensor arguments as :func:`_planned_args`
    gives them."""

    def planned_body(*args):
        return body(*_planned_args(args))

    return planned_body


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
    key = f"{key_prefix}/{pipe_key}/{_shape_key(example_args)}|{_policy_key()}"
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
                hit = ForgeCompiler(_pipeline(config, impl)).compile(
                    raw_fn, *_capture_args(example_args))
                _CACHE[key] = hit
    return hit.as_fn()


def _capture_args(args):
    """What a body is captured on: ``args`` themselves, but DTensors,
    which become fake DTensors of the same placements (``torch.export``
    of real sharded DTensors fails on their local shapes; of fake ones it
    traces the global-level graph)."""
    if not _planned(args):
        return args
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    def fake(t):
        if isinstance(t, DTensor):
            local = t.to_local()
            return DTensor.from_local(
                torch.empty_strided(local.shape, local.stride(), dtype=local.dtype,
                                    device=local.device),
                t.device_mesh, t.placements, run_check=False, shape=t.shape, stride=t.stride())
        if isinstance(t, torch.Tensor):
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
        return t

    with detect_fake_mode(pytree.tree_leaves(args)) or FakeTensorMode(allow_non_fake_inputs=True):
        return pytree.tree_map(fake, args)


def _policy_key() -> str:
    """The active activation-sharding policy's part of a body's key: a
    body captured under a policy holds its ``constrain`` nodes, one
    captured without holds none (as the JAX package keys its bodies)."""
    from ..distrib import actsharding

    pol = actsharding.current()
    return "nopolicy" if pol is None else pol.key()


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
