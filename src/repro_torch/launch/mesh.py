"""Device meshes over ``torch.distributed``: a port of the JAX package's
``launch/mesh.py``.

Every function here is a FUNCTION (no module-level mesh), so importing
this module touches no process-group state.  A ``DeviceMesh`` needs a
process group of its size: the production meshes (16 x 16 = 256 ranks,
2 x 16 x 16 = 512) exist in one process only over the ``fake`` backend
(:func:`fake_world`), which runs every collective as a no-op; the dry
run (``launch/dryrun.py``) builds them there.  ``make_host_mesh`` spans
the live group (NCCL on the card, gloo on the CPU).

Topology: 256 devices as a (16, 16) (data, model) mesh; multi-pod adds a
leading ``pod`` axis (2 pods = 512 devices here; the ``pod`` axis is
data-parallel by default and is the natural pipeline axis of
``distrib/pipeline``).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the live process group,
    whose world size must be the mesh's size (a ``fake`` group for a
    mesh larger than the machine)."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} ranks (live group: "
                           f"{have}); in one process use launch.mesh.fake_world({n})")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(model: Optional[int] = None, device_type: str = "cuda") -> DeviceMesh:
    """A ``(world // model, model)`` (data, model) mesh over the live
    group, on ``device_type`` (the card by default; ``"cpu"`` for a gloo
    group)."""
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world of {n}")
    return make_mesh((n // model, model), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0) -> Iterator[None]:
    """A ``fake`` process group of ``world_size`` ranks in this process,
    destroyed on exit: meshes of any size with no device behind them, for
    plans and dry runs.  Refuses to replace a live group.  On exit
    DTensor's sharding caches are emptied too, the Python one and, where
    this torch has it, the C++ dispatch fast path's: a later mesh of the
    same shape compares equal to this one's, and a cached decision would
    lead it to this group's destroyed subgroups (the second cell of a
    dry-run sweep in one process)."""
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already live in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
        clear_native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
        if clear_native is not None:
            clear_native()
        dist.destroy_process_group()
