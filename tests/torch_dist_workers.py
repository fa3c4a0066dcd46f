"""Rank bodies for the port's multi-process tests (``test_torch_*.py``):
each runs in a process spawned by :func:`spawn`, joins a gloo group
through a ``file://`` store and writes its result with ``torch.save``.
The module imports no JAX, so the children start quickly."""
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, world: int, tmp_path, *args, timeout: float = 120.0):
    """Run ``fn(rank, world, init_file, out_dir, *args)`` on ``world``
    spawned ranks; fail if they do not all end within ``timeout``
    seconds.  Returns ``out_dir``."""
    out = str(tmp_path)
    os.makedirs(out, exist_ok=True)
    init = os.path.join(out, "init")
    ctx = mp.start_processes(fn, args=(world, init, out) + tuple(args), nprocs=world,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{fn.__name__} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return out


def _init(rank, world, init):
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)


def compress_rank(rank, world, init, out):
    """``compressed_all_reduce`` of a rank-seeded vector (1000 elements:
    four blocks, the last padded)."""
    from repro_torch.runtime import compressed_all_reduce

    _init(rank, world, init)
    try:
        x = torch.from_numpy(np.random.default_rng(rank).standard_normal(1000).astype(np.float32))
        torch.save(compressed_all_reduce(x), os.path.join(out, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gpipe_rank(rank, world, init, out, stages, x):
    """``gpipe_apply`` of a tanh MLP stack, stage ``rank`` on this rank."""
    from repro_torch.distrib.pipeline import gpipe_apply

    _init(rank, world, init)
    try:
        torch.save(gpipe_apply(stages, x, mlp_stage), os.path.join(out, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mlp_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def train_rank(rank, world, init, out, arch, params_file, batch_file):
    """One train step of ``arch``'s f32 smoke config on params and batch
    placed by ``plan_for`` over a ``(world, 1)`` host mesh (the batch
    sharded over ``data``); rank 0 writes the loss and the new params'
    full values."""
    from repro_torch.configs import get_config
    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import default_optimizer, make_train_step
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    _init(rank, world, init)
    try:
        cfg = get_config(arch, smoke=True).with_(dtype="float32")
        params = torch.load(params_file)
        batch = torch.load(batch_file)
        mesh = make_host_mesh(device_type="cpu")
        plan = plan_for(cfg, mesh)
        opt = default_optimizer(cfg)
        state = opt.init(params)
        dparams = distribute_tree(params, plan.params_shardings(params))
        dstate = distribute_tree(state, plan.opt_state_shardings(state, params))
        dbatch = distribute_tree(batch, plan.batch_shardings(batch))
        with replicate_plain():
            new_params, _, metrics = make_train_step(cfg, opt)(dparams, dstate, dbatch)
            loss = metrics["loss"].full_tensor()
            full = pytree.tree_map(
                lambda t: t.full_tensor() if isinstance(t, DTensor) else t, new_params)
            placed = str(dbatch["tokens"].placements)
        if rank == 0:
            torch.save({"loss": loss, "params": full, "batch_placements": placed},
                       os.path.join(out, "step.pt"))
    finally:
        dist.destroy_process_group()
