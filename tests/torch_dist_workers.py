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
    return spawn_all([(fn, world, tmp_path) + tuple(args)], timeout)[0]


def spawn_all(jobs, timeout: float = 120.0, meanwhile=None):
    """:func:`spawn` of several ``(fn, world, tmp_path, *args)`` jobs at
    once, calling ``meanwhile()`` (if given) while they run; returns their
    output directories."""
    started = []
    for fn, world, tmp_path, *args in jobs:
        out = str(tmp_path)
        os.makedirs(out, exist_ok=True)
        init = os.path.join(out, "init")
        started.append((fn, out, mp.start_processes(
            fn, args=(world, init, out) + tuple(args), nprocs=world, start_method="spawn",
            join=False)))
    deadline = time.monotonic() + timeout
    try:
        if meanwhile is not None:
            meanwhile()
        for fn, _, ctx in started:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{fn.__name__} ranks still running after {timeout} s")
    finally:
        for _, _, ctx in started:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
    return [out for _, out, _ in started]


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


def tp_rank(rank, world, init, out, runs, batch_file):
    """For each ``(shape, cases)`` of ``runs``, a (data, model) mesh of
    this world's size and ``(arch, params file)`` pairs: the f32
    smoke config's ``apply`` logits, loss and gradients on params and
    batch placed by ``plan_for``; rank 0 writes their full values, the
    local shapes the fused-linear and flash ops ran at, the plan's
    attention layout and fallbacks."""
    from repro_torch.configs import get_config
    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    _init(rank, world, init)
    try:
        batch = torch.load(batch_file)
        results = {}
        for shape, cases in runs:
            mesh = make_mesh(tuple(shape), ("data", "model"))
            for arch, params_file in cases:
                cfg = get_config(arch, smoke=True).with_(dtype="float32")
                params = torch.load(params_file)
                plan = plan_for(cfg, mesh)
                layout = plan.attention_layout()
                dparams = distribute_tree(params, plan.params_shardings(params))
                dbatch = distribute_tree(batch, plan.batch_shardings(batch))
                with replicate_plain(), _local_kernel_shapes() as seen:
                    with torch.no_grad():
                        logits = full(get_model(cfg).apply(dparams, dbatch["tokens"], cfg))
                    loss, grads = steps.loss_and_grads(steps.make_loss_fn(cfg), dparams, dbatch)
                    loss, grads = full(loss), pytree.tree_map(full, grads)
                results[(arch, tuple(shape))] = {
                    "logits": logits, "loss": loss, "grads": grads, "kernel_shapes": seen.seen,
                    "layout": layout, "fallbacks": list(plan.fallbacks)}
        if rank == 0:
            torch.save(results, os.path.join(out, "tp.pt"))
    finally:
        dist.destroy_process_group()


class _local_kernel_shapes:
    """Records the local shapes the fused-linear and flash ops run at
    (below DTensor), by wrapping their implementations' entry points."""

    def __init__(self):
        self.seen = []
        self._saved = []

    def __enter__(self):
        from repro_torch.kernels import flash_attention, fused_linear

        for mod, name in ((fused_linear, "fused_linear"), (flash_attention, "flash_attention")):
            inner = mod._forward

            def record(*args, _inner=inner, _name=name):
                self.seen.append((_name, tuple(tuple(a.shape) for a in args
                                               if isinstance(a, torch.Tensor))))
                return _inner(*args)

            self._saved.append((mod, inner))
            mod._forward = record
        return self

    def __exit__(self, *exc):
        for mod, inner in self._saved:
            mod._forward = inner


def dry_count_rank(rank, world, init, out, arch, shape_name):
    """The dry run's counts of ``arch``'s smoke ``shape_name`` cell on
    ``fake`` meshes (no gloo group): (2, 1) at 1 layer, (2, 4) at 1 and
    2 layers; written as ``{(shape, layers): {flops, flops_by_op}}``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh

    cfg = get_config(arch, smoke=True)
    counts = {}
    for shape, layers in (((2, 1), (1,)), ((2, 4), (1, 2))):
        with fake_world(shape[0] * shape[1]):
            mesh = make_mesh(shape, ("data", "model"))
            for n in layers:
                r = dryrun._run(dryrun._with_layers(cfg, n), shape_name, mesh, fsdp=False,
                                seq_shard_cache=True)
                counts[shape, n] = {"flops": r["flops"], "flops_by_op": r["flops_by_op"]}
    torch.save(counts, os.path.join(out, "counts.pt"))


def slstm_grad_rank(rank, world, init, out, shapes, params_file, data_file):
    """For each (data, model) mesh shape of ``shapes``: xlstm-350m's f32
    smoke sLSTM block (layer 2) on params and input placed by
    ``plan_for``, the gradients of ``sum(out * cot)`` with respect to the
    block's params and its input; rank 0 writes their full values and the
    local shapes the loop's backward op ran at."""
    from repro_torch.configs import get_config
    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import xlstm
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    _init(rank, world, init)
    seen = []
    inner = ops._scan_vjp

    def record(fn, inputs, diff, grads):
        seen.append(tuple(tuple(t.shape) for t in inputs if isinstance(t, torch.Tensor)))
        return inner(fn, inputs, diff, grads)

    ops._scan_vjp = record
    try:
        cfg = get_config("xlstm-350m", smoke=True).with_(dtype="float32")
        params, data = torch.load(params_file), torch.load(data_file)
        results = {}
        for shape in shapes:
            mesh = make_mesh(tuple(shape), ("data", "model"))
            plan = plan_for(cfg, mesh)
            p = distribute_tree(params, plan.params_shardings(params))["blocks"][2]
            x, cot = (distribute_tree(data[k], plan.batch_shardings(data[k])) for k in ("x", "cot"))
            leaves, spec = pytree.tree_flatten(p)
            leaves = [t.detach().requires_grad_(True) for t in leaves]
            x = x.detach().requires_grad_(True)
            del seen[:]
            with replicate_plain():
                y = xlstm.slstm_block_apply(pytree.tree_unflatten(leaves, spec), x, cfg)
                grads = torch.autograd.grad((y * cot).sum(), leaves + [x])
                grads = [g.full_tensor() if isinstance(g, DTensor) else g for g in grads]
            results[tuple(shape)] = {"params": pytree.tree_unflatten(grads[:-1], spec),
                                     "x": grads[-1], "backward_shapes": list(seen),
                                     "fallbacks": list(plan.fallbacks)}
        if rank == 0:
            torch.save(results, os.path.join(out, "slstm.pt"))
    finally:
        ops._scan_vjp = inner
        dist.destroy_process_group()


def xlstm_decode_rank(rank, world, init, out, params_file, tokens_file, steps):
    """xlstm-350m's f32 smoke greedy decode on a (1, world) mesh: params
    and cache placed by ``plan_for`` (the mLSTM memory ``C`` sharded on
    ``dv`` over ``model``), ``steps`` serve steps from the first tokens;
    rank 0 writes every step's tokens and logits (full values) and the
    placements of layer 0's ``C``."""
    from repro_torch.configs import get_config
    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import xlstm

    _init(rank, world, init)
    try:
        cfg = get_config("xlstm-350m", smoke=True).with_(dtype="float32")
        params, token = torch.load(params_file), torch.load(tokens_file)
        mesh = make_mesh((1, world), ("data", "model"))
        plan = plan_for(cfg, mesh)
        dparams = distribute_tree(params, plan.params_shardings(params))
        cache = xlstm.init_cache(cfg, token.shape[0], device="cpu")
        cache = distribute_tree(cache, plan.cache_shardings(cache))
        placed = str(cache["layers"][0]["cell"]["C"].placements)
        step = make_serve_step(cfg, logits=True)
        tokens, logits = [], []
        with torch.no_grad(), replicate_plain():
            for t in range(steps):
                tok = distribute_tree(token, plan.batch_shardings(token))
                pos = distribute_tree(torch.tensor(t), plan.scalar_sharding())
                nxt, cache, last = step(dparams, cache, tok, pos)
                token = nxt.full_tensor().long()
                tokens.append(token)
                logits.append(last.full_tensor())
        if rank == 0:
            torch.save({"tokens": tokens, "logits": logits, "C_placements": placed,
                        "fallbacks": list(plan.fallbacks)}, os.path.join(out, "decode.pt"))
    finally:
        dist.destroy_process_group()


def ep_rank(rank, world, init, out, runs, batch_file, ffn_file):
    """For each ``(shape, cases)`` of ``runs``, a (data, model) mesh of
    this world's size and ``(arch, params file, capacity factor)``
    triples: the f32 smoke config (that capacity factor) on params and
    batch placed by ``plan_for``: the planned ``apply`` logits, the loss
    and every gradient; layer 0's ``moe_ffn`` on the input of
    ``ffn_file`` (its routing through ``moe.ep_route``, its output and the
    gradients of ``sum(out * cot)``); the local shapes of every
    ``aten.bmm`` the loss and its gradients ran (below DTensor); the
    plan's fallbacks.  Rank 0 writes their full values."""
    from repro_torch.configs import get_config
    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.models import moe as M
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    _init(rank, world, init)
    try:
        batch, ffn = torch.load(batch_file), torch.load(ffn_file)
        results = {}
        for shape, cases in runs:
            mesh = make_mesh(tuple(shape), ("data", "model"))
            for arch, params_file, cf in cases:
                cfg = get_config(arch, smoke=True).with_(dtype="float32", capacity_factor=cf)
                params = torch.load(params_file)
                plan = plan_for(cfg, mesh)
                dparams = distribute_tree(params, plan.params_shardings(params))
                dbatch = distribute_tree(batch, plan.batch_shardings(batch))
                kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=cf)
                with replicate_plain():
                    with torch.no_grad():
                        logits = full(get_model(cfg).apply(dparams, dbatch["tokens"], cfg))
                    with _local_bmm_shapes() as seen:
                        loss, grads = steps.loss_and_grads(steps.make_loss_fn(cfg), dparams,
                                                           dbatch)
                    loss, grads = full(loss), pytree.tree_map(full, grads)
                    mp = dparams["blocks"][0]["moe"]
                    x, cot = (distribute_tree(ffn[k], plan.batch_shardings(ffn[k]))
                              for k in ("x", "cot"))
                    top_idx, _, pos, keep, _ = M.ep_route(x, mp, **kw)
                    leaves, spec = pytree.tree_flatten(mp)
                    leaves = [t.detach().requires_grad_(True) for t in leaves]
                    x = x.detach().requires_grad_(True)
                    y = M.moe_ffn(x, pytree.tree_unflatten(leaves, spec), **kw)
                    ffn_grads = torch.autograd.grad((y * cot).sum(), leaves + [x])
                    ffn_out = {"top_idx": full(top_idx), "pos": full(pos), "keep": full(keep),
                               "y": full(y), "grads": [full(g) for g in ffn_grads]}
                results[(arch, tuple(shape), cf)] = {
                    "logits": logits, "loss": loss, "grads": grads, "bmm_shapes": seen.seen,
                    "ffn": ffn_out, "fallbacks": list(plan.fallbacks)}
        if rank == 0:
            torch.save(results, os.path.join(out, "ep.pt"))
    finally:
        dist.destroy_process_group()


class _local_bmm_shapes:
    """Records the local shapes of the ``aten.bmm`` calls made inside it
    on real tensors (below DTensor), as a dispatch mode."""

    def __enter__(self):
        from torch._subclasses.fake_tensor import is_fake
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                # DTensor's sharding propagation runs ops on fake tensors of
                # the global shapes: not a device's work
                if func is torch.ops.aten.bmm.default and not is_fake(args[0]):
                    seen.append((tuple(args[0].shape), tuple(args[1].shape)))
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def ep_count_rank(rank, world, init, out, cells, shapes):
    """The dry run's counts of each ``(arch, shape name)`` smoke cell of
    ``cells`` at 1 layer, FSDP off, on ``fake`` (data, model) meshes of
    each of ``shapes`` (no gloo group): ``{(arch, shape name, mesh):
    {flops_by_op, peak_bytes}}``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh

    counts = {}
    for arch, shape_name in cells:
        cfg = dryrun._with_layers(get_config(arch, smoke=True), 1)
        for shape in shapes:
            with fake_world(shape[0] * shape[1]):
                mesh = make_mesh(tuple(shape), ("data", "model"))
                r = dryrun._run(cfg, shape_name, mesh, fsdp=False, seq_shard_cache=True)
            counts[arch, shape_name, tuple(shape)] = {"flops_by_op": r["flops_by_op"],
                                                      "peak_bytes": r["peak_bytes"]}
    torch.save(counts, os.path.join(out, "counts.pt"))


def train_cli_rank(rank, world, init, out, port, argv, params_file):
    """The port's train CLI (``launch.train.main``) on this rank, its
    process group opened by ``main`` itself from the environment
    ``torchrun`` would set; writes the run: the step's type, the
    supervisor's report, the checkpoints on disk, this rank's checkpoint
    timings and the ``[train]`` lines it printed."""
    import contextlib
    import io

    from repro_torch.launch import train

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    run, printed = {}, io.StringIO()
    with contextlib.redirect_stdout(printed):
        code = train.main(argv, params=torch.load(params_file), out=run)
    rep = run["report"]
    torch.save({"code": code, "step_type": type(run["step"]).__name__,
                "history": rep.history, "failures": rep.failures, "restores": rep.restores,
                "all_steps": run["ckpt"].all_steps(), "timings": run["ckpt"].timings,
                "opt_step": int(run["state"][1].step), "group_closed": not dist.is_initialized(),
                "printed": printed.getvalue()},
               os.path.join(out, f"r{rank}.pt"))
