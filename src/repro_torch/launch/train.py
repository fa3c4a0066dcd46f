"""End-to-end training entry point with fault tolerance: a port of the JAX
package's ``launch/train.py``.

Drives the train step with:

* deterministic resumable data (``TokenDataset``),
* async checkpointing (atomic step directories, keep-last-k),
* the Supervisor's checkpoint/restart loop (``--simulate-fault`` injects
  a failure to show the recovery),
* ``--compress-grads``, parsed and read by nothing, as in the reference.

The step is :class:`JitTrainStep`, the counterpart of the reference's
``jax.jit(step, donate_argnums=(0, 1))``: the loss compiled with its
backward, the clipping and the optimizer update compiled beside it, on
the card one CUDA graph a step; it owns the parameters and the optimizer
state and writes each step's values into them in place.  With more than
one rank in a live process group the step stays the eager
``make_train_step`` (a planned step is DTensor under ``torch.compile``,
not ported yet).  The step runs on CUDA unless ``--device cpu`` is
given.

Usage (training a ~100M model; ``--smoke --device cpu`` on a CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch forge-125m \\
      --steps 200 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..data import DataConfig, TokenDataset
from ..device import resolve_device
from ..distrib.sharding import plan_for
from ..models import get_model
from ..optim import AdamW
from ..optim.adamw import AdamWState, leaves_like
from ..runtime import SimulatedFault, Supervisor
from .mesh import make_host_mesh
from .steps import (checked_optimizer, dealias_tree, default_optimizer, make_loss_fn,
                    make_train_step)

#: the kernel custom ops: a node of one launches its kernel once a run
KERNEL_OPS = ("fused_linear", "flash_attention", "paged_attention", "rg_lru", "rg_lru_chunked",
              "rms_norm")
#: in the flat layout every leaf starts on a multiple of this many
#: elements (128 bytes or more: the kernels' TMA operands need 16)
FLAT_ALIGN = 64


class JitTrainStep:
    """The train step compiled whole, its parameters and optimizer state
    donated: the counterpart of the reference's ``jax.jit(make_train_step(
    cfg, opt), donate_argnums=(0, 1))``.  ``(params, opt_state, batch) ->
    (params, opt_state, {"loss"})``, as ``make_train_step``.

    **Compiled.**  The loss (the forward through the Forge-compiled
    bodies, each a checkpointed region under remat) is
    ``torch.compile(fullgraph=True, dynamic=False)``; AOTAutograd derives
    its backward (the kernels' registered backward ops among its nodes),
    which ``torch.autograd.grad`` runs.  Dynamo does not trace
    ``torch.autograd.grad``, so the clipping and ``optimizer.update`` (the
    reference's order of operations) are a second compiled graph, which
    writes the new values into the owned tensors (``copy_``).  A graph
    break is an error, never a quiet eager fallback.  The step counter
    (and Adafactor's ``beta2_t``, computed from it) stays a device
    tensor, so one pair of graphs serves every step of a batch shape.  The
    bodies compile in one eager forward first (a traced call finds them
    compiled).

    **The flat layout (AdamW).**  AdamW is elementwise but for the global
    norm of its clipping, so under it the step keeps each dtype's
    parameters in one flat buffer, and the moments in two (every leaf a
    view at a multiple of :data:`FLAT_ALIGN` elements, zeros between);
    the gradients are gathered into a flat buffer of their own (one
    ``cat`` a dtype) and the update graph runs ``optimizer.update`` on
    the flat trees: a graph of a few dozen nodes, which Inductor compiles
    in seconds where a graph per leaf took minutes (4148 nodes for
    forge-125m's 147 leaves), and a few kernels over contiguous memory.
    The norm sums the same squares in another order.  Other optimizers
    update the trees leaf by leaf.

    **Donated.**  The step owns a copy of the parameters and the state,
    made at its first call; each call writes the new values into those
    tensors in place, so their storage never moves, and returns them.  A
    tree handed in whose leaves are not the owned ones (a restore from a
    checkpoint, a caller's own parameters) is copied into the owned
    tensors first; the caller's tensors are never written.  With
    ``donate=False`` the step returns copies of the owned trees, so no
    tensor a caller holds is ever written.

    **On the card** the step (forward, backward, update) is one CUDA
    graph a batch shape.  The first call runs the compiled step once on a
    side stream under a kernel-scratch scope of the step's own (that run
    is the step: the compile, Inductor's kernel loads and the kernels'
    scratch happen there), then captures it; autograd runs the backward on
    its device thread on the same stream, which the scope and the launch
    recorder cover (``_build.scratch_scope(key, stream)``,
    ``_build.recording(stream)``).  Each later call copies the batch into
    the graph's input tensors, replays it, adds the launches recorded at
    capture to the counters and clones the loss out.

    ``graphs`` counts the graphs Dynamo handed to Inductor (the loss and
    the update: 2 a batch shape), ``programs`` Inductor's compiles by role
    (``forward``, ``backward``, ``update``), ``kernel_nodes`` the kernel
    custom-op nodes of the forward and backward programs (a replay
    launches each once), ``compile_s`` the seconds of the first call
    (``compile_split`` divides them) and ``replays`` the graph replays.
    """

    def __init__(self, cfg, optimizer=None, *, donate: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.optimizer = checked_optimizer(cfg, optimizer)
        self.donate = donate
        self.device = torch.device(device)  # resolved at the first call
        self.loss_fn = make_loss_fn(cfg)
        self.flat = isinstance(self.optimizer, AdamW)
        self.graphs = 0
        self.programs: Dict[str, int] = {}
        self.kernel_nodes: Dict[str, Dict[str, int]] = {"forward": {}, "backward": {}}
        self.compile_s = 0.0
        #: seconds of the first call: the eager forward (the bodies'
        #: compiles), Dynamo's traces, AOTAutograd, Inductor by program,
        #: the CUDA graph capture, and the rest (the compiled step's run)
        self.compile_split: Dict[str, float] = {}
        self.replays = 0
        self._loss = torch.compile(self.loss_fn, fullgraph=True, dynamic=False,
                                   backend=self._backend)
        self._update = torch.compile(self._tree_update, fullgraph=True, dynamic=False,
                                     backend=self._backend)
        self._t_call = 0.0  # when the compiled call that may trace started
        #: the owned (params, opt_state) trees and their leaves
        self._tree = None
        self._leaves: List[torch.Tensor] = []
        #: the flat layout: the flat (params, AdamWState) trees, one leaf a
        #: dtype, and each parameter leaf's (dtype, offset, pad)
        self._flat_trees = None
        self._slots: List[Any] = []
        #: per batch shape: the step's own batch tensors, and on the card
        #: the CUDA graph, its loss output and its recorded launches
        self._cells: Dict[Any, Dict[str, Any]] = {}

    # -- the compiled parts ------------------------------------------------

    def _backend(self, gm: torch.fx.GraphModule, example_inputs):
        from torch._inductor.compile_fx import compile_fx, compile_fx_inner

        t0 = time.perf_counter()
        self._add("dynamo", t0 - self._t_call)
        self.graphs += 1
        inner_s = [0.0]

        def inner(g, inputs, **kw):
            role = ("backward" if kw.get("is_backward") else
                    "update" if kw.get("is_inference") else "forward")
            t = time.perf_counter()
            self.programs[role] = self.programs.get(role, 0) + 1
            nodes = self.kernel_nodes.setdefault(role, {})
            for node in g.graph.nodes:
                name = str(node.target)
                if node.op == "call_function" and name.startswith("repro_torch."):
                    op = name.split(".")[1]
                    if op in KERNEL_OPS:
                        nodes[op] = nodes.get(op, 0) + 1
            out = compile_fx_inner(g, inputs, **kw)
            dt = time.perf_counter() - t
            self._add(f"inductor_{role}", dt)
            inner_s[0] += dt
            return out

        # AOTAutograd's cache would skip the partition and the inner
        # compiles that count the programs (Inductor's own cache still serves)
        with torch._inductor.config.patch(emulate_precision_casts=True), \
                torch._functorch.config.patch(enable_autograd_cache=False):
            out = compile_fx(gm, example_inputs, inner_compile=inner)
        self._add("aot", time.perf_counter() - t0 - inner_s[0])
        return out

    def _add(self, part: str, seconds: float) -> None:
        self.compile_split[part] = self.compile_split.get(part, 0.0) + seconds

    def _tree_update(self, grads, params, opt_state) -> None:
        new_params, new_state = self.optimizer.update(grads, opt_state, params)
        for dst, src in zip(leaves_like(new_params, params) + leaves_like(new_state, opt_state),
                            leaves_like(new_params, new_params)
                            + leaves_like(new_state, new_state)):
            dst.copy_(src)

    def _flat_grads(self, grads: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients in the flat layout, one ``cat`` a dtype (outside
        the compiled update: Inductor makes a kernel of every input of a
        ``cat``, 147 for forge-125m)."""
        pieces: Dict[str, List[torch.Tensor]] = {k: [] for k in self._flat_trees[0]}
        for g, (key, pad) in zip(grads, self._slots):
            pieces[key].append(g.reshape(-1))
            if pad:
                pieces[key].append(g.new_zeros(pad))
        return {k: torch.cat(v) for k, v in pieces.items()}

    def _run(self, batch) -> torch.Tensor:
        """One compiled step on the owned tensors: the loss, its gradient,
        the update written in place; returns the loss."""
        params, opt_state = self._tree
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        self._t_call = time.perf_counter()
        loss = self._loss(pytree.tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        self._t_call = time.perf_counter()
        with torch.no_grad():
            if self._flat_trees is None:
                self._update(pytree.tree_unflatten(grads, spec), params, opt_state)
            else:
                self._update(self._flat_grads(grads), *self._flat_trees)
        return loss.detach()

    # -- ownership -----------------------------------------------------------

    def _own(self, params, opt_state) -> None:
        """The owned trees, filled from ``params`` and ``opt_state``: in
        the flat layout views into the flat buffers, else contiguous
        copies, on the step's device."""
        resolve_device(self.device)

        def owned(x):
            return torch.empty(x.shape, dtype=x.dtype, device=self.device)

        if not self.flat:
            self._tree = (pytree.tree_map(owned, params), pytree.tree_map(owned, opt_state))
        else:
            flat, spec = pytree.tree_flatten(params)
            ends: Dict[str, int] = {}
            places = []
            for p in flat:
                key = str(p.dtype).removeprefix("torch.")
                start = ends.get(key, 0)
                size = -(-p.numel() // FLAT_ALIGN) * FLAT_ALIGN
                places.append((key, start, p))
                self._slots.append((key, size - p.numel()))
                ends[key] = start + size
            bufs = {k: {"p": torch.zeros(n, dtype=getattr(torch, k), device=self.device),
                        "m": torch.zeros(n, dtype=torch.float32, device=self.device),
                        "v": torch.zeros(n, dtype=torch.float32, device=self.device)}
                    for k, n in ends.items()}

            def views(kind):
                return pytree.tree_unflatten(
                    [bufs[k][kind][i:i + p.numel()].view(p.shape) for k, i, p in places], spec)

            step = torch.zeros((), dtype=torch.int32, device=self.device)
            self._tree = (views("p"), AdamWState(step=step, mu=views("m"), nu=views("v")))
            self._flat_trees = ({k: b["p"] for k, b in bufs.items()},
                                AdamWState(step=step, mu={k: b["m"] for k, b in bufs.items()},
                                           nu={k: b["v"] for k, b in bufs.items()}))
        self._leaves = (leaves_like(self._tree[0], self._tree[0])
                        + leaves_like(self._tree[1], self._tree[1]))
        self._copy_in(params, opt_state)

    def _copy_in(self, params, opt_state) -> None:
        given = leaves_like(self._tree[0], params) + leaves_like(self._tree[1], opt_state)
        if len(given) != len(self._leaves):
            raise ValueError(f"the step owns {len(self._leaves)} leaves, got {len(given)}")
        with torch.no_grad():
            for dst, src in zip(self._leaves, given):
                if src is not dst:
                    if src.shape != dst.shape or src.dtype != dst.dtype:
                        raise ValueError(f"a leaf of {tuple(src.shape)} {src.dtype} cannot "
                                         f"replace the owned {tuple(dst.shape)} {dst.dtype}")
                    dst.copy_(src)

    @property
    def state(self):
        """The owned ``(params, opt_state)`` (None before the first call)."""
        return self._tree

    # -- the call --------------------------------------------------------------

    def _build(self, cell: Dict[str, Any]) -> torch.Tensor:
        """The first call at a batch shape: the bodies compiled by an eager
        forward, then the compiled step run once (and on the card
        captured).  Returns that run's loss."""
        t0 = time.perf_counter()
        if not self._cells:
            with torch.no_grad():
                self.loss_fn(self._tree[0], cell["batch"])
            self._add("eager", time.perf_counter() - t0)
        if self.device.type != "cuda":
            loss = self._run(cell["batch"])
        else:
            loss = self._capture(cell)
        dt = time.perf_counter() - t0
        self.compile_s += dt
        known = sum(v for k, v in self.compile_split.items() if k != "rest")
        self.compile_split["rest"] = self.compile_s - known
        return loss

    def _capture(self, cell: Dict[str, Any]) -> torch.Tensor:
        from ..core.backends.segment_jit import capture_graph, capture_scope, count_capture

        with capture_scope(self.device, id(self)) as stream:
            # the step's run: the compile, Inductor's kernel loads, the
            # kernels' libraries and per-stream scratch, before the capture
            loss = self._run(cell["batch"]).clone()
            stream.synchronize()
            t0 = time.perf_counter()
            cell["replay"] = capture_graph(lambda: self._run(cell["batch"]))
            dt = time.perf_counter() - t0
        count_capture(1, dt)
        self._add("capture", dt)
        return loss

    def __call__(self, params, opt_state, batch):
        if self._tree is None:
            self._own(params, opt_state)
        else:
            self._copy_in(params, opt_state)
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
        cell = self._cells.get(key)
        if cell is None:
            cell = {"batch": {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                              for k, v in batch.items()}}
        for k, v in batch.items():
            cell["batch"][k].copy_(v)
        if key not in self._cells:
            loss = self._build(cell)
            self._cells[key] = cell
        elif "replay" in cell:
            from ..kernels import _build

            graph, out, launches = cell["replay"]
            graph.replay()
            self.replays += 1
            if launches:
                _build.add_launches(launches)
            loss = out.clone()
        else:
            loss = self._run(cell["batch"])
        params, opt_state = self._tree
        if not self.donate:
            params, opt_state = dealias_tree(params), dealias_tree(opt_state)
        return params, opt_state, {"loss": loss}


def build_trainer(cfg, *, lr: float = 3e-4, use_mesh: bool = True, donate: bool = True,
                  device: str = "cuda"):
    """``(model, optimizer, step_fn)``: AdamW at ``lr`` below 1e9
    parameters, else :func:`default_optimizer`; the step is
    :class:`JitTrainStep` (parameters and state donated unless
    ``donate=False``), as the reference returns ``jax.jit(step,
    donate_argnums=(0, 1))``.  With more than one rank in the live process
    group it builds the host mesh and the family's sharding plan, as the
    reference does (which binds neither to the step either), and the step
    is the eager ``make_train_step``: a planned step compiled whole is
    DTensor under ``torch.compile``, a part of the port still to come
    (nothing falls back to it: the choice is made here, by the mesh)."""
    model = get_model(cfg)
    optimizer = AdamW(lr=lr) if cfg.param_count() < 1e9 else default_optimizer(cfg)
    multi = use_mesh and dist.is_initialized() and dist.get_world_size() > 1
    mesh = make_host_mesh(device_type=torch.device(device).type) if multi else None
    if mesh is not None:
        plan_for(cfg, mesh)
        return model, optimizer, make_train_step(cfg, optimizer)
    return model, optimizer, JitTrainStep(cfg, optimizer, donate=donate, device=device)


def main(argv=None, *, params: Optional[Dict[str, Any]] = None,
         out: Optional[Dict[str, Any]] = None) -> int:
    """The train CLI.  ``params`` replaces the seeded random init (a
    caller training given weights); ``out``, when given, receives the
    run: ``report`` (the ``SupervisorReport``, every step's loss in its
    history, replays included), ``step_s`` (each step's host wall,
    ended by the loss's read), ``state`` (the final params and optimizer
    state: the step's own), ``ckpt`` (the ``CheckpointManager``, its
    ``timings``), ``step`` (the step: its compile and graph counts)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="forge-125m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "forge_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-fault", type=int, default=-1,
                    help="inject one failure at this step (FT demo)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fuse", choices=["forge", "none"], default="forge")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke).with_(fuse=args.fuse)
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("the train CLI covers LM families; use examples/")
    model, optimizer, step_fn = build_trainer(cfg, lr=args.lr, device=str(device))

    data = TokenDataset(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab, seed=args.seed,
    ))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)

    if params is None:
        params = model.init(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    params = dealias_tree(params)
    opt_state = dealias_tree(optimizer.init(params))
    n_params = sum(p.numel() for p in pytree.tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, 1 device(s)")

    state = (params, opt_state)
    start = 0
    if ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        print(f"[train] restored from step {start}")
    else:
        # step-0 checkpoint: restart-from-nothing falls back here
        ckpt.save(0, state)
        ckpt.wait()

    t_hist = []
    fault_armed = {"step": args.simulate_fault}

    def fault_hook(step: int) -> None:
        if step == fault_armed["step"]:
            fault_armed["step"] = -1  # fire once
            raise SimulatedFault(f"injected node failure at step {step}")

    def wrapped_step(state, batch):
        params, opt_state = state
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        t_hist.append(dt)
        return (params, opt_state), {"loss": loss, "dt_s": dt}

    sup = Supervisor(
        step_fn=wrapped_step,
        data_fn=data.batch,
        save_fn=lambda s, st: ckpt.save(s, st),
        restore_fn=lambda: ckpt.restore(state),
        checkpoint_every=args.ckpt_every,
        fault_hook=fault_hook if args.simulate_fault >= 0 else None,
    )
    state, report = sup.run(state, start, args.steps)
    ckpt.wait()
    ckpt.save(start + args.steps, state)
    ckpt.wait()
    if out is not None:
        out.update(report=report, step_s=t_hist, state=state, ckpt=ckpt, step=step_fn)

    losses = [h["loss"] for h in report.history]
    if losses:
        k = max(1, len(losses) // 10)
        print(f"[train] loss {np.mean(losses[:k]):.3f} -> "
              f"{np.mean(losses[-k:]):.3f} over {len(losses)} steps "
              f"({report.failures} failures, {report.restores} restores)")
        toks = args.batch * args.seq
        print(f"[train] median step {np.median(t_hist)*1e3:.0f} ms "
              f"({toks/np.median(t_hist):.0f} tok/s)")
    if losses and not np.mean(losses[-5:]) < np.mean(losses[:5]) + 0.5:
        raise AssertionError("loss diverged")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
