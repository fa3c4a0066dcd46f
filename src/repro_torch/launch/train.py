"""End-to-end training entry point with fault tolerance: a port of the JAX
package's ``launch/train.py``.

Drives ``make_train_step`` with:

* deterministic resumable data (``TokenDataset``),
* async checkpointing (atomic step directories, keep-last-k),
* the Supervisor's checkpoint/restart loop (``--simulate-fault`` injects
  a failure to show the recovery),
* ``--compress-grads``, parsed and read by nothing, as in the reference.

The reference compiles the whole step with ``jax.jit``; here the step
runs eagerly around the Forge-compiled block bodies, on the default
``interpret`` backend (``segment_jit`` replays CUDA graphs under
``no_grad``, so it carries no gradient).  The step runs on CUDA unless
``--device cpu`` is given.

Usage (training a ~100M model; ``--smoke --device cpu`` on a CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch forge-125m \\
      --steps 200 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Optional

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
from ..runtime import SimulatedFault, Supervisor
from .mesh import make_host_mesh
from .steps import dealias_tree, default_optimizer, make_train_step


def build_trainer(cfg, *, lr: float = 3e-4, use_mesh: bool = True, device: str = "cuda"):
    """``(model, optimizer, step_fn)``: AdamW at ``lr`` below 1e9
    parameters, else :func:`default_optimizer`.  With more than one rank
    in the live process group it builds the host mesh and the family's
    sharding plan, as the reference does (which binds neither to the
    step either)."""
    model = get_model(cfg)
    optimizer = AdamW(lr=lr) if cfg.param_count() < 1e9 else default_optimizer(cfg)
    step = make_train_step(cfg, optimizer)
    multi = use_mesh and dist.is_initialized() and dist.get_world_size() > 1
    mesh = make_host_mesh(device_type=torch.device(device).type) if multi else None
    if mesh is not None:
        plan_for(cfg, mesh)
    return model, optimizer, step


def main(argv=None, *, params: Optional[Dict[str, Any]] = None,
         out: Optional[Dict[str, Any]] = None) -> int:
    """The train CLI.  ``params`` replaces the seeded random init (a
    caller training given weights); ``out``, when given, receives the
    run: ``report`` (the ``SupervisorReport``, every step's loss in its
    history, replays included), ``step_s`` (each step's host wall,
    ended by the loss's read), ``state`` (the final params and optimizer
    state), ``ckpt`` (the ``CheckpointManager``, its ``timings``)."""
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
        out.update(report=report, step_s=t_hist, state=state, ckpt=ckpt)

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
