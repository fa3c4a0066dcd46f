"""Pipeline parallelism over a process group (GPipe fill–drain): a port of
the JAX package's ``distrib/pipeline.py``.

Layers are split into ``n_stages`` contiguous stages, one a rank of the
pipeline group (the reference's ``pod`` axis); microbatches stream
through with point-to-point boundary transfers (one (mb, S, d)
activation a tick, stage ``i`` to ``i + 1``), and the fill/drain bubble
of (S−1)/(M+S−1) is amortized by the microbatch count M.

``gpipe_apply`` runs the reference's schedule: ``M + S − 1`` ticks; at
tick ``t`` stage 0 feeds microbatch ``t`` (zeros once they run out),
every other stage the output its predecessor made at tick ``t − 1``
(zeros at tick 0); the last stage retires microbatch ``t − (S − 1)``;
its results reach every rank by the reference's owner-masked sum, an
``all_reduce`` (the other ranks add zeros, so the sum is exact).

``gpipe_apply`` is forward-only (serving/prefill pipelines), as in the
reference.  On one card NCCL cannot hold two ranks, so multi-rank
pipelines run over gloo on the CPU (``launch/pipeline_demo.py``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def split_stages(blocks: Any, n_stages: int) -> Any:
    """Reshape layer-stacked params (L, …) -> (n_stages, L/n_stages, …)."""

    def one(a):
        L = a.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return pytree.tree_map(one, blocks)


def gpipe_apply(
    stage_params: Any,  # (n_stages, L/S, …) or this rank's (1, L/S, …)
    microbatches: torch.Tensor,  # (M, mb, S, d), the same on every rank
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],  # layers of ONE stage
    *,
    group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """Run M microbatches through the stage pipeline, stage ``i`` on the
    group's rank ``i`` (default: the whole world); returns (M, mb, S, d)
    on every rank.

    ``stage_fn(params_stage, x)`` applies one stage's layer stack.
    """
    group = group or dist.group.WORLD
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    M = microbatches.shape[0]
    ticks = M + n_stages - 1
    lead = pytree.tree_leaves(stage_params)[0].shape[0]
    if lead not in (n_stages, 1):
        raise ValueError(f"stage params lead with {lead}, not {n_stages} stages or 1")
    params = pytree.tree_map(lambda a: a[stage if lead == n_stages else 0], stage_params)
    prev_rank = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    next_rank = dist.get_global_rank(group, stage + 1) if stage < n_stages - 1 else None

    zero = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    sends: List[Any] = []
    for t in range(ticks):
        if stage == 0:
            inp = microbatches[t] if t < M else zero
        elif t == 0:
            inp = zero
        else:  # boundary transfer: stage i-1's output of tick t-1
            inp = torch.empty_like(zero)
            dist.recv(inp, src=prev_rank, group=group)
        out = stage_fn(params, inp)
        if next_rank is not None and t < ticks - 1:
            out = out.contiguous()
            sends.append((dist.isend(out, dst=next_rank, group=group), out))
        # the last stage retires microbatch t-(S-1) at tick t
        retire = t - (n_stages - 1)
        if stage == n_stages - 1 and retire >= 0:
            outs[retire] = out
    for req, _ in sends:
        req.wait()
    # broadcast the last stage's results to every rank (owner-masked sum)
    owner = float(stage == n_stages - 1)
    outs = outs * owner
    dist.all_reduce(outs, group=group)
    return outs


def reference_apply(stage_params, microbatches, stage_fn) -> torch.Tensor:
    """Sequential oracle: all stages applied in order, no pipeline."""
    n_stages = pytree.tree_leaves(stage_params)[0].shape[0]

    def one_mb(x):
        for s in range(n_stages):
            p_s = pytree.tree_map(lambda a: a[s], stage_params)
            x = stage_fn(p_s, x)
        return x

    return torch.stack([one_mb(x) for x in microbatches])
