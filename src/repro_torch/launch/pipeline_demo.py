"""Pipeline-parallelism demo + correctness check: a port of the JAX
package's ``launch/pipeline_demo.py``.

Spawns two gloo ranks on the CPU, builds a 2-stage GPipe over them,
streams 4 microbatches of a 4-layer tanh MLP stack (d 32, microbatch 2,
sequence 8, the reference's sizes and numpy data) through it, and checks
agreement with the sequential reference (rtol 1e-5, atol 1e-6).

  PYTHONPATH=src python -m repro_torch.launch.pipeline_demo
"""
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..distrib.pipeline import gpipe_apply, reference_apply, split_stages

L, D, MB, M, S = 4, 32, 2, 4, 8
N_STAGES = 2


def inputs():
    rng = np.random.default_rng(0)
    blocks = {
        "w": torch.from_numpy((rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)),
        "b": torch.from_numpy((rng.standard_normal((L, D)) * 0.1).astype(np.float32)),
    }
    x = torch.from_numpy(rng.standard_normal((M, MB, S, D)).astype(np.float32))
    return split_stages(blocks, N_STAGES), x


def stage_fn(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def _rank(rank: int, init_file: str, result_file: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=N_STAGES)
    try:
        stages, x = inputs()
        out = gpipe_apply(stages, x, stage_fn)
        expect = reference_apply(stages, x, stage_fn)
        torch.testing.assert_close(out, expect, rtol=1e-5, atol=1e-6)
        if rank == 0:
            torch.save(out, result_file)
    finally:
        dist.destroy_process_group()


def run() -> torch.Tensor:
    """The pipeline's output on two spawned gloo ranks (rank 0's copy)."""
    with tempfile.TemporaryDirectory(prefix="gpipe_") as tmp:
        result = os.path.join(tmp, "out.pt")
        mp.start_processes(_rank, args=(os.path.join(tmp, "init"), result),
                           nprocs=N_STAGES, start_method="spawn")
        return torch.load(result)


def main() -> int:
    out = run()
    stages, x = inputs()
    np.testing.assert_allclose(out.numpy(), reference_apply(stages, x, stage_fn).numpy(),
                               rtol=1e-5, atol=1e-6)
    print(f"[pipeline] 2-stage GPipe over pod axis: {M} microbatches, "
          f"bubble={(2 - 1) / (M + 2 - 1):.0%}, output matches sequential "
          f"reference exactly — OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
