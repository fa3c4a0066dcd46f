"""The port's train CLI on two gloo ranks (``launch.train.main`` under
the environment ``torchrun --nproc-per-node 2`` sets), forge-125m smoke
bf16 on the CPU, with a fault injected at step 4, against the JAX
package's CLI on the same arguments and initial weights.

Each rank opens the group itself, compiles its own step (the reference
compiles its step whatever its device count, ``jax.jit(step,
donate_argnums=(0, 1))``) and trains on the same global batch; rank 0
alone writes checkpoints, and a barrier after its write makes both
ranks restore the same complete step after the fault.  Held: both steps
are ``JitTrainStep``; both ranks' losses bitwise equal, and equal to the
JAX CLI's within the bf16 tolerance; one failure and one restore on
each rank, the replayed step's loss bitwise the first pass's; steps 0,
3 and 6 on disk, written by rank 0 only.
"""
import os
import socket

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import train as jax_train

from test_torch_train_cli import CLI_ARGS
from torch_dist_workers import spawn_all, train_cli_rank
from torch_port_support import TOL_BF16, jax_params, port_params

WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' runs and the JAX package's report (its run meanwhile)."""
    jp = jax_params(jax_get_config("forge-125m", smoke=True))
    tmp = tmp_path_factory.mktemp("ranks")
    params_file = str(tmp / "params.pt")
    torch.save(port_params(jp), params_file)
    argv = CLI_ARGS + ["--device", "cpu", "--ckpt-dir", str(tmp / "ckpt")]
    ref_reports = []

    class Recording(jax_train.Supervisor):
        def run(self, *a, **kw):
            state, report = super().run(*a, **kw)
            ref_reports.append(report)
            return state, report

    def reference():
        mp = pytest.MonkeyPatch()
        mp.setattr(jax_train, "Supervisor", Recording)
        try:
            assert jax_train.main(CLI_ARGS + ["--ckpt-dir", str(tmp / "ref")]) == 0
        finally:
            mp.undo()

    out, = spawn_all([(train_cli_rank, WORLD, tmp / "out", _free_port(), argv, params_file)],
                     timeout=240.0, meanwhile=reference)
    ranks = [torch.load(os.path.join(out, f"r{r}.pt"), weights_only=False) for r in range(WORLD)]
    return ranks, ref_reports[0]


def test_each_rank_compiles_its_step(runs):
    ranks, _ = runs
    for r, res in enumerate(ranks):
        assert res["code"] == 0 and res["step_type"] == "JitTrainStep"
        assert f"2 device(s) (rank {r} on cpu)" in res["printed"]
        assert res["group_closed"]  # main closed the group it opened


def test_ranks_bitwise_equal_and_match_jax_cli(runs):
    ranks, ref = runs
    losses = [[h["loss"] for h in res["history"]] for res in ranks]
    assert losses[0] == losses[1]
    assert [h["step"] for h in ranks[0]["history"]] == [h["step"] for h in ref.history]
    np.testing.assert_allclose(losses[0], [h["loss"] for h in ref.history], **TOL_BF16)


def test_fault_restored_and_replayed_on_both_ranks(runs):
    ranks, _ = runs
    for res in ranks:
        assert res["failures"] == 1 and res["restores"] == 1
        assert [h["step"] for h in res["history"]] == [0, 1, 2, 3, 3, 4, 5]
        assert res["history"][3]["loss"] == res["history"][4]["loss"]
        assert len(res["timings"]["restore_s"]) == 1 and res["opt_step"] == 6


def test_checkpoints_written_once(runs):
    ranks, _ = runs
    assert ranks[0]["all_steps"] == ranks[1]["all_steps"] == [0, 3, 6]
    # rank 0 wrote step 0, the supervisor's 3 and 6, and the final 6
    assert len(ranks[0]["timings"]["write_s"]) == 4
    assert ranks[1]["timings"]["snapshot_s"] == ranks[1]["timings"]["write_s"] == []
