"""The train step compiled whole and donated (``launch.train.JitTrainStep``,
what ``build_trainer`` returns on one device) on forge-125m's f32 smoke
config, against the JAX package's ``jax.jit(make_train_step(...),
donate_argnums=(0, 1))``:

* 3 steps' losses within rtol 2e-4 / atol 2e-5 with AdamW (the step
  ``build_trainer`` returns; Adafactor: ``test_torch_train_jit_adafactor.py``);
  parameters are held through the losses (``tests/test_torch_train_steps.py``
  says why);
* donation: every parameter and state leaf keeps its storage over the
  steps; the caller's own trees are copied in and never written; a state
  restored from a checkpoint and copied in gives the uninterrupted run's
  losses bitwise; a ``CheckpointManager.save`` followed by a donated step
  keeps the values it saved; with ``donate=False`` nothing a caller holds
  is written;
* one graph: the loss and the update compile once each (Dynamo's
  counters), no recompile across steps; a graph break raises.

One compile of the AdamW step serves the steps, the donation checks and
the restore (module fixture).  The other families:
``test_torch_train_jit_{moe,rglru,xlstm}.py``.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import optim as jax_optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train

from torch_port_support import (TOL_F32, TrainSetup, assert_one_graph, jax_jit_losses,
                                jit_train_run, leaf_ptrs, train_batch_torch)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    setup = TrainSetup("forge-125m")
    _, opt, step = train.build_trainer(setup.cfg, device="cpu")
    out = jit_train_run(setup, step, opt)
    out.update(setup=setup, step=step, opt=opt,
               want=jax_jit_losses(setup, jax_optim.AdamW(), out["batches"]))
    # the state after step 1 saved, then two donated steps write the buffers
    ckpt = CheckpointManager(str(tmp_path_factory.mktemp("ckpt")))
    p, s = setup.p, opt.init(setup.p)
    p, s, _ = step(p, s, train_batch_torch(out["batches"][0]))
    ckpt.save(1, (p, s))
    out["saved"] = [t.clone() for t in pytree.tree_leaves((p, s))]
    resumed = []
    for b in out["batches"][1:]:
        p, s, m = step(p, s, train_batch_torch(b))
        resumed.append(float(m["loss"]))
    # a restore after a fault: new tensors, copied into the owned ones
    (p, s), at = ckpt.restore((p, s))
    out.update(resumed=resumed, restored=pytree.tree_leaves((p, s)), restored_at=at)
    replay = []
    for b in out["batches"][1:]:
        p, s, m = step(p, s, train_batch_torch(b))
        replay.append(float(m["loss"]))
    out["replay"] = replay
    return out


def test_build_trainer_returns_the_compiled_donated_step(run):
    step = run["step"]
    assert isinstance(step, train.JitTrainStep) and step.donate
    assert step.device == torch.device("cpu")


def test_losses_match_jitted_reference(run):
    np.testing.assert_allclose(run["losses"], run["want"], **TOL_F32)
    assert all(np.isfinite(run["losses"]))


def test_one_graph_and_fixed_storage(run):
    """3 steps, a save, 2 steps, a restore and 2 more: still the first
    two graphs, and every leaf where it was."""
    assert_one_graph(run["step"], run)
    assert leaf_ptrs(run["step"].state) == run["ptrs"][0]


def test_caller_trees_copied_in_and_untouched(run):
    assert run["untouched"]
    assert not set(leaf_ptrs(run["setup"].p)) & set(run["ptrs"][0])


def test_restore_copied_in_replays_bitwise(run):
    """The step-1 state from disk, copied into the owned buffers, gives
    steps 2-3 of the uninterrupted run to the bit."""
    assert run["restored_at"] == 1
    assert run["replay"] == run["losses"][1:] == run["resumed"]


def test_snapshot_survives_donated_steps(run):
    """``save`` copies every leaf to the host before it returns: the two
    donated steps after it, which write the same buffers, do not reach
    the checkpoint."""
    assert len(run["restored"]) == len(run["saved"])
    assert all(torch.equal(a, b) for a, b in zip(run["restored"], run["saved"]))
    assert not all(torch.equal(a, b) for a, b in
                   zip(run["saved"], pytree.tree_leaves(run["step"].state)))


def test_donate_false_writes_nothing_a_caller_holds(run):
    setup, opt = run["setup"], run["opt"]
    step = train.JitTrainStep(setup.cfg, opt, donate=False, device="cpu")
    p0, s0 = setup.p, opt.init(setup.p)
    kept = [t.clone() for t in pytree.tree_leaves((p0, s0))]
    p1, s1, m1 = step(p0, s0, train_batch_torch(run["batches"][0]))
    kept1 = [t.clone() for t in pytree.tree_leaves((p1, s1))]
    p2, s2, m2 = step(p1, s1, train_batch_torch(run["batches"][1]))
    assert all(torch.equal(a, b) for a, b in zip(kept, pytree.tree_leaves((p0, s0))))
    assert all(torch.equal(a, b) for a, b in zip(kept1, pytree.tree_leaves((p1, s1))))
    assert not set(leaf_ptrs((p2, s2))) & set(leaf_ptrs(step.state))
    assert [float(m1["loss"]), float(m2["loss"])] == run["losses"][:2]


def test_graph_break_raises(run, monkeypatch):
    """A loss Dynamo cannot take whole raises at the first call, never
    runs eagerly in pieces."""
    setup, opt = run["setup"], run["opt"]
    make_loss = train.make_loss_fn

    def broken_loss_fn(cfg):
        loss_fn = make_loss(cfg)

        def fn(params, batch):
            torch._dynamo.graph_break()
            return loss_fn(params, batch)

        return fn

    monkeypatch.setattr(train, "make_loss_fn", broken_loss_fn)
    step = train.JitTrainStep(setup.cfg, opt, device="cpu")
    with pytest.raises(torch._dynamo.exc.Unsupported):
        step(setup.p, opt.init(setup.p), train_batch_torch(run["batches"][0]))
