"""The port's whole train step over several steps against the JAX
package's: ``steps.make_train_step`` for 3 steps on the seven families'
f32 smoke configs with AdamW (and with Adafactor on forge-125m and
phi3.5-moe, in the JAX package's stacked layout), every step's loss
within rtol 2e-4 / atol 2e-5.  AdamW's first update is sign(g), so a
near-zero gradient whose sign differs moves its element by 2·lr: the
parameters are held through the losses, not elementwise.  The step
writes none of its inputs.  The train CLI: ``tests/test_torch_train_cli.py``.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import optim as jax_optim
from repro.launch import steps as jax_steps
from repro_torch.launch import steps
from repro_torch.optim import Adafactor, AdamW

from torch_port_support import (TOL_F32, TRAIN_ARCHS, TrainSetup, train_batch_jax,
                                train_batch_np, train_batch_torch)


def _losses(step_fn, params, opt_state, batches, convert):
    out = []
    for b in batches:
        params, opt_state, m = step_fn(params, opt_state, convert(b))
        out.append(float(m["loss"]))
    return out


def _three_steps(setup, port_opt, jax_opt):
    batches = [train_batch_np(setup.cfg, step=i) for i in range(3)]
    jstep = jax.jit(jax_steps.make_train_step(setup.jcfg, jax_opt))
    want = _losses(jstep, setup.jp, jax_opt.init(setup.jp), batches, train_batch_jax)
    before = [t.clone() for t in pytree.tree_leaves(setup.p)]
    step = steps.make_train_step(setup.cfg, port_opt)
    state = port_opt.init(setup.p)
    state_before = [t.clone() for t in pytree.tree_leaves(state)]
    got = _losses(step, setup.p, state, batches, train_batch_torch)
    np.testing.assert_allclose(got, want, **TOL_F32)
    # out of place: the caller's params and state are as they were
    assert all(torch.equal(a, b) for a, b in zip(before, pytree.tree_leaves(setup.p)))
    assert all(torch.equal(a, b) for a, b in zip(state_before, pytree.tree_leaves(state)))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_three_adamw_steps_match_reference(arch):
    _three_steps(TrainSetup(arch), AdamW(), jax_optim.AdamW())


@pytest.mark.parametrize("arch", ["forge-125m", "phi3.5-moe-42b-a6.6b"])
def test_three_adafactor_steps_match_reference(arch):
    setup = TrainSetup(arch)
    _three_steps(setup, Adafactor().for_config(setup.cfg), jax_optim.Adafactor())
    with pytest.raises(ValueError, match="for_config"):
        steps.make_train_step(setup.cfg, Adafactor())
