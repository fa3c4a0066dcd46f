"""forge-125m with ``Adafactor().for_config(cfg)`` through the train step
compiled whole and donated (``launch.train.JitTrainStep``), f32 smoke
config: 3 steps' losses within rtol 2e-4 / atol 2e-5 of the JAX package's
``jax.jit(make_train_step(...), donate_argnums=(0, 1))``.  The stacked
view and ``beta2_t = 1 - step^-decay`` (from the device step counter, so
no recompile as the step grows) run in the compiled update; one graph
for the loss and one for the update, every leaf's storage kept, the
factored state written in place.  An Adafactor not bound to the config
is refused, as ``make_train_step`` refuses it.
"""
import numpy as np
import pytest

from repro import optim as jax_optim
from repro_torch.launch import train
from repro_torch.optim import Adafactor

from torch_port_support import (TOL_F32, TrainSetup, assert_one_graph, jax_jit_losses,
                                jit_train_run)


def test_compiled_adafactor_steps_match_jitted_reference():
    setup = TrainSetup("forge-125m")
    opt = Adafactor().for_config(setup.cfg)
    step = train.JitTrainStep(setup.cfg, opt, device="cpu")
    out = jit_train_run(setup, step, opt)
    want = jax_jit_losses(setup, jax_optim.Adafactor(), out["batches"])
    np.testing.assert_allclose(out["losses"], want, **TOL_F32)
    assert_one_graph(step, out)
    assert out["untouched"]
    assert int(step.state[1].step) == 3


def test_unbound_adafactor_refused():
    cfg = TrainSetup("forge-125m").cfg
    with pytest.raises(ValueError, match="for_config"):
        train.JitTrainStep(cfg, Adafactor(), device="cpu")
