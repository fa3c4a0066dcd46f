"""phi3.5-moe (top-2 of 16 experts) through the train step compiled whole
and donated (``launch.train.JitTrainStep``), f32 smoke config: 3 AdamW
steps' losses within rtol 2e-4 / atol 2e-5 of the JAX package's
``jax.jit(make_train_step(...), donate_argnums=(0, 1))`` (routing,
capacity dispatch and the expert products in the compiled forward and
backward); one graph for the loss and one for the update, every leaf's
storage kept, the caller's trees as they were.
"""
import numpy as np

from repro import optim as jax_optim
from repro_torch.launch import train
from repro_torch.optim import AdamW

from torch_port_support import (TOL_F32, TrainSetup, assert_one_graph, jax_jit_losses,
                                jit_train_run)


def test_compiled_steps_match_jitted_reference():
    setup = TrainSetup("phi3.5-moe-42b-a6.6b")
    step = train.JitTrainStep(setup.cfg, AdamW(), device="cpu")
    out = jit_train_run(setup, step, AdamW())
    want = jax_jit_losses(setup, jax_optim.AdamW(), out["batches"])
    np.testing.assert_allclose(out["losses"], want, **TOL_F32)
    assert_one_graph(step, out)
    assert out["untouched"]
