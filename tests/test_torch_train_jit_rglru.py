"""recurrentgemma-2b (RG-LRU hybrid) through the train step compiled whole
and donated (``launch.train.JitTrainStep``), f32 smoke config: 3 AdamW
steps' losses within rtol 2e-4 / atol 2e-5 of the JAX package's
``jax.jit(make_train_step(...), donate_argnums=(0, 1))``; the RG-LRU
scan's custom op in the compiled forward (its registered backward, the
plain recompute, traced into the backward program); one graph for the
loss and one for the update, every leaf's storage kept.

The body keys: the recurrent bodies are keyed by ``config_key(cfg)``
(``repr`` taken once per config object), so Dynamo traces ``apply``
whole (``torch.compile(fullgraph=True)``, the trace's result bitwise the
eager forward's), and two configs of one name that split heads
differently get bodies of their own.
"""
import numpy as np
import torch

from repro import optim as jax_optim
from repro_torch.launch import train
from repro_torch.models import _forge, get_model
from repro_torch.models._forge import config_key
from repro_torch.optim import AdamW

from torch_port_support import (TOL_F32, TrainSetup, assert_one_graph, jax_jit_losses,
                                jit_train_run, train_batch_np)

ARCH = "recurrentgemma-2b"


def test_compiled_steps_match_jitted_reference():
    setup = TrainSetup(ARCH)
    step = train.JitTrainStep(setup.cfg, AdamW(), device="cpu")
    out = jit_train_run(setup, step, AdamW())
    want = jax_jit_losses(setup, jax_optim.AdamW(), out["batches"])
    np.testing.assert_allclose(out["losses"], want, **TOL_F32)
    assert_one_graph(step, out)
    assert out["untouched"]
    # two rec layers' scans and the attn layer's flash in the forward; the
    # smoke config has no remat, so the backward program reruns no kernel
    fwd = step.kernel_nodes["forward"]
    assert fwd["rg_lru"] == 2 and fwd["flash_attention"] == 1, step.kernel_nodes
    assert step.kernel_nodes["backward"] == {}, step.kernel_nodes


def test_apply_traces_whole_and_bodies_key_by_config():
    setup = TrainSetup(ARCH)
    cfg, model = setup.cfg, get_model(setup.cfg)
    tokens = torch.from_numpy(train_batch_np(cfg)["tokens"]).long()
    with torch.no_grad():
        want = model.apply(setup.p, tokens, cfg)
        got = torch.compile(model.apply, fullgraph=True, dynamic=False, backend="eager")(
            setup.p, tokens, cfg)
    assert torch.equal(got, want)
    # one name, one set of shapes for the recurrent body, another head split
    other = cfg.with_(n_heads=2, n_kv_heads=2, head_dim=8)
    assert other.name == cfg.name
    p2 = get_model(other).init(other, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        get_model(other).apply(p2, tokens, other)
    for c in (cfg, other):  # the recurrent body's inputs have the same shapes in both
        for kind in ("rec", "attn"):
            assert any(k.startswith(f"{config_key(c)}/{kind}/") for k in _forge._CACHE), (c, kind)
