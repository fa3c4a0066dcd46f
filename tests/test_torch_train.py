"""The port's training step (``steps.make_train_step``) against the JAX
package's, f32, on the smoke configs of the seven families: forge-125m
(dense, GELU, tied head), qwen2.5-14b (SwiGLU, GQA), recurrentgemma-2b
(RG-LRU hybrid), xlstm-350m (mLSTM + sLSTM), phi3.5-moe (top-2 of 16
experts), seamless-m4t-large-v2 (encoder-decoder, frames) and
qwen2-vl-72b (VLM, patches ahead of the text).  JAX parameters reach the
port through the bridge; batches come from ``TokenDataset`` (numpy).

* the loss and every gradient leaf (``jax.value_and_grad`` against
  ``torch.autograd`` through the Forge-compiled bodies), bridged back
  to the port's layout, within rtol 2e-4 / atol 2e-5;
* remat (``torch.utils.checkpoint`` around each body) against none:
  gradients bitwise equal, each body run twice a step, no second
  compile; and nothing changes under ``no_grad``;
* ``fuse="forge"`` against ``"none"``;
* a body compiled under ``no_grad`` (a serve path) then trained through;
* ``default_optimizer`` and Adafactor's stacked view per family.

The whole train step over several steps and the train CLI:
``tests/test_torch_train_steps.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.executor import CompiledExecutor
from repro_torch.data import DataConfig, TokenDataset
from repro_torch.launch import steps
from repro_torch.models import _forge
from repro_torch.optim import Adafactor, AdamW

from torch_port_support import (TOL_F32, TRAIN_ARCHS, TrainSetup, jax_params, to_numpy,
                                train_batch_jax, train_batch_np, train_batch_torch)

@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def setup(request):
    return TrainSetup(request.param)


def _by_path(tree):
    return {pytree.keystr(k): v for k, v in pytree.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(got, want, what, tol=TOL_F32):
    g, w = _by_path(got), _by_path(want)
    assert sorted(g) == sorted(w), what
    for k in g:
        assert g[k].shape == w[k].shape, f"{what} {k}"
        np.testing.assert_allclose(g[k].detach().numpy(), w[k].detach().numpy(),
                                   err_msg=f"{what} {k}", **tol)


def _assert_tree_equal(got, want, what):
    g, w = _by_path(got), _by_path(want)
    assert sorted(g) == sorted(w), what
    for k in g:
        assert torch.equal(g[k], w[k]), f"{what} {k}"


def test_loss_and_grads_match_reference(setup):
    b = train_batch_np(setup.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_steps.make_loss_fn(setup.jcfg)))(
        setup.jp, train_batch_jax(b))
    loss, grads = steps.loss_and_grads(steps.make_loss_fn(setup.cfg), setup.p, train_batch_torch(b))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL_F32)
    _assert_tree_close(grads, setup.to_port(jgrads), f"{setup.arch} grads")
    assert any(float(g.abs().max()) > 0 for g in pytree.tree_leaves(grads))


@pytest.fixture
def executions(monkeypatch):
    """Counts the executions of every compiled body.  (A body's own
    ``stats.total_calls`` misses a rerun in backward: ``torch.utils.
    checkpoint`` stops the rerun once it has recomputed the last tensor
    backward needs, before the executor's bookkeeping.)"""
    n = [0]
    execute = CompiledExecutor.execute

    def counted(self, *args):
        n[0] += 1
        return execute(self, *args)

    monkeypatch.setattr(CompiledExecutor, "execute", counted)
    return n


def _n_bodies(cfg):
    if cfg.family == "encdec":
        return (cfg.n_enc_layers or cfg.n_layers) + (cfg.n_dec_layers or cfg.n_layers)
    return cfg.n_layers


def test_remat_gradients_bitwise(setup, executions):
    """remat reruns each body in backward: gradients bitwise, twice the
    body executions, no body compiled again; under ``no_grad`` the
    forward is the body's own call."""
    b = train_batch_torch(train_batch_np(setup.cfg))
    plain, remat = setup.cfg.with_(remat=False), setup.cfg.with_(remat=True)
    for cfg in (plain, remat):  # compile both configs' bodies
        steps.loss_and_grads(steps.make_loss_fn(cfg), setup.p, b)
    bodies = len(_forge._CACHE)
    runs = {}
    for name, cfg in (("plain", plain), ("remat", remat)):
        executions[0] = 0
        runs[name] = steps.loss_and_grads(steps.make_loss_fn(cfg), setup.p, b)
        runs[name + "_n"] = executions[0]
    assert runs["plain_n"] == _n_bodies(setup.cfg)
    assert runs["remat_n"] == 2 * runs["plain_n"]
    assert len(_forge._CACHE) == bodies
    assert torch.equal(runs["plain"][0], runs["remat"][0])
    _assert_tree_equal(runs["remat"][1], runs["plain"][1], f"{setup.arch} remat grads")
    with torch.no_grad():
        executions[0] = 0
        out = steps.make_forward(remat)(setup.p, b)
        assert executions[0] == _n_bodies(setup.cfg)
        assert torch.equal(out, steps.make_forward(plain)(setup.p, b))


@pytest.mark.parametrize("arch", ["forge-125m", "qwen2.5-14b", "xlstm-350m"])
def test_fuse_forge_against_none(arch):
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    jp = jax_params(jax_get_config(arch, smoke=True).with_(dtype="float32"))
    params = bridge.params_from_numpy(to_numpy(jp), device="cpu")
    b = train_batch_torch(train_batch_np(cfg))
    loss_f, g_f = steps.loss_and_grads(steps.make_loss_fn(cfg), params, b)
    loss_n, g_n = steps.loss_and_grads(steps.make_loss_fn(cfg.with_(fuse="none")), params, b)
    np.testing.assert_allclose(float(loss_f), float(loss_n), **TOL_F32)
    _assert_tree_close(g_f, g_n, f"{arch} forge vs none grads")


def test_body_compiled_under_no_grad_then_trained():
    """A body a serve path compiled (under ``no_grad``) carries gradients
    when training calls it with grad: no second compile, the gradients
    of the unfused forward."""
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32", remat=True, n_layers=3)
    jp = jax_params(jax_get_config("forge-125m", smoke=True).with_(dtype="float32", n_layers=3))
    params = bridge.params_from_numpy(to_numpy(jp), device="cpu")
    b = train_batch_torch(train_batch_np(cfg))
    _forge.clear_cache()
    with torch.no_grad():
        steps.make_forward(cfg)(params, b)
    compiled = len(_forge._CACHE)
    assert compiled == 1
    loss, grads = steps.loss_and_grads(steps.make_loss_fn(cfg), params, b)
    assert len(_forge._CACHE) == compiled
    _, want = steps.loss_and_grads(steps.make_loss_fn(cfg.with_(fuse="none")), params, b)
    _assert_tree_close(grads, want, "grads through a body compiled under no_grad")


def test_default_optimizer_and_threshold():
    assert steps.ADAFACTOR_THRESHOLD == jax_steps.ADAFACTOR_THRESHOLD
    for arch in ("forge-125m", "qwen2.5-14b", "kimi-k2-1t-a32b"):
        got, want = steps.default_optimizer(get_config(arch)), \
            jax_steps.default_optimizer(jax_get_config(arch))
        assert type(got).__name__ == type(want).__name__ and got.lr == want.lr
    assert isinstance(steps.default_optimizer(get_config("kimi-k2-1t-a32b")), Adafactor)


def test_adafactor_stacked_view_per_family():
    """``Adafactor().for_config(cfg)`` takes the JAX package's layout: the
    forge tree's ``blocks`` stacked, recurrentgemma's layers apart; the
    default optimizer of a config above the threshold comes bound."""
    from repro_torch.models import get_model

    for arch, keys in (("forge-125m", ("blocks",)), ("recurrentgemma-2b", ())):
        cfg = get_config(arch, smoke=True).with_(dtype="float32")
        p = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
        st = Adafactor().for_config(cfg).init(p)
        assert isinstance(st.vr["blocks"], dict if keys else list)
    kimi = get_config("kimi-k2-1t-a32b")
    assert steps.default_optimizer(kimi).stacked == ("blocks",)
    steps.make_train_step(kimi)  # binds without raising
