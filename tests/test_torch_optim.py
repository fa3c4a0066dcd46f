"""The port's optimizers (``repro_torch.optim``) against the JAX
package's on identical numpy gradients: AdamW and Adafactor for 5 steps
on f32 and bf16 parameters with global-norm clipping active, and on a
forge-125m smoke parameter tree, which the JAX package stacks over the
layers (``scan_layers``) and the port keeps as a list of layers (the
port's Adafactor works on the stacked view, so it factors the (L, d)
norm scales and RMS-clips each (L, n, m) weight over all layers as the
reference does).  Parameters and optimizer states within 1e-6 (bf16
parameters: the f32 updates within 1e-6 round to the same bf16 value
but for at most 0.1% of elements, one bf16 ulp apart).  Then the
JAX package's substrate cases on the port's classes (convergence,
factored state shapes, clipping, ``global_norm``), ``get_optimizer`` and
the bridge of the optimizer states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import optim as jax_optim
from repro.configs import get_config as jax_get_config
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.optim import (Adafactor, AdafactorState, AdamW, AdamWState, get_optimizer,
                               global_norm, stacked_keys)

from torch_port_support import jax_params, to_numpy

TOL_OPT = dict(rtol=1e-6, atol=1e-6)
#: bf16 params: at most this share of elements one bf16 rounding apart
BF16_FLIP_SHARE = 1e-3
N_STEPS = 5
DTYPES = ["float32", "bfloat16"]


def _np32(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().cpu().numpy()


def _by_path(tree):
    """Leaves by key path (JAX rebuilds dicts with sorted keys, the port
    keeps insertion order: compare by path, not by position)."""
    if isinstance(tree, torch.Tensor) or not isinstance(tree, (dict, list, tuple)):
        return {"": tree}
    return {pytree.keystr(k): v for k, v in pytree.tree_flatten_with_path(tree)[0]}


def _close(got, want, what):
    g, w = _by_path(got), _by_path(want)
    assert sorted(g) == sorted(w), what
    for k in g:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), f"{what} {k}"
        a, b = _np32(g[k]), _np32(w[k])
        if g[k].dtype == torch.bfloat16:
            # both compute the update in f32 within 1e-6 and round it to
            # bf16 once: where the two f32 values straddle a rounding
            # boundary, the bf16 results are one ulp (at most 2^-7 of the
            # value) apart
            off = np.abs(a - b) > TOL_OPT["atol"] + TOL_OPT["rtol"] * np.abs(b)
            assert off.mean() <= BF16_FLIP_SHARE, f"{what} {k}: {off.sum()} of {off.size} off"
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=TOL_OPT["atol"],
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, err_msg=f"{what} {k}", **TOL_OPT)


def _small_tree(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "e": (3, 4, 5), "s": ()}
    return {k: np.asarray(rng.standard_normal(s) * 0.5, dtype=np.float32).astype(dtype)
            for k, s in shapes.items()}


def _grads_like(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(rng.standard_normal(np.shape(p)) * scale, dtype=np.float32), tree)


def _run_both(port_opt, jax_opt, jtree, ptree, grads_seq, to_port):
    """N steps of both optimizers on the same gradients; returns the
    states after each step (port, reference)."""
    jst, pst = jax_opt.init(jtree), port_opt.init(ptree)
    out = []
    for gs in grads_seq:
        dt = jax.tree_util.tree_map(lambda p: p.dtype, jtree)
        jg = jax.tree_util.tree_map(lambda g, d: jnp.asarray(g).astype(d), gs, dt)
        jtree, jst = jax_opt.update(jg, jst, jtree)
        ptree, pst = port_opt.update(to_port(gs, jtree), pst, ptree)
        out.append((ptree, pst, jtree, jst))
    return out


def _cast_like(gs, jtree):
    return jax.tree_util.tree_map(lambda g, p: np.asarray(jnp.asarray(g).astype(p.dtype)),
                                  gs, jtree)


def _small_to_port(gs, jtree):
    return {k: bridge._to_tensor(v, torch.device("cpu"))
            for k, v in to_numpy(_cast_like(gs, jtree)).items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_small_tree_matches_reference(name, dtype):
    """5 steps, clipping active (the gradients' norm is ~100x the clip)."""
    jdt = jnp.dtype(dtype)
    base = _small_tree(np.float32)
    jtree = {k: jnp.asarray(v).astype(jdt) for k, v in base.items()}
    ptree = {k: bridge._to_tensor(np.asarray(v), torch.device("cpu")) for k, v in jtree.items()}
    grads = [_grads_like(base, 10 + i, 30.0) for i in range(N_STEPS)]
    assert float(global_norm({k: torch.from_numpy(v) for k, v in grads[0].items()})) > 100
    port_opt, jax_opt = (AdamW(lr=1e-2), jax_optim.AdamW(lr=1e-2)) if name == "adamw" else \
        (Adafactor(lr=1e-2), jax_optim.Adafactor(lr=1e-2))
    for i, (pt, pst, jt, jst) in enumerate(_run_both(port_opt, jax_opt, jtree, ptree, grads,
                                                     _small_to_port)):
        assert all(pt[k].dtype == getattr(torch, dtype) for k in pt)
        _close(pt, jt, f"{name} {dtype} params after step {i + 1}")
        assert int(pst.step) == int(jst.step) == i + 1
        for field in pst._fields[1:]:
            _close(getattr(pst, field), getattr(jst, field), f"{name} {field} step {i + 1}")


class Forge125m:
    """The forge-125m smoke tree: the JAX package's stacked ``blocks``
    and the port's list of layers, from the same init."""

    def __init__(self, dtype):
        self.cfg = get_config("forge-125m", smoke=True).with_(dtype=dtype)
        self.jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype=dtype)
        self.jp = jax_params(self.jcfg)
        self.p = bridge.params_from_numpy(to_numpy(self.jp), device="cpu")

    def grads(self, seed):
        return _grads_like(to_numpy(self.jp), seed, 0.05)

    def to_port(self, gs, jtree):
        return bridge.params_from_numpy(to_numpy(_cast_like(gs, jtree)), device="cpu")


@pytest.fixture(scope="module", params=DTYPES)
def forge(request):
    return Forge125m(request.param)


def test_forge_tree_is_stacked_in_the_reference(forge):
    """The layouts the optimizers meet: (L, ...) leaves against a list."""
    L = forge.cfg.n_layers
    assert isinstance(forge.jp["blocks"], dict) and isinstance(forge.p["blocks"], list)
    assert forge.jp["blocks"]["norm1"]["scale"].shape == (L, forge.cfg.d_model)
    assert stacked_keys(forge.cfg) == ("blocks",)
    assert stacked_keys(get_config("recurrentgemma-2b", smoke=True)) == ()
    assert stacked_keys(get_config("seamless-m4t-large-v2", smoke=True)) == (
        "enc_blocks", "dec_blocks")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_forge_tree_matches_reference(forge, name):
    """5 steps on the reference's stacked layout against the port's list;
    the port's params bridged back to compare."""
    port_opt, jax_opt = (AdamW(), jax_optim.AdamW()) if name == "adamw" else \
        (Adafactor().for_config(forge.cfg), jax_optim.Adafactor())
    grads = [forge.grads(20 + i) for i in range(N_STEPS)]
    for i, (pt, pst, jt, jst) in enumerate(_run_both(port_opt, jax_opt, forge.jp, forge.p,
                                                     grads, forge.to_port)):
        assert isinstance(pt["blocks"], list)
        _close(pt, bridge.params_from_numpy(to_numpy(jt), device="cpu"),
               f"{name} {forge.cfg.dtype} params after step {i + 1}")
        want = (bridge.adamw_state_from_numpy if name == "adamw"
                else bridge.adafactor_state_from_numpy)(to_numpy(jst), device="cpu")
        for field in pst._fields:
            _close(getattr(pst, field), getattr(want, field),
                   f"{name} {field} after step {i + 1}")


def test_adafactor_per_layer_view_differs(forge):
    """Why the stacked view: updated leaf by leaf over the port's list,
    Adafactor leaves the (L, d) norm scales unfactored and clips each
    layer apart, which moves the params elsewhere than the reference."""
    grads = [forge.grads(40)]
    (pt, pst, jt, _), = _run_both(Adafactor(), jax_optim.Adafactor(), forge.jp,
                                  forge.p, grads, forge.to_port)
    assert pst.v["blocks"][0]["norm1"]["scale"].shape == (forge.cfg.d_model,)
    want = bridge.params_from_numpy(to_numpy(jt), device="cpu")
    assert any(not np.allclose(_np32(a), _np32(b), **TOL_OPT)
               for a, b in zip(pytree.tree_leaves(pt), pytree.tree_leaves(want)))


def test_adafactor_stacked_state_layout(forge):
    """The port's state keeps the reference's stacked layout: the norm
    scales factored over the layer axis, each weight's row stats (L, n)."""
    st = Adafactor().for_config(forge.cfg).init(forge.p)
    L, d = forge.cfg.n_layers, forge.cfg.d_model
    assert st.vr["blocks"]["norm1"]["scale"].shape == (L,)
    assert st.vc["blocks"]["norm1"]["scale"].shape == (d,)
    assert st.v["blocks"]["norm1"]["scale"].shape == ()
    assert st.vr["blocks"]["attn"]["wq"].shape == (L, d)


def test_bridge_states(forge):
    jst = jax_optim.AdamW().init(forge.jp)
    st = bridge.adamw_state_from_numpy(to_numpy(jst), device="cpu")
    assert isinstance(st, AdamWState) and isinstance(st.mu["blocks"], list)
    assert sorted(_by_path(st.mu)) == sorted(_by_path(AdamW().init(forge.p).mu))
    assert st.step.shape == ()
    ast = bridge.adafactor_state_from_numpy(to_numpy(jax_optim.Adafactor().init(forge.jp)),
                                            device="cpu")
    assert isinstance(ast, AdafactorState)
    want = Adafactor().for_config(forge.cfg).init(forge.p)
    for field in ("vr", "vc", "v"):
        got_f, want_f = _by_path(getattr(ast, field)), _by_path(getattr(want, field))
        assert {k: tuple(t.shape) for k, t in got_f.items()} == {
            k: tuple(t.shape) for k, t in want_f.items()}


# --------------------------------------------------------------------------
# the JAX package's substrate cases (tests/test_substrate.py), on the port
# --------------------------------------------------------------------------


class TestOptimizers:
    def _quad_problem(self, opt, steps=60):
        target = torch.tensor([1.0, -2.0, 3.0])
        params = {"w": torch.zeros(3), "m": torch.zeros(2, 3)}
        state = opt.init(params)

        def loss(p):
            return torch.sum((p["w"] - target) ** 2) + torch.sum(p["m"] ** 2)

        for _ in range(steps):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            grads = dict(zip(leaves, torch.autograd.grad(loss(leaves), list(leaves.values()))))
            params, state = opt.update(grads, state, params)
        return float(loss(params))

    def test_adamw_converges(self):
        assert self._quad_problem(AdamW(lr=0.1, weight_decay=0.0)) < 0.5

    def test_adafactor_converges(self):
        assert self._quad_problem(Adafactor(lr=0.3), steps=120) < 0.5

    def test_adafactor_states_factored(self):
        st = Adafactor().init({"w": torch.zeros(8, 16), "b": torch.zeros(16)})
        assert st.vr["w"].shape == (8,)
        assert st.vc["w"].shape == (16,)
        assert st.v["w"].shape == ()  # factored: unfactored slot empty
        assert st.v["b"].shape == (16,)  # 1-D: unfactored

    def test_grad_clip(self):
        opt = AdamW(lr=0.0, grad_clip=1.0)
        params = {"w": torch.zeros(4)}
        p2, _ = opt.update({"w": torch.full((4,), 1e6)}, opt.init(params), params)
        np.testing.assert_allclose(p2["w"].numpy(), 0.0)  # lr=0 -> unchanged

    def test_global_norm(self):
        t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
        assert float(global_norm(t)) == pytest.approx(5.0)

    def test_update_leaves_inputs_unwritten(self):
        """The update is out of place: params, grads and state survive."""
        params = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0))}
        for opt in (AdamW(), Adafactor()):
            st = opt.init(params)
            before = [t.clone() for t in pytree.tree_leaves((params, st))]
            opt.update({"w": torch.ones(4, 3)}, st, params)
            assert all(torch.equal(a, b)
                       for a, b in zip(before, pytree.tree_leaves((params, st))))


def test_get_optimizer():
    assert isinstance(get_optimizer("adamw", lr=0.5), AdamW)
    assert get_optimizer("adafactor", decay=0.5).decay == 0.5
    with pytest.raises(KeyError):
        get_optimizer("sgd")
