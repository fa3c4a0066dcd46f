"""The port's RG-LRU scan and recurrentgemma hybrid against the JAX package.

The plain scan (``kernels/ref.py``) and its fronts (``ops.rg_lru``,
``ops.rg_lru_scan``) against the JAX ``rg_lru_ref`` / ``rg_lru_chunk_ref``
oracles and the Pallas kernels run in interpret mode; gradients against
``jax.vjp``.  The recurrentgemma smoke model (3 layers, d 64, window 8,
f32) with the JAX parameters carried over by the bridge: ``apply``
(``fuse="none"`` and the Forge bodies), sequential decode, chunked
prefill with ragged lengths, a start position past the window and
NaN-inert masked slots (the JAX package's tests/test_recurrent_prefill.py
contract).  Tolerance: f32 rtol 2e-4 / atol 2e-5; cache states within
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import rg_lru_chunk_ref as jax_chunk_ref
from repro.kernels.ref import rg_lru_ref as jax_rg_lru_ref
from repro.kernels.rg_lru import rg_lru_chunked as jax_rg_lru_chunked
from repro.kernels.rg_lru import rg_lru_pallas
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.core.shapekey import flatten_axes, infer_poly_axes
from repro_torch.kernels import ops
from repro_torch.kernels import rg_lru as K
from repro_torch.models import get_model
from repro_torch.models import layers as L

from torch_port_support import TOL_F32, as_np, jax_params, port_params

STATE_TOL = dict(rtol=1e-5, atol=1e-5)


def _xa(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(0.3, 0.999, shape).astype(np.float32)
    return x, a


def _h0(B, D, seed=9):
    return np.random.default_rng(seed).standard_normal((B, D)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------
# the scan: plain version and fronts against the JAX oracles and kernels
# --------------------------------------------------------------------------

SHAPES = [(2, 13, 8), (3, 37, 5), (1, 64, 16), (2, 1, 4), (2, 100, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_none", "h0"])
def test_rg_lru_matches_jax_oracle(shape, with_h0):
    x, a = _xa(shape)
    h0 = _h0(shape[0], shape[2]) if with_h0 else None
    got = ops.rg_lru(_t(x), _t(a), None if h0 is None else _t(h0))
    want = jax.jit(jax_rg_lru_ref)(jnp.asarray(x), jnp.asarray(a),
                                   None if h0 is None else jnp.asarray(h0))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_none", "h0"])
def test_rg_lru_matches_pallas_interpret(shape, with_h0):
    x, a = _xa(shape)
    h0 = _h0(shape[0], shape[2]) if with_h0 else None
    got = ops.rg_lru(_t(x), _t(a), None if h0 is None else _t(h0))
    want = rg_lru_pallas(jnp.asarray(x), jnp.asarray(a),
                         None if h0 is None else jnp.asarray(h0), interpret=True)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_rg_lru_scan_matches_chunked_oracle_and_pallas(shape):
    x, a = _xa(shape, seed=1)
    h0 = _h0(shape[0], shape[2])
    h, last = ops.rg_lru_scan(_t(x), _t(a), _t(h0))
    jh, jlast = jax_chunk_ref(jnp.asarray(x), jnp.asarray(a), jnp.asarray(h0))
    ph, plast = jax_rg_lru_chunked(jnp.asarray(x), jnp.asarray(a), jnp.asarray(h0),
                                   interpret=True)
    assert torch.equal(last, h[:, -1])
    for g, w in ((h, jh), (last, jlast), (h, ph), (last, plast)):
        np.testing.assert_allclose(as_np(g), as_np(w), **TOL_F32)


def test_rg_lru_matches_sequential_loop():
    x, a = _xa((2, 29, 6), seed=2)
    h0 = _h0(2, 6)
    h = torch.from_numpy(h0)
    seq = []
    for t in range(29):
        h = _t(a)[:, t] * h + _t(x)[:, t]
        seq.append(h)
    got = ops.rg_lru(_t(x), _t(a), _t(h0))
    np.testing.assert_allclose(got.numpy(), torch.stack(seq, 1).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cuts", [(8, 16, 24), (5, 11, 30)], ids=["even", "ragged"])
def test_four_chained_chunks_equal_one_scan(cuts):
    x, a = _xa((2, 37, 7), seed=3)
    h0 = _t(_h0(2, 7))
    full = ops.rg_lru(_t(x), _t(a), h0)
    bounds = (0,) + cuts + (37,)
    carry, parts = h0, []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        h, carry = ops.rg_lru_scan(_t(x[:, lo:hi]), _t(a[:, lo:hi]), carry)
        parts.append(h)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(), rtol=1e-5, atol=1e-6)


def test_impl_ref_is_the_plain_version():
    x, a = _xa((2, 9, 4))
    h0 = _t(_h0(2, 4))
    assert torch.equal(ops.rg_lru(_t(x), _t(a), h0, impl="ref"),
                       K.rg_lru_plain(_t(x), _t(a), h0))
    h, last = ops.rg_lru_scan(_t(x), _t(a), h0, impl="ref")
    assert torch.equal(last, h[:, -1])
    with pytest.raises(ValueError):
        ops.rg_lru(_t(x), _t(a), h0, impl="pallas")


def test_bf16_inputs_keep_dtype():
    x, a = _xa((2, 11, 4))
    xb, ab = _t(x).bfloat16(), _t(a).bfloat16()
    h, last = ops.rg_lru_scan(xb, ab)
    assert h.dtype == torch.bfloat16 and last.dtype == torch.bfloat16
    want = ops.rg_lru(xb.float(), ab.float())
    np.testing.assert_allclose(as_np(h), as_np(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("front", ["rg_lru", "rg_lru_scan"])
def test_gradients_match_jax_vjp(front):
    x, a = _xa((2, 13, 5), seed=4)
    h0 = _h0(2, 5)
    g = np.random.default_rng(5).standard_normal((2, 13, 5)).astype(np.float32)
    gl = np.random.default_rng(6).standard_normal((2, 5)).astype(np.float32)
    tx, ta, th = (_t(v).clone().requires_grad_(True) for v in (x, a, h0))
    if front == "rg_lru":
        (ops.rg_lru(tx, ta, th) * _t(g)).sum().backward()
        _, vjp = jax.vjp(jax_rg_lru_ref, jnp.asarray(x), jnp.asarray(a), jnp.asarray(h0))
        want = vjp(jnp.asarray(g))
    else:
        h, last = ops.rg_lru_scan(tx, ta, th)
        ((h * _t(g)).sum() + (last * _t(gl)).sum()).backward()
        _, vjp = jax.vjp(jax_chunk_ref, jnp.asarray(x), jnp.asarray(a), jnp.asarray(h0))
        want = vjp((jnp.asarray(g), jnp.asarray(gl)))
    for got, w in zip((tx.grad, ta.grad, th.grad), want):
        np.testing.assert_allclose(as_np(got), as_np(w), rtol=1e-4, atol=1e-5)


def test_custom_ops_capture_as_one_node():
    x, a = _xa((2, 6, 4))

    class M(torch.nn.Module):
        def forward(self, x, a, h0):
            return ops.rg_lru(x, a, h0), ops.rg_lru_scan(x, a, h0)

    ep = torch.export.export(M(), (_t(x), _t(a), torch.zeros(2, 4)))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert "repro_torch.rg_lru.default" in targets
    assert "repro_torch.rg_lru_chunked.default" in targets


def test_build_lists_every_kernel_source():
    from repro_torch.kernels import _build

    assert "rg_lru" in _build.SOURCES
    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))


def test_cuda_wrapper_refuses_cpu_tensors():
    x, a = _xa((1, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        K.rg_lru_cuda(_t(x), _t(a), torch.zeros(1, 2))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pos", [[0, 3], [5, 13], [20, 7]], ids=str)
def test_window_masks_and_writeback_match_jax(pos):
    p = np.asarray(pos, np.int32)
    n = np.asarray([5, 9], np.int32)
    got = L.window_chunk_mask(_t(p), 9, 8, 8)
    want = JL.window_chunk_mask(jnp.asarray(p), 9, 8, 8)
    np.testing.assert_array_equal(as_np(got), as_np(want))
    gi, gv = L.window_writeback_index(_t(p), _t(n), 9, 8, 8)
    wi, wv = JL.window_writeback_index(jnp.asarray(p), jnp.asarray(n), 9, 8, 8)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_state_gathers_match_jax():
    rng = np.random.default_rng(7)
    state = rng.standard_normal((2, 3, 4)).astype(np.float32)
    seq = rng.standard_normal((2, 6, 4)).astype(np.float32)
    n = np.asarray([2, 6], np.int32)
    np.testing.assert_array_equal(
        L.conv_state_slice(_t(state), _t(seq), _t(n)).numpy(),
        np.asarray(JL.conv_state_slice(jnp.asarray(state), jnp.asarray(seq), jnp.asarray(n))))
    np.testing.assert_array_equal(
        L.gather_last_valid(_t(seq), _t(n)).numpy(),
        np.asarray(JL.gather_last_valid(jnp.asarray(seq), jnp.asarray(n))))
    s = rng.standard_normal((2, 1, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        L.local_causal_where(_t(s), 5, 7, 3).numpy(),
        np.asarray(JL.local_causal_where(jnp.asarray(s), 5, 7, 3)))


def test_slot_gate_selects_over_a_state_tree():
    new = {"h": torch.full((3, 2), float("nan")), "conv": torch.ones(3, 2, 2)}
    old = {"h": torch.zeros(3, 2), "conv": torch.full((3, 2, 2), float("nan"))}
    out = L.slot_gate(torch.tensor([False, True, False]), new, old)
    assert torch.equal(out["h"][[0, 2]], old["h"][[0, 2]])
    assert torch.isnan(out["h"][1]).all() and torch.equal(out["conv"][1], new["conv"][1])
    assert torch.isnan(out["conv"][[0, 2]]).all()  # kept bitwise, NaN included


# --------------------------------------------------------------------------
# the recurrentgemma smoke model against the JAX package's
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32():
    cfg = get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


@pytest.fixture(scope="module")
def jax_steps(f32):
    """The JAX model's decode and prefill steps, jitted once (the eager
    JAX ops are the slow side of these tests)."""
    _, jcfg, _, _ = f32
    jm = jax_get_model(jcfg)
    decode = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, jcfg))
    prefill = jax.jit(lambda p, c, t, pos, n: jm.prefill_step(p, c, t, pos, jcfg, length=n))
    return decode, prefill


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _tree_close(got, want, tol=STATE_TOL):
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(as_np(g[k]), as_np(w[k]), err_msg=k, **tol)


def test_bridge_carries_the_hybrid_parameters(f32):
    cfg, _, jp, p = f32
    assert len(p["blocks"]) == 3 and "k" not in p["blocks"][0]
    rec, attn = p["blocks"][0], p["blocks"][2]
    assert rec["lam"].dtype == torch.float32 and tuple(rec["conv"].shape) == (4, 64)
    assert set(rec) == set(jp["blocks"][0]) and set(attn) == set(jp["blocks"][2])
    fresh = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    for got, want in zip(fresh["blocks"], p["blocks"]):
        assert ({k: tuple(v.shape) for k, v in got.items() if torch.is_tensor(v)}
                == {k: tuple(v.shape) for k, v in want.items() if torch.is_tensor(v)})


@pytest.mark.parametrize("fuse", ["none", "forge"])
def test_apply_logits(f32, fuse):
    cfg, jcfg, jp, p = f32
    toks = _tokens(2, 12, 0)
    c = cfg.with_(fuse=fuse)
    got = get_model(c).apply(p, torch.from_numpy(toks).long(), c)
    want = jax_get_model(jcfg).apply(jp, jnp.asarray(toks), jcfg.with_(fuse="none"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 512)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)


def test_apply_forge_bodies_fuse_the_scan(f32):
    from repro_torch.models import _forge

    cfg, _, _, p = f32
    get_model(cfg).apply(p, torch.from_numpy(_tokens(2, 5, 1)).long(), cfg)
    bodies = [r for key, r in zip(_forge._CACHE, _forge.compiled_bodies())
              if f"{cfg!r}/rec" in key]
    assert bodies, "no Forge-compiled rec body"
    assert all(any(n.op == "repro_torch.rg_lru.default" for n in
                   _forge._CACHE[k].graph.nodes.values())
               for k in _forge._CACHE if f"{cfg!r}/rec" in k)


def _sequential(setup, toks, pos0=0, B=2, max_len=32, cache=None):
    """Decode ``toks`` step by step in the port; returns the per-step
    logits (B, S, vocab) and the final cache."""
    cfg, _, _, p = setup
    m = get_model(cfg)
    tc = m.init_cache(cfg, B, max_len, device="cpu") if cache is None else cache
    tl = []
    for t in range(toks.shape[1]):
        pos = torch.full((B,), pos0 + t, dtype=torch.int32)
        lg, tc = m.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]).long(), pos, cfg)
        tl.append(lg[:, -1])
    return torch.stack(tl, 1), tc


def test_twelve_decode_steps(f32, jax_steps):
    cfg, jcfg, jp, p = f32
    decode, _ = jax_steps
    toks = _tokens(2, 12, 2)
    tl, tc = _sequential(f32, toks)
    jc, jl = jax_get_model(jcfg).init_cache(jcfg, 2, 32), []
    for t in range(12):
        lg, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.full((2,), t, jnp.int32))
        jl.append(lg[:, -1])
    np.testing.assert_allclose(as_np(tl), as_np(jnp.stack(jl, 1)), **TOL_F32)
    _tree_close(tc, jc)


def test_scalar_position_decode(f32, jax_steps):
    cfg, jcfg, jp, p = f32
    m, jm = get_model(cfg), jax_get_model(jcfg)
    toks = _tokens(2, 10, 3)
    tc, jc = m.init_cache(cfg, 2, 16, device="cpu"), jm.init_cache(jcfg, 2, 16)
    for t in range(10):  # scalar pos, rotating the 8-slot window
        lg, tc = m.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, cfg)
        jg, jc = jax_steps[0](jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        np.testing.assert_allclose(as_np(lg), as_np(jg), **TOL_F32)
    _tree_close(tc, jc)


def test_prefill_ragged_lengths(f32, jax_steps):
    cfg, jcfg, jp, p = f32
    m, jm = get_model(cfg), jax_get_model(jcfg)
    toks = _tokens(2, 13, 4)
    n = np.asarray([5, 13], np.int32)
    tl, tc = m.prefill_step(p, m.init_cache(cfg, 2, 32, device="cpu"),
                            torch.from_numpy(toks).long(), torch.zeros(2, dtype=torch.int32),
                            cfg, length=torch.from_numpy(n))
    jl, jc = jax_steps[1](jp, jm.init_cache(jcfg, 2, 32), jnp.asarray(toks),
                          jnp.zeros((2,), jnp.int32), jnp.asarray(n))
    np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL_F32)
    _tree_close(tc, jc)
    # each row's state is its OWN length-step sequential state
    for row, L_ in enumerate(n):
        _, sc = _sequential(f32, toks[:, :L_])
        for g, w in zip(tc["layers"], sc["layers"]):
            for k in g:
                np.testing.assert_allclose(as_np(g[k])[row], as_np(w[k])[row], **STATE_TOL)


def test_prefill_past_the_window(f32, jax_steps):
    """A second segment prefilled at pos 6, long enough that the 8-slot
    window wraps: equal to decoding it token by token, and to the JAX
    package's chunked prefill."""
    cfg, jcfg, jp, p = f32
    m, jm = get_model(cfg), jax_get_model(jcfg)
    p1, p2 = _tokens(2, 6, 5), _tokens(2, 13, 6)
    _, tc_s = _sequential(f32, p1, max_len=64)
    tl_s, tc_s = _sequential(f32, p2, pos0=6, max_len=64, cache=tc_s)
    tc = m.init_cache(cfg, 2, 64, device="cpu")
    _, tc = m.prefill_step(p, tc, torch.from_numpy(p1).long(),
                           torch.zeros(2, dtype=torch.int32), cfg)
    tl, tc = m.prefill_step(p, tc, torch.from_numpy(p2).long(),
                            torch.full((2,), 6, dtype=torch.int32), cfg)
    np.testing.assert_allclose(as_np(tl), as_np(tl_s), **STATE_TOL)
    _tree_close(tc, tc_s)
    jc = jm.init_cache(jcfg, 2, 64)
    _, jc = jax_steps[1](jp, jc, jnp.asarray(p1), jnp.zeros((2,), jnp.int32),
                         jnp.full((2,), 6, jnp.int32))
    jl, jc = jax_steps[1](jp, jc, jnp.asarray(p2), jnp.full((2,), 6, jnp.int32),
                          jnp.full((2,), 13, jnp.int32))
    np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL_F32)
    _tree_close(tc, jc)


def test_masked_slots_nan_inert(f32):
    cfg, _, _, p = f32
    m = get_model(cfg)
    toks = _tokens(2, 9, 7)
    tl_s, _ = _sequential(f32, toks)
    cache = m.init_cache(cfg, 2, 32, device="cpu")
    for st in cache["layers"]:
        for v in st.values():
            v[0] = float("nan")
    before = {(i, k): v.clone() for i, st in enumerate(cache["layers"]) for k, v in st.items()}
    logits, new = m.prefill_step(p, cache, torch.from_numpy(toks).long(),
                                 torch.zeros(2, dtype=torch.int32), cfg,
                                 slot_mask=torch.tensor([False, True]))
    for i, st in enumerate(new["layers"]):
        for k, v in st.items():
            assert torch.isnan(v[0]).all() and torch.isnan(before[(i, k)][0]).all()
    assert torch.isfinite(logits[1]).all()
    np.testing.assert_allclose(as_np(logits[1]), as_np(tl_s[1]), **STATE_TOL)


def test_cache_axes_inferred_on_meta(f32):
    cfg, _, _, _ = f32
    m = get_model(cfg)
    axes = infer_poly_axes(lambda b: m.init_cache(cfg, b, 32, device="meta"))
    assert axes == {"layers": [{"h": 0, "conv": 0}, {"h": 0, "conv": 0}, {"k": 0, "v": 0}]}
    cache = m.init_cache(cfg, 3, 32, device="cpu")
    assert flatten_axes(axes, cache) == [0] * 6
    with pytest.raises(ValueError, match="cannot infer"):
        infer_poly_axes(lambda b: torch.zeros((b, b), device="meta"))
