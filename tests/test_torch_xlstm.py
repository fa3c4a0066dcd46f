"""The port's RMSNorm kernel front and xLSTM model against the JAX package.

``ops.rms_norm`` (the plain version on the CPU) against the Pallas
``rms_norm_pallas`` in interpret mode and ``ops.rms_norm(impl="xla")``.
The xLSTM pieces: the chunk combine and the associative chunk scan, the
opaque ``forge_mlstm`` and sLSTM loop nodes (node lists and routes against
the JAX compiler's), and the xlstm smoke model (3 layers: mLSTM, mLSTM,
sLSTM; d 64, f32) with the JAX parameters carried over by the bridge:
``apply`` with and without Forge bodies, 12 decode steps, chunked prefill
with ragged lengths and from a non-zero state, NaN-inert and bitwise
frozen masked slots, and the server's greedy tokens.  Tolerance: f32
rtol 2e-4 / atol 2e-5 for logits, 1e-5 for states; bf16 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import ForgeCompiler as JaxForgeCompiler
from repro.core import PipelineConfig as JaxPipelineConfig
from repro.core.lowering import route_device as jax_route
from repro.kernels import ops as jax_ops
from repro.kernels.rms_norm import rms_norm_pallas
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.models import get_model as jax_get_model
from repro.models import xlstm as JX
from repro_torch.configs import get_config
from repro_torch.core import ForgeCompiler
from repro_torch.core.lowering import route_device
from repro_torch.core.shapekey import flatten_axes, infer_poly_axes
from repro_torch.kernels import _build, ops
from repro_torch.kernels import rms_norm as K
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import get_model
from repro_torch.models import xlstm as X

from torch_port_support import (
    TOL_BF16,
    TOL_F32,
    as_np,
    jax_params,
    port_params,
)

STATE_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flat(tree, pre=""):
    """{dotted key: leaf} of a nested dict (the two packages flatten dicts
    in different orders)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def _tree_close(got, want, tol=STATE_TOL):
    for g, w in zip(got["layers"], want["layers"]):
        g, w = _flat(g), _flat(w)
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(as_np(g[k]), as_np(w[k]), err_msg=k, **tol)


# --------------------------------------------------------------------------
# ops.rms_norm: the rms_norm_pallas front
# --------------------------------------------------------------------------

RMS_SHAPES = [(4, 64), (2, 16, 128), (3, 5, 37), (7, 1), (2, 3, 1000)]


def _xw(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.uniform(0.5, 1.5, shape[-1:]).astype(np.float32))


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rms_norm_matches_pallas_interpret_f32(shape):
    x, w = _xw(shape)
    got = ops.rms_norm(_t(x), _t(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(as_np(got), as_np(rms_norm_pallas(x, w, interpret=True)),
                               **TOL_F32)
    np.testing.assert_allclose(as_np(got), as_np(jax_ops.rms_norm(x, w, impl="xla")),
                               **TOL_F32)


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rms_norm_matches_pallas_interpret_bf16(shape):
    x, w = _xw(shape, seed=1)
    got = ops.rms_norm(_t(x).bfloat16(), _t(w), eps=1e-5)
    want = rms_norm_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), eps=1e-5,
                           interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_BF16)


def test_rms_norm_impl_ref_is_the_plain_version():
    x, w = _xw((3, 40), seed=2)
    got = ops.rms_norm(_t(x), _t(w), impl="ref")
    assert torch.equal(got, K.rms_norm_plain(_t(x), _t(w)))
    assert torch.equal(ops.rms_norm(_t(x), _t(w)), got)
    with pytest.raises(ValueError):
        ops.rms_norm(_t(x), _t(w), impl="pallas")


def test_rms_norm_captures_as_one_node():
    x, w = _xw((4, 16))

    class M(torch.nn.Module):
        def forward(self, x, w):
            return ops.rms_norm(x, w) + 1

    ep = torch.export.export(M(), (_t(x), _t(w)))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("repro_torch.rms_norm.default") == 1
    assert route_device("repro_torch.rms_norm.default") == "accel"


def test_rms_norm_built_and_refuses_cpu_tensors():
    assert "rms_norm" in _build.SOURCES
    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    x, w = _xw((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        K.rms_norm_cuda(_t(x), _t(w))


# --------------------------------------------------------------------------
# the mLSTM chunk combine and associative scan
# --------------------------------------------------------------------------


def _segment(rng, B=2, H=3, D=5):
    return (rng.normal(-1, 0.5, (B, H)).astype(np.float32),
            rng.normal(0, 1, (B, H)).astype(np.float32),
            rng.standard_normal((B, H, D, D)).astype(np.float32),
            rng.standard_normal((B, H, D)).astype(np.float32))


def test_chunk_combine_is_associative_and_matches_jax():
    rng = np.random.default_rng(3)
    e1, e2, e3 = (_segment(rng) for _ in range(3))
    t1, t2, t3 = (tuple(map(_t, e)) for e in (e1, e2, e3))
    left = X.mlstm_chunk_combine(X.mlstm_chunk_combine(t1, t2), t3)
    right = X.mlstm_chunk_combine(t1, X.mlstm_chunk_combine(t2, t3))
    want = JX.mlstm_chunk_combine(JX.mlstm_chunk_combine(e1, e2), e3)
    for a, b, w in zip(left, right, want):
        np.testing.assert_allclose(as_np(a), as_np(b), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(as_np(a), as_np(w), rtol=1e-5, atol=1e-6)


def _mlstm_inputs(S, seed, B=2, H=2, D=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))
    ig = rng.normal(0, 1, (B, H, S)).astype(np.float32)
    fg = rng.normal(2, 1, (B, H, S)).astype(np.float32)
    return q, k, v, ig, fg


def _cell(seed, B=2, H=2, D=8, fresh=False):
    if fresh:
        return {"C": np.zeros((B, H, D, D), np.float32), "n": np.zeros((B, H, D), np.float32),
                "m": np.full((B, H), -1e30, np.float32)}
    rng = np.random.default_rng(seed)
    return {"C": rng.standard_normal((B, H, D, D)).astype(np.float32),
            "n": rng.standard_normal((B, H, D)).astype(np.float32),
            "m": rng.normal(0, 1, (B, H)).astype(np.float32)}


@pytest.mark.parametrize("S", [1, 2, 7, 13, 32])
@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "carried"])
def test_chunk_scan_matches_jax(S, fresh):
    q, k, v, ig, fg = _mlstm_inputs(S, seed=S)
    cell = _cell(4, fresh=fresh)
    length = np.asarray([S, max(1, S // 2)], np.int32)
    h, c = X.mlstm_chunk_scan(*map(_t, (q, k, v, ig, fg)), {k_: _t(a) for k_, a in cell.items()},
                              _t(length))
    jh, jc = JX.mlstm_chunk_scan(q, k, v, ig, fg, cell, length)
    np.testing.assert_allclose(as_np(h), as_np(jh), **STATE_TOL)
    for key in cell:
        np.testing.assert_allclose(as_np(c[key]), as_np(jc[key]), err_msg=key, **STATE_TOL)


def test_chained_chunks_equal_one_scan_and_sequential_steps():
    S = 13
    q, k, v, ig, fg = map(_t, _mlstm_inputs(S, seed=5))
    full = torch.full((2,), S)
    st = {k_: _t(a) for k_, a in _cell(0, fresh=True).items()}
    h_all, c_all = X.mlstm_chunk_scan(q, k, v, ig, fg, st, full)
    parts, cell = [], st
    for lo, hi in ((0, 5), (5, 6), (6, 13)):
        h, cell = X.mlstm_chunk_scan(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                                     ig[:, :, lo:hi], fg[:, :, lo:hi], cell,
                                     torch.full((2,), hi - lo))
        parts.append(h)
    np.testing.assert_allclose(as_np(torch.cat(parts, 2)), as_np(h_all), **STATE_TOL)
    seq, cell_s = [], st
    for t in range(S):
        h, cell_s = X.mlstm_recurrent_step(q[:, :, t], k[:, :, t], v[:, :, t], ig[:, :, t],
                                           fg[:, :, t], cell_s)
        seq.append(h)
    np.testing.assert_allclose(as_np(torch.stack(seq, 2)), as_np(h_all), **STATE_TOL)
    for key in c_all:
        np.testing.assert_allclose(as_np(cell[key]), as_np(c_all[key]), **STATE_TOL)
        np.testing.assert_allclose(as_np(cell_s[key]), as_np(c_all[key]), **STATE_TOL)


def test_fresh_cell_carry_weight_underflows_to_zero():
    """m0 = -1e30: exp(F + m0 - m_t) is exactly 0, so the first chunk
    token reproduces the first decode step bitwise."""
    q, k, v, ig, fg = map(_t, _mlstm_inputs(1, seed=6))
    st = {k_: _t(a) for k_, a in _cell(0, fresh=True).items()}
    h, c = X.mlstm_chunk_scan(q, k, v, ig, fg, st, torch.ones(2, dtype=torch.long))
    hs, cs = X.mlstm_recurrent_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], ig[:, :, 0],
                                    fg[:, :, 0], st)
    assert torch.equal(c["m"], cs["m"]) and torch.equal(c["C"], cs["C"])
    np.testing.assert_allclose(as_np(h[:, :, 0]), as_np(hs), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# the xlstm smoke model against the JAX package's
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32():
    cfg = get_config("xlstm-350m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("xlstm-350m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


@pytest.fixture(scope="module")
def jax_steps(f32):
    """The JAX model's decode and prefill steps, jitted once."""
    _, jcfg, _, _ = f32
    jm = jax_get_model(jcfg)
    decode = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, 0, jcfg))
    prefill = jax.jit(lambda p, c, t, n: jm.prefill_step(p, c, t, 0, jcfg, length=n))
    return decode, prefill


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def test_bridge_carries_the_xlstm_parameters(f32):
    cfg, _, jp, p = f32
    assert X._kinds(cfg) == ("mlstm", "mlstm", "slstm")
    assert [set(b) for b in p["blocks"]] == [set(b) for b in jp["blocks"]]
    sl = p["blocks"][2]
    assert sl["r"].dtype == torch.float32 and tuple(sl["r"].shape) == (4, 16, 64)
    assert tuple(p["blocks"][0]["conv"].shape) == (4, 128)
    assert p["embed"] is not None and "lm_head" not in p
    for got, want in zip(p["blocks"], jp["blocks"]):
        for k, v in got.items():
            w = want[k]["scale"] if isinstance(v, dict) else want[k]
            v = v["scale"] if isinstance(v, dict) else v
            np.testing.assert_array_equal(as_np(v), as_np(w))
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


def _opaque(nodes, port):
    """Sorted (JAX op name, route) of a graph's opaque and fused nodes."""
    out = []
    for n in nodes:
        op = n.op
        if port:
            if op.startswith("repro_torch.forge_"):
                op = "forge." + op[len("repro_torch.forge_"):].rsplit(".", 1)[0]
            elif op.startswith("forge_scan."):
                op = "scan"
            elif not op.startswith("forge."):
                continue
            route = route_device(n.op)
        else:
            if not (op.startswith("forge.") or op in ("scan", "while", "cond")):
                continue
            route = jax_route(op)
        out.append((op, route, n.params.get("act"), n.params.get("has_bias"),
                    n.params.get("has_residual")))
    return sorted(out, key=repr)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_apply_bodies_opaque_nodes_match_jax(f32, kind):
    """One Forge body per block kind: the forge_mlstm node (accel) or the
    sLSTM loop node (host, as JAX routes ``scan``), and the operator
    fusion's linear nodes, as the JAX compiler's."""
    cfg, jcfg, jp, p = f32
    i = X._kinds(cfg).index(kind)
    x = np.random.default_rng(7).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    raw = X.slstm_block_apply if kind == "slstm" else X.mlstm_block_apply
    jraw = JX.slstm_block_apply if kind == "slstm" else JX.mlstm_block_apply
    mod = ForgeCompiler().compile(lambda q, x_: raw(q, x_, cfg), p["blocks"][i], _t(x))
    jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(
        lambda q, x_: jraw(q, x_, jcfg), jp["blocks"][i], jnp.asarray(x))
    got = _opaque(mod.graph.nodes.values(), port=True)
    assert got == _opaque(jmod.graph.nodes.values(), port=False)
    want_core = ("scan", "host") if kind == "slstm" else ("forge.mlstm", "accel")
    assert [g[:2] for g in got if not g[0].startswith("forge.linear")] == [want_core]
    np.testing.assert_allclose(as_np(mod(p["blocks"][i], _t(x))),
                               as_np(jraw(jp["blocks"][i], jnp.asarray(x), jcfg)), **TOL_F32)


def test_prefill_program_loop_nodes_match_jax(f32):
    """The whole prefill step captured: one sLSTM loop node per sLSTM
    layer, routed to the host, as the JAX capture's ``scan`` nodes; the
    mLSTM scan inlines (static slices) in both."""
    cfg, jcfg, jp, p = f32
    m, jm = get_model(cfg), jax_get_model(jcfg)
    toks = _tokens(2, 6, 8)
    n = np.asarray([6, 4], np.int32)
    mod = ForgeCompiler().compile(
        lambda q, c, t, ln: m.prefill_step(q, c, t, 0, cfg, length=ln),
        p, m.init_cache(cfg, 2, 32, device="cpu"), _t(toks), _t(n))
    jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(
        lambda q, c, t, ln: jm.prefill_step(q, c, t, 0, jcfg, length=ln),
        jp, jm.init_cache(jcfg, 2, 32), jnp.asarray(toks), jnp.asarray(n))
    loops = [g for g in _opaque(mod.graph.nodes.values(), port=True) if g[0] == "scan"]
    jloops = [g for g in _opaque(jmod.graph.nodes.values(), port=False) if g[0] == "scan"]
    assert loops == jloops == [("scan", "host", None, None, None)]
    logits, _ = mod(p, m.init_cache(cfg, 2, 32, device="cpu"), _t(toks), _t(n))
    jlogits, _ = jm.prefill_step(jp, jm.init_cache(jcfg, 2, 32), jnp.asarray(toks), 0, jcfg,
                                 length=jnp.asarray(n))
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL_F32)


def _sequential(setup, toks, cache=None):
    """Decode ``toks`` step by step in the port; returns the per-step
    logits (B, S, vocab) and the final cache."""
    cfg, _, _, p = setup
    m = get_model(cfg)
    tc = m.init_cache(cfg, toks.shape[0], 32, device="cpu") if cache is None else cache
    tl = []
    for t in range(toks.shape[1]):
        lg, tc = m.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, cfg)
        tl.append(lg[:, -1])
    return torch.stack(tl, 1), tc


def test_twelve_decode_steps(f32, jax_steps):
    cfg, jcfg, jp, p = f32
    toks = _tokens(2, 12, 2)
    tl, tc = _sequential(f32, toks)
    jc, jl = jax_get_model(jcfg).init_cache(jcfg, 2, 32), []
    for t in range(12):
        lg, jc = jax_steps[0](jp, jc, jnp.asarray(toks[:, t:t + 1]))
        jl.append(lg[:, -1])
    np.testing.assert_allclose(as_np(tl), as_np(jnp.stack(jl, 1)), **TOL_F32)
    _tree_close(tc, jc)


def test_prefill_ragged_lengths(f32, jax_steps):
    cfg, jcfg, jp, p = f32
    m, jm = get_model(cfg), jax_get_model(jcfg)
    toks = _tokens(2, 13, 4)
    n = np.asarray([5, 13], np.int32)
    tl, tc = m.prefill_step(p, m.init_cache(cfg, 2, 32, device="cpu"),
                            torch.from_numpy(toks).long(), torch.zeros(2, dtype=torch.int32),
                            cfg, length=torch.from_numpy(n))
    jl, jc = jax_steps[1](jp, jm.init_cache(jcfg, 2, 32), jnp.asarray(toks), jnp.asarray(n))
    np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL_F32)
    _tree_close(tc, jc)
    # each row's state is its OWN length-step sequential state
    for row, L_ in enumerate(n):
        _, sc = _sequential(f32, toks[:, :L_])
        for g, w in zip(tc["layers"], sc["layers"]):
            g, w = _flat(g), _flat(w)
            for k in g:
                np.testing.assert_allclose(as_np(g[k])[row], as_np(w[k])[row], err_msg=k,
                                           **STATE_TOL)


def test_prefill_continues_from_a_nonzero_state(f32, jax_steps):
    """A second chunk prefilled on the state a first chunk left: equal to
    decoding both token by token, and to the JAX package's chunked
    prefill."""
    cfg, jcfg, jp, p = f32
    m, jm = get_model(cfg), jax_get_model(jcfg)
    p1, p2 = _tokens(2, 6, 5), _tokens(2, 9, 6)
    n2 = np.asarray([9, 4], np.int32)
    tc = m.init_cache(cfg, 2, 32, device="cpu")
    _, tc = m.prefill_step(p, tc, torch.from_numpy(p1).long(), 0, cfg)
    tl, tc = m.prefill_step(p, tc, torch.from_numpy(p2).long(), 6, cfg,
                            length=torch.from_numpy(n2))
    jc = jm.init_cache(jcfg, 2, 32)
    _, jc = jax_steps[1](jp, jc, jnp.asarray(p1), jnp.full((2,), 6, jnp.int32))
    jl, jc = jax_steps[1](jp, jc, jnp.asarray(p2), jnp.asarray(n2))
    np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL_F32)
    _tree_close(tc, jc)
    tl_s, _ = _sequential(f32, np.concatenate([p1, p2], 1))
    np.testing.assert_allclose(as_np(tl[0]), as_np(tl_s[0, 6:]), **STATE_TOL)


def test_masked_slots_nan_inert_and_frozen(f32):
    cfg, _, _, p = f32
    m = get_model(cfg)
    toks = _tokens(3, 9, 7)
    tl_s, _ = _sequential(f32, toks)
    cache = m.init_cache(cfg, 3, 32, device="cpu")
    rng = np.random.default_rng(8)
    for st in cache["layers"]:
        for k, v in _flat(st).items():
            v[0] = float("nan")  # row 0: NaN; row 2: arbitrary finite state
            v[2] = _t(rng.standard_normal(v[2].shape).astype(np.float32)).to(v.dtype)
    before = [{k: v.clone() for k, v in _flat(st).items()} for st in cache["layers"]]
    mask = torch.tensor([False, True, False])
    logits, new = m.prefill_step(p, cache, torch.from_numpy(toks).long(), 0, cfg,
                                 slot_mask=mask)
    _, new_d = m.decode_step(p, new, torch.from_numpy(toks[:, :1]).long(), 9, cfg,
                             slot_mask=mask)
    for tree in (new, new_d):
        for i, st in enumerate(tree["layers"]):
            for k, v in _flat(st).items():
                assert torch.isnan(v[0]).all(), k
                assert torch.equal(v[2], before[i][k][2]), k
    assert torch.isfinite(logits[1]).all()
    np.testing.assert_allclose(as_np(logits[1]), as_np(tl_s[1]), **STATE_TOL)


def test_cache_axes_inferred_on_meta(f32):
    cfg, _, _, _ = f32
    m = get_model(cfg)
    axes = infer_poly_axes(lambda b: m.init_cache(cfg, b, 32, device="meta"))
    mlstm = {"conv": 0, "cell": {"C": 0, "n": 0, "m": 0}}
    assert axes == {"layers": [mlstm, mlstm, {"c": 0, "n": 0, "h": 0, "m": 0}]}
    cache = m.init_cache(cfg, 3, 32, device="cpu")
    assert flatten_axes(axes, cache) == [0] * 12
    ptrs = [v.data_ptr() for st in cache["layers"] for v in _flat(st).values()]
    assert len(set(ptrs)) == len(ptrs)  # every leaf its own buffer
    assert (cache["layers"][0]["cell"]["m"] == -1e30).all()


def test_server_tokens_equal_jax_forge_and_jit_servers(f32):
    cfg, jcfg, jp, p = f32
    prompts = _tokens(3, 6, 0)
    got = BatchedServer(cfg, p, max_len=32, mode="forge").generate(prompts, 4)
    assert got["prefill_mode"] == "chunked"
    forge = JaxBatchedServer(jcfg, jp, max_len=32, mode="forge",
                             backend="interpret").generate(prompts, 4)
    assert forge["prefill_mode"] == "chunked"
    np.testing.assert_array_equal(got["tokens"], np.asarray(forge["tokens"]))
    jit = JaxBatchedServer(jcfg, jp, max_len=32, mode="jit").generate(prompts, 4)
    np.testing.assert_array_equal(got["tokens"], np.asarray(jit["tokens"]))
