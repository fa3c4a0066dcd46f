"""The port's Phase-2 passes that complete the paper's pipeline: constant
folding, device constants and layout, on small exported ATen graphs, and
the pipeline's configuration (α, λ, pass enables, the unscheduled build).

Each rewrite is checked with its detail counter, its idempotence (a
second run modifies nothing) and the outputs, which must not change.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core import (ForgeCompiler, PipelineConfig, default_passes, forge_compile,
                              lower_to_rgir, trace_to_graph)
from repro_torch.core.executor import CompiledExecutor, analyze_program
from repro_torch.core.graph import Aval, Graph, Ref
from repro_torch.core.passes import (AttentionFusionPass, ConstantFoldingPass,
                                     DeviceConstantPass, HOPPER_PREFERRED_TILES,
                                     LayoutOptimizationPass, OperatorFusionPass,
                                     run_forge_passes)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from conftest import make_block_args
from test_torch_compiler import torch_block


def _graph(fn, *args):
    return trace_to_graph(fn, *args).graph


def _run(g, *args):
    return CompiledExecutor(analyze_program(lower_to_rgir(g))).execute(*args)


def _ops(g):
    return [n.op for n in g.nodes.values()]


def _once_then_fixed(p, g):
    """Run ``p`` twice: the first run modifies the graph, the second not."""
    assert p.run(g)
    first = dict(p.last_detail)
    assert not p.run(g), f"{p.name} not idempotent: {p.last_detail}"
    return first


# --------------------------------------------------------------------------
# constant folding
# --------------------------------------------------------------------------


class TestConstantFolding:
    def test_literal_evaluation(self):
        def f(x):
            table = torch.arange(6, dtype=torch.float32) * 0.5 + 1.0
            return x * table

        x = torch.randn(2, 6)
        g = _graph(f, x)
        d = _once_then_fixed(ConstantFoldingPass(), g)
        assert d["folded"] == 3 and _ops(g) == ["aten.mul.Tensor"]
        assert len(g.constvars) >= 1
        (got,) = _run(g, x)
        assert torch.equal(got, f(x))

    def test_causal_mask_folds_and_fuses_as_causal(self):
        """The row >= col mask folds to a boolean constant; attention
        fusion still reads it as the kernel's causal mode."""
        def f(q, k, v):
            s = torch.matmul(q, k.transpose(-2, -1)) * 0.5
            s = L.causal_where(s, 6, 6)
            return torch.matmul(torch.softmax(s, -1), v)

        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, 2, 6, 4, generator=g) for _ in range(3))
        mod = forge_compile(f, q, k, v)
        rows = {r["pass"]: r for r in mod.result.pass_table()}
        assert rows["constant_folding"]["detail"]["folded"] >= 4
        (sdpa,) = [n for n in mod.graph.nodes.values() if n.is_fused]
        assert sdpa.params["causal"] and not sdpa.params["has_mask"]
        np.testing.assert_allclose(mod(q, k, v).numpy(), f(q, k, v).numpy(), rtol=1e-5,
                                   atol=1e-6)

    @pytest.mark.parametrize("expr,n", [
        (lambda x: ((x + 0) * 1).exp(), 2),
        (lambda x: ((x - 0.0) / 1.0).exp(), 2),
        (lambda x: (0 + x) ** 1 * 2, 2),
    ])
    def test_identities(self, expr, n):
        x = torch.randn(3, 4)
        g = _graph(expr, x)
        d = _once_then_fixed(ConstantFoldingPass(), g)
        assert d["identities"] == n
        (got,) = _run(g, x)
        assert torch.equal(got, expr(x))

    def test_identity_that_changes_dtype_stays(self):
        x = torch.arange(6).view(2, 3)
        g = _graph(lambda x: (x * 1.0) + 1, x)
        assert ConstantFoldingPass().run(g) is False
        assert "aten.mul.Tensor" in _ops(g)

    def test_output_never_aliases_an_input(self):
        x = torch.randn(3)
        g = _graph(lambda x: x * 1, x)
        assert not ConstantFoldingPass().run(g)
        (got,) = _run(g, x)
        assert got.data_ptr() != x.data_ptr()

    def test_parameter_is_never_read(self):
        """A weight is a graph input: the ops on it stay, and a new weight
        changes the output of the compiled program."""
        def f(w, x):
            return x @ (w * 2.0 + 1.0)

        w, x = torch.randn(4, 4), torch.randn(2, 4)
        g = _graph(f, w, x)
        assert not ConstantFoldingPass().run(g)
        w2 = torch.randn(4, 4)
        (got,) = _run(g, w2, x)
        assert torch.equal(got, f(w2, x))

    def _const_graph(self, op, value, out_aval):
        g = Graph()
        c = g.add_const(value)
        node = g.add_node(str(op), op, {"args": (Ref(0),), "kwargs": {}}, [c], [out_aval])
        g.outvars = [g.add_node("aten.neg.default", torch.ops.aten.neg.default,
                                {"args": (Ref(0),), "kwargs": {}}, node.outvars,
                                [out_aval]).outvars[0]]
        return g

    def test_no_fold_through_a_mutable_op(self):
        t = torch.ones(3)
        g = self._const_graph(torch.ops.aten.exp_.default, t, Aval.of(t))
        assert not ConstantFoldingPass().run(g)
        assert "aten.exp_.default" in _ops(g) and torch.equal(g.consts[0], torch.ones(3))

    def test_no_fold_of_a_random_op(self):
        t = torch.rand(3)
        g = self._const_graph(torch.ops.aten.rand_like.default, t, Aval.of(t))
        assert not ConstantFoldingPass().run(g)
        assert "aten.rand_like.default" in _ops(g)

    def test_no_fold_of_empty(self):
        t = torch.ones(3)
        g = self._const_graph(torch.ops.aten.empty_like.default, t, Aval.of(t))
        assert not ConstantFoldingPass().run(g)

    def test_no_fold_of_a_fake_tensor_constant(self):
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode()
        fake = mode.from_tensor(torch.ones(3))
        g = self._const_graph(torch.ops.aten.exp.default, fake, Aval((3,), torch.float32))
        assert not ConstantFoldingPass().run(g)
        assert "aten.exp.default" in _ops(g)

    def test_no_fold_while_a_trace_is_active(self):
        from torch._subclasses.fake_tensor import FakeTensorMode

        t = torch.ones(3)
        g = self._const_graph(torch.ops.aten.exp.default, t, Aval.of(t))
        with FakeTensorMode():
            assert not ConstantFoldingPass().run(g)
        assert ConstantFoldingPass().run(g)

    def test_size_cap(self):
        n = (1 << 20) + 1
        x = torch.zeros(n)
        g = _graph(lambda x: x + torch.arange(n, dtype=torch.float32), x)
        assert not ConstantFoldingPass().run(g)
        assert ConstantFoldingPass(max_elements=1 << 21).run(g)


# --------------------------------------------------------------------------
# device constants
# --------------------------------------------------------------------------


class TestDeviceConstant:
    def test_factories_promoted_once(self):
        def f(x):
            return x + torch.full((4,), 2.0) * torch.ones(4)

        x = torch.randn(3, 4)
        g = _graph(f, x)
        d = _once_then_fixed(DeviceConstantPass(), g)
        assert d["promoted"] == 2
        assert not any(o.startswith(("aten.full", "aten.ones")) for o in _ops(g))
        (got,) = _run(g, x)
        assert torch.equal(got, f(x))

    def test_scalar_stays_a_literal(self):
        def f(x):
            return x * torch.scalar_tensor(3.0)

        g = _graph(f, torch.randn(2))
        assert not DeviceConstantPass().run(g)

    def test_equal_constants_share_a_slot(self):
        g = Graph()
        x = g.add_input(Aval((4,), torch.float32))
        a, b = g.add_const(torch.arange(4.0)), g.add_const(torch.arange(4.0))
        add = torch.ops.aten.add.Tensor
        s1 = g.add_node("aten.add.Tensor", add, {"args": (Ref(0), Ref(1)), "kwargs": {}},
                        [x, a], [Aval((4,), torch.float32)])
        s2 = g.add_node("aten.add.Tensor", add, {"args": (Ref(0), Ref(1)), "kwargs": {}},
                        [s1.outvars[0], b], [Aval((4,), torch.float32)])
        g.outvars = [s2.outvars[0]]
        d = _once_then_fixed(DeviceConstantPass(), g)
        assert d == {"promoted": 0, "shared": 1}
        assert s1.invars[1].vid == s2.invars[1].vid == a.vid
        prog = lower_to_rgir(g)
        assert len(prog.constants) == 1
        (got,) = _run(g, torch.ones(4))
        assert torch.equal(got, torch.ones(4) + 2 * torch.arange(4.0))

    def test_pipeline_without_folding_promotes(self):
        cfg = PipelineConfig(enable={"constant_folding": False})
        x = torch.randn(2, 5)
        mod = forge_compile(lambda x: x - torch.arange(5, dtype=torch.float32), x, config=cfg)
        rows = {r["pass"]: r for r in mod.result.pass_table()}
        assert "constant_folding" not in rows
        assert rows["device_constant"]["detail"]["promoted"] == 1
        assert torch.equal(mod(x), x - torch.arange(5, dtype=torch.float32))


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------


class TestLayout:
    @pytest.mark.parametrize("fn", [
        lambda x: x.transpose(1, 2).transpose(1, 2) + 1,
        lambda x: x.permute(2, 0, 1).permute(1, 2, 0) + 1,
        lambda x: x.transpose(0, 2).permute(2, 1, 0) + 1,
    ])
    def test_inverse_transposes_cancel(self, fn):
        x = torch.randn(2, 3, 4)
        g = _graph(fn, x)
        d = _once_then_fixed(LayoutOptimizationPass(), g)
        assert d["transposes_cancelled"] == 1 and _ops(g) == ["aten.add.Tensor"]
        (got,) = _run(g, x)
        assert torch.equal(got, fn(x))

    def test_non_inverse_transposes_stay(self):
        x = torch.randn(2, 3, 4)
        g = _graph(lambda x: x.permute(2, 0, 1).permute(2, 0, 1) + 1, x)
        assert not LayoutOptimizationPass().run(g)

    def test_round_trip_cast_erased(self):
        x = torch.randn(3, 4).to(torch.bfloat16)
        fn = lambda x: x.float().to(torch.bfloat16) * 2  # noqa: E731
        g = _graph(fn, x)
        d = _once_then_fixed(LayoutOptimizationPass(), g)
        assert d["converts_collapsed"] == 1 and _ops(g) == ["aten.mul.Tensor"]
        (got,) = _run(g, x)
        assert torch.equal(got, fn(x))

    def test_widening_chain_collapses(self):
        x = torch.randn(3, 4).to(torch.bfloat16)
        fn = lambda x: x.float().to(torch.float16) * 2  # noqa: E731
        g = _graph(fn, x)
        d = _once_then_fixed(LayoutOptimizationPass(), g)
        assert d["converts_collapsed"] == 1
        casts = [n for n in g.nodes.values() if n.op in ("aten.to.dtype",
                                                          "aten._to_copy.default")]
        assert len(casts) == 1 and casts[0].invars[0].dtype == torch.bfloat16
        (got,) = _run(g, x)
        assert torch.equal(got, fn(x))

    def test_narrowing_chain_stays(self):
        x = torch.randn(3, 4)
        g = _graph(lambda x: x.to(torch.bfloat16).float() * 2, x)
        assert not LayoutOptimizationPass().run(g)

    def test_noop_cast_erased(self):
        g = Graph()
        x = g.add_input(Aval((3,), torch.float32))
        c = g.add_node("aten._to_copy.default", torch.ops.aten._to_copy.default,
                       {"args": (Ref(0),), "kwargs": {"dtype": torch.float32}}, [x],
                       [Aval((3,), torch.float32)])
        e = g.add_node("aten.exp.default", torch.ops.aten.exp.default,
                       {"args": (Ref(0),), "kwargs": {}}, c.outvars,
                       [Aval((3,), torch.float32)])
        g.outvars = [e.outvars[0]]
        d = _once_then_fixed(LayoutOptimizationPass(), g)
        assert d["converts_collapsed"] == 1 and _ops(g) == ["aten.exp.default"]

    def test_reshape_chain_collapses(self):
        x = torch.randn(2, 3, 4)
        for fn, left in ((lambda x: x.view(6, 4).view(4, 6) + 1, ["aten.reshape.default"]),
                         (lambda x: x.view(24).view(2, 3, 4) + 1, [])):
            g = _graph(fn, x)
            d = _once_then_fixed(LayoutOptimizationPass(), g)
            assert d["reshapes_collapsed"] == 1
            assert _ops(g) == left + ["aten.add.Tensor"]
            (got,) = _run(g, x)
            assert torch.equal(got, fn(x))

    def test_tied_head_transpose_absorbed(self):
        """``lm_head(..., transpose=True)``: matmul(x, t(E)) -> linear(x, E),
        the same bits."""
        emb, x = torch.randn(50, 8), torch.randn(2, 3, 8)
        fn = lambda x, e: L.lm_head(x, e, transpose=True)  # noqa: E731
        g = _graph(fn, x, emb)
        d = _once_then_fixed(LayoutOptimizationPass(), g)
        assert d["dot_transposes_absorbed"] == 1
        assert "aten.linear.default" in _ops(g) and "aten.t.default" not in _ops(g)
        prog = lower_to_rgir(g)
        assert [op.device for op in prog.ops if "linear" in op.opcode] == ["accel"]
        (got,) = _run(g, x, emb)
        assert torch.equal(got, fn(x, emb))

    def test_tile_hints(self):
        args = [torch.from_numpy(a) for a in make_block_args(np.random.default_rng(0))]
        mod = forge_compile(torch_block, *args)
        hinted = {n.op: n.meta.get("block_hint") for n in mod.graph.nodes.values()
                  if n.op in HOPPER_PREFERRED_TILES}
        assert set(hinted) == {"forge.sdpa", "forge.linear_act", "aten.matmul.default"}
        assert all(h == HOPPER_PREFERRED_TILES[op] for op, h in hinted.items())

    def test_hints_and_off(self):
        x = torch.randn(2, 3, 4)
        fn = lambda x: x.transpose(1, 2).transpose(1, 2) + 1  # noqa: E731
        g = _graph(fn, x)
        names = [p.name for p in default_passes(PipelineConfig(layout="hints"))]
        assert names[-1] == "layout_optimization"
        recs = run_forge_passes(g, cfg=PipelineConfig(layout="hints"))
        (rec,) = [r for r in recs if r.name == "layout_optimization"]
        assert rec.detail["transposes_cancelled"] == 0 and not rec.modified
        assert _ops(g).count("aten.transpose.int") == 2
        off = [p.name for p in default_passes(PipelineConfig(layout="off"))]
        assert "layout_optimization" not in off and len(off) == 6


# --------------------------------------------------------------------------
# the pipeline's configuration
# --------------------------------------------------------------------------


def test_default_pipeline_order():
    assert [p.name for p in default_passes()] == [
        "dce", "cse", "constant_folding", "device_constant", "attention_fusion",
        "operator_fusion", "layout_optimization"]
    assert [p.name for p in default_passes(PipelineConfig(alpha=0.0))] == [
        "dce", "cse", "constant_folding", "device_constant", "layout_optimization"]


def _three_linears(x, w1, w2, w3, b):
    h = F.silu(x @ w1 + b)
    h = torch.relu(h @ w2)
    return torch.tanh(h @ w3)


@pytest.mark.parametrize("alpha,want", [(0.0, 0), (0.34, 2), (0.5, 2), (1.0, 3)])
def test_alpha_fuses_the_first_matches(alpha, want):
    g0 = torch.Generator().manual_seed(1)
    args = [torch.randn(2, 8, generator=g0)] + [torch.randn(8, 8, generator=g0)
                                                  for _ in range(3)] + [torch.randn(8)]
    g = _graph(_three_linears, *args)
    p = OperatorFusionPass(alpha=alpha)
    assert p.run(g) == (want > 0)
    assert p.last_detail["matched"] == 3 and p.last_detail["fused"] == want == math.ceil(
        alpha * 3)
    (got,) = _run(g, *args)
    np.testing.assert_allclose(got.numpy(), _three_linears(*args).numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("alpha,want", [(0.5, 1), (1.0, 2)])
def test_alpha_in_attention_fusion(alpha, want):
    def two_heads(q, k, v):
        out = []
        for s in (q, q * 2):
            sc = torch.matmul(s, k.transpose(-2, -1)) * 0.5
            out.append(torch.matmul(torch.softmax(sc, -1), v))
        return out[0] + out[1]

    g0 = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 2, 5, 4, generator=g0) for _ in range(3))
    g = _graph(two_heads, q, k, v)
    p = AttentionFusionPass(alpha=alpha)
    p.run(g)
    assert p.last_detail["matched"] == 2 and p.last_detail["fused"] == want
    (got,) = _run(g, q, k, v)
    np.testing.assert_allclose(got.numpy(), two_heads(q, k, v).numpy(), rtol=1e-5, atol=1e-6)


def test_swiglu_switch():
    def ffn(x, wg, wu):
        return F.silu(x @ wg) * (x @ wu)

    g0 = torch.Generator().manual_seed(3)
    args = [torch.randn(3, 8, generator=g0), torch.randn(8, 16, generator=g0),
            torch.randn(8, 16, generator=g0)]
    on = forge_compile(ffn, *args)
    off = forge_compile(ffn, *args, config=PipelineConfig(swiglu_fusion=False))
    assert sorted(n.op for n in on.graph.nodes.values() if n.is_fused) == ["forge.swiglu"]
    assert [(n.op, n.params["act"]) for n in off.graph.nodes.values() if n.is_fused] == [
        ("forge.linear_act", "silu")]
    for mod in (on, off):
        np.testing.assert_allclose(mod(*args).numpy(), ffn(*args).numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_reorder_false_agrees_with_the_schedule():
    args = [torch.from_numpy(a) for a in make_block_args(np.random.default_rng(5))]
    sched = forge_compile(torch_block, *args)
    plain = forge_compile(torch_block, *args, reorder=False)
    assert plain.stats.delta_after == plain.stats.delta_before
    assert sched.stats.delta_after <= plain.stats.delta_after
    assert torch.equal(plain(*args), sched(*args))
    for backend in ("interpret", "segment_jit"):
        assert torch.equal(plain.with_backend(backend)(*args), sched(*args))


def test_backend_argument_wins_and_impl_shorthand():
    c = ForgeCompiler(PipelineConfig(backend="reference", impl="ref"), backend="interpret")
    assert c.backend_name == "interpret" and c.impl == "ref"
    assert ForgeCompiler(impl="ref").config.impl == "ref"
    assert ForgeCompiler(PipelineConfig(backend="segment_jit")).backend_name == "segment_jit"


# --------------------------------------------------------------------------
# each pass alone, then all of them, on forge-125m's smoke block bodies
# --------------------------------------------------------------------------

SINGLE = ["constant_folding", "device_constant", "attention_fusion", "operator_fusion",
          "layout_optimization"]


def _smoke_block(mode):
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    p = T.init(cfg, torch.Generator().manual_seed(0), "cpu")["blocks"][0]
    g = torch.Generator().manual_seed(1)
    B, S = 2, 8
    if mode == "apply":
        x = torch.randn(B, S, cfg.d_model, generator=g)
        cos, sin = T._rope_for(cfg, torch.arange(S))
        return (lambda *a: T.block_apply(*a, cfg=cfg)), (p, x, cos, sin)
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    kc = torch.randn(B, cfg.n_kv_heads, 16, cfg.head_dim_, generator=g)
    pos = torch.tensor(3)
    cos, sin = T._rope_for(cfg, L.decode_positions(pos))
    return (lambda *a: T.block_decode(*a, cfg=cfg)), (p, x, kc, kc.clone(), pos, cos, sin)


@pytest.mark.parametrize("mode", ["apply", "decode"])
@pytest.mark.parametrize("only", SINGLE + ["all"])
def test_each_pass_alone_then_all_keep_outputs(mode, only):
    fn, args = _smoke_block(mode)
    names = ["dce", "cse"] + SINGLE
    enable = {} if only == "all" else {n: n in ("dce", "cse", only) for n in names}
    mod = forge_compile(fn, *args, config=PipelineConfig(enable=enable))
    want = fn(*args)
    got = mod(*args)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    ran = {r["pass"] for r in mod.result.pass_table()}
    assert ran == ({"dce", "cse", only} if only != "all" else set(names))


@pytest.mark.parametrize("S,causal", [(8, True), (16, False)])
def test_banded_mask_folds_like_the_reference(S, causal):
    """recurrentgemma's local attention: at S <= window the folded banded
    mask is the causal pattern, which both compilers fuse as the kernel's
    causal mode; past the window it stays a boolean mask operand."""
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.core import ForgeCompiler as JaxForgeCompiler
    from repro.core import PipelineConfig as JaxPipelineConfig
    from repro.models import layers as JL
    from repro.models import rglru as JR
    from repro_torch.models import rglru as R

    from torch_port_support import jax_params, port_params

    jcfg = jax_get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    cfg = get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    full = jax_params(jcfg)
    jp, p = full["blocks"][2], port_params(full)["blocks"][2]
    assert S <= cfg.window if causal else S > cfg.window
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jcos, jsin = JL.rope_tables(jnp.arange(S, dtype=jnp.int32), jcfg.head_dim_, jcfg.rope_theta)
    cos, sin = L.rope_tables(torch.arange(S), cfg.head_dim_, cfg.rope_theta)
    jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(
        lambda q, x_, c, s: JR._attn_block_apply(q, x_, c, s, jcfg), jp, jnp.asarray(x),
        jcos, jsin)
    fn = lambda q, x_, c, s: R._attn_block_apply(q, x_, c, s, cfg)  # noqa: E731
    mod = forge_compile(fn, p, torch.from_numpy(x), cos, sin)

    def sdpa(nodes):
        return [(n.params["causal"], n.params["mask_mode"]) for n in nodes
                if n.op == "forge.sdpa"]

    got = sdpa(mod.graph.nodes.values())
    assert got == sdpa(jmod.graph.nodes.values()) == [(causal, "none" if causal else "bool")]
    np.testing.assert_allclose(mod(p, torch.from_numpy(x), cos, sin).numpy(),
                               fn(p, torch.from_numpy(x), cos, sin).numpy(), rtol=1e-5,
                               atol=1e-5)
