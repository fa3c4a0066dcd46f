"""The port's four-phase compiler against eager execution and against the
JAX package's compiler, both under the default ``PipelineConfig``.

Phase 1 (``torch.export`` capture, tied weights), Phase 2 (DCE, CSE,
constant folding, device constants, attention and operator fusion,
layout), Phase 3 (RGIR lowering) and Phase 4
(scheduling, liveness, linear-scan allocation, interpret and reference
backends) on the conftest-style GQA block and on forge-125m's smoke
block bodies.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.core import ForgeCompiler as JaxForgeCompiler
from repro.core import PipelineConfig as JaxPipelineConfig
from repro.models import transformer as jax_T
from repro_torch.configs import get_config
from repro_torch.core import ForgeCompiler, forge_compile, lower_to_rgir, trace_to_graph
from repro_torch.core.bufalloc import validate_allocation
from repro_torch.core.executor import CompiledExecutor, analyze_program
from repro_torch.core.passes import CSEPass, DCEPass, run_forge_passes
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from torch_port_support import TOL_F32, as_np, jax_params, port_params

from conftest import make_block_args, make_block_fn


def torch_block(x, wq, wk, wv, wo, w1, b1, w2):
    """tests/conftest.py's GQA block, written with torch ops."""
    B, S, E = x.shape
    H, D, KVH = 4, E // 4, 2
    q = (x @ wq).reshape(B, S, H, D).transpose(1, 2)
    k = (x @ wk).reshape(B, S, KVH, D).transpose(1, 2)
    v = (x @ wv).reshape(B, S, KVH, D).transpose(1, 2)
    g = H // KVH
    k = k.unsqueeze(2).expand(B, KVH, g, S, D).reshape(B, H, S, D)
    v = v.unsqueeze(2).expand(B, KVH, g, S, D).reshape(B, H, S, D)
    s = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(D))
    row = torch.arange(S).view(S, 1)
    col = torch.arange(S).view(1, S)
    s = torch.where(row >= col, s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v).transpose(1, 2).reshape(B, S, E)
    x = x + o @ wo
    h = F.silu(x @ w1 + b1)
    return x + h @ w2


@pytest.fixture(scope="module")
def block_args():
    return [torch.from_numpy(a) for a in make_block_args(np.random.default_rng(42))]


@pytest.fixture(scope="module")
def compiled_block(block_args):
    return forge_compile(torch_block, *block_args)


def _fused_summary(nodes):
    out = []
    for n in nodes:
        p = n.params
        if n.op == "forge.linear_act":
            out.append((n.op, p["act"], p["has_bias"], p["has_residual"]))
        elif n.op == "forge.sdpa":
            out.append((n.op, p["causal"], p["mask_mode"], p["groups"]))
    return sorted(out, key=repr)


class TestConftestBlock:
    def test_replays_to_eager(self, compiled_block, block_args):
        got = compiled_block(*block_args)
        want = torch_block(*block_args)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)

    def test_matches_jax_block(self, compiled_block, block_args):
        want = make_block_fn()(*(b.numpy() for b in block_args))
        np.testing.assert_allclose(as_np(compiled_block(*block_args)), as_np(want),
                                   **TOL_F32)

    def test_same_fusions_as_jax(self, compiled_block, block_args):
        jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(
            make_block_fn(), *(b.numpy() for b in block_args))
        jfused = [n for n in jmod.graph.nodes.values() if n.op.startswith("forge.")]
        tfused = [n for n in compiled_block.graph.nodes.values() if n.is_fused]
        assert _fused_summary(tfused) == _fused_summary(jfused)
        sdpa = [n for n in tfused if n.op == "forge.sdpa"]
        assert len(sdpa) == 1 and sdpa[0].params["groups"] == 2  # GQA unwrapped

    def test_result_struct(self, compiled_block):
        r = compiled_block.result
        assert r.nodes_after < r.nodes_before
        assert r.fused_ops == 4 and r.attention_fused == 1  # 3 linear_act + sdpa
        names = [row["pass"] for row in r.pass_table()]
        assert names == ["dce", "cse", "constant_folding", "device_constant",
                         "attention_fusion", "operator_fusion", "layout_optimization"]
        assert "fused ops: 4" in r.summary()

    def test_segments_and_allocation(self, compiled_block):
        ex = compiled_block.executor
        s = ex.stats
        assert s.n_segments == s.delta_after + 1
        assert s.delta_after <= s.delta_before
        assert s.n_buffers < s.n_vregs
        validate_allocation(ex.alloc, ex.live)

    def test_reference_backend_agrees(self, compiled_block, block_args):
        ref = forge_compile(torch_block, *block_args, backend="reference")
        np.testing.assert_allclose(ref(*block_args).numpy(),
                                   compiled_block(*block_args).numpy(), rtol=1e-5, atol=1e-5)

    def test_unscheduled_build_agrees(self, block_args, compiled_block):
        """Liveness and allocation on the program order, not the schedule."""
        ex = forge_compile(torch_block, *block_args, reorder=False).executor
        assert [op.op_id for op in ex.prog.ops] == list(range(len(ex.prog.ops)))
        validate_allocation(ex.alloc, ex.live)
        assert ex.stats.delta_after == ex.stats.delta_before
        (got,) = ex.execute(*block_args)
        np.testing.assert_allclose(got.numpy(), compiled_block(*block_args).numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_fusion_disabled_still_replays(self, block_args):
        """DCE and CSE alone: the unfused graph replays to the raw body."""
        g = trace_to_graph(torch_block, *block_args).graph
        run_forge_passes(g, [DCEPass(), CSEPass()])
        assert not any(n.is_fused for n in g.nodes.values())
        (got,) = CompiledExecutor(analyze_program(lower_to_rgir(g))).execute(*block_args)
        np.testing.assert_allclose(got.numpy(), torch_block(*block_args).numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_input_structure_mismatch_raises(self, compiled_block, block_args):
        with pytest.raises(TypeError):
            compiled_block(*block_args[:-1])


class TestCapture:
    def test_tied_weights_become_one_input(self):
        emb = torch.randn(16, 8)
        x = torch.randn(2, 3, 8)

        def f(params, x):
            h = x @ params["embed"].t()
            return torch.softmax(h, -1) @ params["lm_head"]

        params = {"embed": emb, "lm_head": emb}
        cap = trace_to_graph(f, params, x)
        assert len(cap.graph.invars) == 2 and cap.tied_map == {1: 0}
        mod = forge_compile(f, params, x)
        assert mod.result.tied_weights == 1
        np.testing.assert_allclose(mod(params, x).numpy(), f(params, x).numpy(), rtol=1e-6)

    def test_export_bookkeeping_dropped(self):
        cap = trace_to_graph(lambda x: (x.float() * 2).to(torch.bfloat16),
                             torch.ones(3, dtype=torch.bfloat16))
        ops = [n.op for n in cap.graph.nodes.values()]
        assert not any("assert_tensor_metadata" in o for o in ops)
        assert "aten.mul.Tensor" in ops

    def test_position_tensor_is_read_at_run_time(self):
        """A 0-d position input is a graph input, not a frozen constant."""
        def f(c, pos):
            idx = torch.arange(c.shape[0]).view(-1, 1)
            return torch.where(idx == pos, 1.0, c)

        mod = forge_compile(f, torch.zeros(5, 2), torch.tensor(1))
        out = mod(torch.zeros(5, 2), torch.tensor(3))
        assert out[3].tolist() == [1.0, 1.0] and out[1].tolist() == [0.0, 0.0]

    def test_non_tensor_leaf_rejected(self):
        with pytest.raises(TypeError):
            trace_to_graph(lambda x, n: x * n, torch.ones(2), 3)


class TestPasses:
    def test_dce_removes_unreachable(self):
        def f(x):
            _ = torch.exp(x)  # dead
            return x + 1

        g = trace_to_graph(f, torch.ones(3)).graph
        n0 = g.num_nodes()
        assert DCEPass().run(g)
        assert g.num_nodes() == n0 - 1

    def test_cse_merges_duplicates(self):
        def f(x):
            return torch.exp(x) + torch.exp(x)

        g = trace_to_graph(f, torch.ones(3)).graph
        assert CSEPass().run(g)
        assert sum(1 for n in g.nodes.values() if n.op == "aten.exp.default") == 1

    @pytest.mark.parametrize("act,fn", [("relu", torch.relu), ("tanh", torch.tanh),
                                        ("silu", F.silu), ("gelu_exact", F.gelu),
                                        ("gelu", lambda h: F.gelu(h, approximate="tanh"))])
    def test_operator_fusion_activations(self, act, fn):
        x, w, b = torch.randn(2, 4, 8), torch.randn(8, 6), torch.randn(6)
        mod = forge_compile(lambda x, w, b: fn(x @ w + b), x, w, b)
        fused = [n for n in mod.graph.nodes.values() if n.is_fused]
        assert [(n.op, n.params["act"], n.params["has_bias"]) for n in fused] == [
            ("forge.linear_act", act, True)]
        np.testing.assert_allclose(mod(x, w, b).numpy(), fn(x @ w + b).numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_boolean_mask_stays_an_operand(self):
        """A non-causal where-mask fuses as a ``bool`` mask operand."""
        def f(q, k, v, keep):
            s = torch.matmul(q, k.transpose(-2, -1)) * 0.5
            s = torch.where(keep, s, torch.finfo(s.dtype).min)
            return torch.matmul(torch.softmax(s, dim=-1), v)

        g = torch.Generator().manual_seed(2)
        q, k, v = (torch.randn(1, 2, 6, 4, generator=g) for _ in range(3))
        keep = torch.rand(1, 1, 6, 6, generator=g) > 0.3
        keep[..., 0] = True
        mod = forge_compile(f, q, k, v, keep)
        (node,) = [n for n in mod.graph.nodes.values() if n.is_fused]
        assert node.op == "forge.sdpa" and node.params["mask_mode"] == "bool"
        assert not node.params["causal"]
        np.testing.assert_allclose(mod(q, k, v, keep).numpy(), f(q, k, v, keep).numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_shared_intermediate_not_fused(self):
        """The erasure-safety condition: a product read twice stays unfused."""
        x, w = torch.randn(4, 8), torch.randn(8, 8)
        mod = forge_compile(lambda x, w: (torch.relu(x @ w), x @ w), x, w)
        assert mod.result.fused_ops == 0


# --------------------------------------------------------------------------
# forge-125m smoke block bodies against the JAX package's compiler
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


def _jax_block_fused(jcfg, jp, mode):
    one = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    B, S, D = 2, 8, jcfg.d_model
    x = jnp.zeros((B, S if mode == "apply" else 1, D), jnp.float32)
    if mode == "apply":
        cos, sin = jax_T._rope_for(jcfg, jnp.arange(S, dtype=jnp.int32), None)
        fn, args = jax_T.block_apply, (one, x, cos, sin)
    else:
        kc = jnp.zeros((B, jcfg.n_kv_heads, 16, jcfg.head_dim_), jnp.float32)
        pos = jnp.asarray(3, jnp.int32)
        cos, sin = jax_T._rope_for(jcfg, pos[None], None)
        fn, args = jax_T.block_decode, (one, x, kc, kc, pos, cos, sin)
    mod = JaxForgeCompiler(JaxPipelineConfig()).compile(
        lambda *a: fn(*a, cfg=jcfg), *args)
    return [n for n in mod.graph.nodes.values() if n.op.startswith("forge.")]


def _torch_block(cfg, p, mode, backend="interpret"):
    B, S = 2, 8
    one = p["blocks"][0]
    x = torch.randn(B, S if mode == "apply" else 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    if mode == "apply":
        cos, sin = T._rope_for(cfg, torch.arange(S))
        fn, args = T.block_apply, (one, x, cos, sin)
    else:
        kc = torch.randn(B, cfg.n_kv_heads, 16, cfg.head_dim_,
                         generator=torch.Generator().manual_seed(1))
        pos = torch.tensor(3)
        cos, sin = T._rope_for(cfg, L.decode_positions(pos))
        fn, args = T.block_decode, (one, x, kc, kc.clone(), pos, cos, sin)
    raw = lambda *a: fn(*a, cfg=cfg)  # noqa: E731
    mod = ForgeCompiler(backend=backend).compile(raw, *args)
    return mod, raw, args


@pytest.mark.parametrize("mode", ["apply", "decode"])
def test_block_fusions_match_jax(smoke, mode):
    cfg, jcfg, jp, p = smoke
    mod, _, _ = _torch_block(cfg, p, mode)
    tfused = [n for n in mod.graph.nodes.values() if n.is_fused]
    jfused = _jax_block_fused(jcfg, jp, mode)
    assert sorted(n.op for n in tfused) == ["forge.linear_act"] * 3 + ["forge.sdpa"]
    assert _fused_summary(tfused) == _fused_summary(jfused)
    (sdpa,) = [n for n in tfused if n.op == "forge.sdpa"]
    if mode == "apply":  # the causal iota-where became the kernel's causal mode
        assert sdpa.params["causal"] and not sdpa.params["has_mask"]
    else:  # the decode length mask stays an additive operand
        assert not sdpa.params["causal"] and sdpa.params["mask_mode"] == "add"


@pytest.mark.parametrize("mode", ["apply", "decode"])
def test_block_backends_agree_and_replay(smoke, mode):
    cfg, _, _, p = smoke
    mod, raw, args = _torch_block(cfg, p, mode)
    ref, _, _ = _torch_block(cfg, p, mode, backend="reference")
    want = raw(*args)
    got, got_ref = mod(*args), ref(*args)
    for a, b, c in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, got_ref, want))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-5)
    s = mod.stats
    assert s.n_segments == s.delta_after + 1
    validate_allocation(mod.executor.alloc, mod.executor.live)
