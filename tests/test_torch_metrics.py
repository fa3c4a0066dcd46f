"""The paper's metrics in the port, against the JAX package: the cost
model's features and score (Eq. 18), FGR (Eq. 22), CEI (Eq. 23), the
per-op FLOP estimate of the register IR, and the fidelity protocol
(Table 6) with the paper's bounds, raw against compiled and every
Phase-4 backend against the ``reference`` oracle.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import cost_model as jax_cost_model
from repro.core import metrics as jax_metrics
from repro.core import trace_to_graph as jax_trace
from repro.core.passes import run_forge_passes as jax_run_passes
from repro_torch.configs import get_config
from repro_torch.core import (PipelineConfig, forge_compile, lower_to_rgir, roofline_score,
                              score_graph, trace_to_graph)
from repro_torch.core import cost_model
from repro_torch.core.metrics import (PAPER_MAX_ABS, PAPER_MAX_KL, FidelityReport,
                                      check_backend_fidelity, check_compilation_fidelity,
                                      compilation_efficiency_index, fidelity,
                                      fusion_gain_ratio)
from repro_torch.core.passes import run_forge_passes
from repro_torch.models import transformer as T

from conftest import make_block_args, make_block_fn
from test_torch_compiler import torch_block

#: features that do not depend on how the two captures spell the graph
SHAPE_FREE = ("n_weights", "params_m", "n_fused", "n_attn_fused")


@pytest.fixture(scope="module")
def block_args():
    return make_block_args(np.random.default_rng(42))


def _port_graph(args, cfg=None):
    g = trace_to_graph(torch_block, *(torch.from_numpy(a) for a in args)).graph
    run_forge_passes(g, cfg=cfg)
    return g


def _jax_graph(args):
    g = jax_trace(make_block_fn(), *args).graph
    jax_run_passes(g)
    return g


def test_features_match_reference(block_args):
    got = cost_model.graph_features(_port_graph(block_args))
    want = jax_cost_model.graph_features(_jax_graph(block_args))
    assert {k: got[k] for k in SHAPE_FREE} == {k: want[k] for k in SHAPE_FREE}
    assert got["n_fused"] == 4 and got["n_attn_fused"] == 1
    assert 0 < got["linear_frac"] <= 1 and 0 < got["depth"] <= got["n_ops"]


def test_score_is_eq18(block_args):
    g = _port_graph(block_args)
    c = score_graph(g)
    base = (cost_model.W_OPS * c.n_ops + cost_model.W_WEIGHTS * c.n_weights
            + cost_model.W_LINEAR * c.linear_frac * c.n_ops + cost_model.W_DEPTH * c.depth
            + cost_model.W_PARAMS * c.params_m)
    assert c.score == pytest.approx(base * cost_model.BONUS_ATTENTION * cost_model.BONUS_OPERATOR)
    assert score_graph(g, "fp32").score == pytest.approx(c.score * 1.35)
    for name in ("W_OPS", "W_WEIGHTS", "W_LINEAR", "W_DEPTH", "W_PARAMS", "BONUS_ATTENTION",
                 "BONUS_OPERATOR", "PRECISION_FACTOR"):
        assert getattr(cost_model, name) == getattr(jax_cost_model, name)


def test_fgr(block_args):
    got = fusion_gain_ratio(torch_block, *(torch.from_numpy(a) for a in block_args))
    want = jax_metrics.fusion_gain_ratio(make_block_fn(), *block_args)
    assert got["fgr"] > 1 and got["score_alpha0"] > got["score_alpha1"]
    assert want["fgr"] > 1
    a0 = _port_graph(block_args, PipelineConfig(alpha=0.0))
    assert cost_model.graph_features(a0)["n_fused"] == 0
    assert got["score_alpha0"] == pytest.approx(score_graph(a0).score)


def test_cei_arithmetic():
    assert compilation_efficiency_index(10.0, 5.0, 2000.0) == pytest.approx(1.0)
    for args in ((12.0, 3.0, 500.0), (1.0, 4.0, 10.0)):
        assert compilation_efficiency_index(*args) == pytest.approx(
            jax_metrics.compilation_efficiency_index(*args))


def test_compilation_result_carries_the_cost(block_args):
    mod = forge_compile(torch_block, *(torch.from_numpy(a) for a in block_args))
    r = mod.result
    assert r.cost is not None and r.fused_ops == r.cost.n_fused == 4
    assert r.attention_fused == r.cost.n_attn_fused == 1
    assert r.config == PipelineConfig() and 0 < r.node_reduction < 1


def test_flops_per_op():
    def ffn(x, wg, wu, w, b):
        return F.silu(x @ wg) * (x @ wu) + torch.relu(x @ w + b)

    M, K, N = 6, 8, 16
    g0 = torch.Generator().manual_seed(0)
    args = [torch.randn(M, K, generator=g0), torch.randn(K, N, generator=g0),
            torch.randn(K, N, generator=g0), torch.randn(K, N, generator=g0),
            torch.randn(N, generator=g0)]
    prog = lower_to_rgir(forge_compile(ffn, *args).graph)
    flops = {op.opcode: op.flops for op in prog.ops}
    assert flops["accel.forge.swiglu"] == 2 * flops["accel.forge.linear_act"] == 4.0 * M * K * N
    assert roofline_score(forge_compile(ffn, *args).graph) > 0
    assert cost_model.H100_HBM_BYTES_PER_S == 3.35e12
    assert cost_model.H100_PEAK_FLOPS_BF16 == 989e12


def test_fidelity_report():
    a = torch.randn(2, 5, 10)
    r = fidelity(a, a.clone())
    assert r.max_abs_diff == 0 and r.kl_divergence == 0 and r.n_elements == 100 and r.ok()
    bad = fidelity(a, a + 1e-3)
    assert not bad.ok() and bad.max_abs_diff == pytest.approx(1e-3, rel=1e-3)
    assert FidelityReport(2.1e-5, 8.4e-9, 1).ok() and (PAPER_MAX_ABS, PAPER_MAX_KL) == (
        2.1e-5, 8.4e-9)


def test_compilation_fidelity_within_paper_bounds(block_args):
    r = check_compilation_fidelity(torch_block, *(torch.from_numpy(a) for a in block_args))
    assert r.ok(), r


def test_compilation_fidelity_smoke_lm():
    cfg = get_config("qwen2.5-14b", smoke=True).with_(dtype="float32", fuse="none")
    p = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    r = check_compilation_fidelity(lambda p, t: T.apply(p, t, cfg), p, toks)
    assert r.n_elements == 2 * 8 * cfg.vocab and r.ok(), r


def test_backend_fidelity(block_args):
    reports = check_backend_fidelity(torch_block, *(torch.from_numpy(a) for a in block_args))
    assert set(reports) == {"interpret", "segment_jit"}
    for name, r in reports.items():
        assert r.max_abs_diff == 0 and r.ok(), (name, r)
