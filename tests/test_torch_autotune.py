"""The port's autotuner (paper §4.7) against the JAX package's.

On the conftest GQA block (numpy seed 42; the port's twin is
``test_torch_compiler.torch_block``) every one of the 47 candidates
(α × λ × π at ι=2, then ι on the winning cell) must score what the
reference's scores and keep as many nodes, and the winner must be the
same.  The reference's three ``TestAutotuner`` cases are ported, and
``Graph.copy()`` must leave the captured graph as it was after every
pass run on the copy.
"""
import numpy as np
import pytest
import torch

from repro.core.autotune import AutotuningCompiler as JaxAutotuningCompiler
from repro_torch.core import (AutotuningCompiler, PipelineConfig, TuneResult, score_graph,
                              trace_to_graph)
from repro_torch.core import autotune
from repro_torch.core.passes import default_passes, run_forge_passes

from conftest import make_block_args, make_block_fn
from test_torch_compiler import torch_block


@pytest.fixture(scope="module")
def np_args():
    return make_block_args(np.random.default_rng(42))


@pytest.fixture(scope="module")
def block_args(np_args):
    return [torch.from_numpy(a) for a in np_args]


@pytest.fixture(scope="module")
def tuned(block_args):
    return AutotuningCompiler().tune(torch_block, *block_args)


@pytest.fixture(scope="module")
def jax_tuned(np_args):
    return JaxAutotuningCompiler().tune(make_block_fn(), *np_args)


def _key(c):
    return (c.alpha, c.layout, c.precision, c.max_rounds)


def test_grid_is_the_reference_grid(tuned, jax_tuned):
    assert len(tuned.candidates) == len(jax_tuned.candidates) == 47
    assert [_key(c) for c in tuned.candidates] == [_key(c) for c in jax_tuned.candidates]
    assert (autotune.ALPHAS, autotune.LAYOUTS, autotune.PRECISIONS, autotune.ROUNDS) == (
        (0.2, 0.4, 0.6, 0.8, 1.0), ("auto", "hints", "off"), ("bf16", "fp32", "mixed"),
        (1, 2, 3))


@pytest.mark.parametrize("i", range(47))
def test_candidate_scores_equal_reference(tuned, jax_tuned, i):
    got, want = tuned.candidates[i], jax_tuned.candidates[i]
    assert _key(got) == _key(want)
    assert got.score == pytest.approx(want.score, rel=1e-12)
    assert got.nodes_after == want.nodes_after


def test_winner_equals_reference(tuned, jax_tuned):
    assert _key(tuned.best) == _key(jax_tuned.best)
    assert tuned.best.score == pytest.approx(jax_tuned.best.score, rel=1e-12)


def test_one_export_and_separate_times(block_args, monkeypatch):
    calls = []
    real = autotune.trace_to_graph

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(autotune, "trace_to_graph", counted)
    r = AutotuningCompiler().tune(torch_block, *block_args)
    assert len(calls) == 1
    assert isinstance(r, TuneResult) and r.capture_ms > 0
    assert all(c.time_ms > 0 for c in r.candidates)
    assert r.total_ms >= r.capture_ms + sum(c.time_ms for c in r.candidates) * 0.99


class TestAutotuner:
    """The JAX package's ``tests/test_compiler.py::TestAutotuner``."""

    def test_grid_size(self, tuned):
        assert len(tuned.candidates) >= 45
        assert tuned.best.score <= min(c.score for c in tuned.candidates)

    def test_autotuned_compile_runs(self, block_args):
        mod = AutotuningCompiler().compile(torch_block, *block_args)
        out = mod(*block_args)
        np.testing.assert_allclose(out.numpy(), torch_block(*block_args).numpy(),
                                   rtol=1e-4, atol=1e-4)
        assert mod.result.config == mod.tune_result.best.to_config()

    def test_aggressive_fusion_wins(self, block_args):
        """Paper Table 17: cost improves monotonically with α."""
        scores = []
        for alpha in (0.0, 0.5, 1.0):
            g = trace_to_graph(torch_block, *block_args).graph
            run_forge_passes(g, cfg=PipelineConfig(alpha=alpha))
            scores.append(score_graph(g).score)
        assert scores[0] >= scores[1] >= scores[2]
        assert scores[2] < scores[0]


def test_roofline_metric_runs(block_args):
    r = AutotuningCompiler(metric="roofline").tune(torch_block, *block_args)
    assert len(r.candidates) == 47 and r.best.score > 0
    with pytest.raises(AssertionError):
        AutotuningCompiler(metric="bogus")


def _snapshot(g):
    return (
        [(n.nid, n.op, [v.vid for v in n.invars], [v.vid for v in n.outvars],
          repr(n.params), dict(n.meta)) for n in g.nodes.values()],
        [v.vid for v in g.invars], [v.vid for v in g.constvars],
        [id(c) for c in g.consts], [v.vid for v in g.outvars],
        dict(g.producer_of), {k: set(v) for k, v in g.users_of.items()},
    )


@pytest.mark.parametrize("pass_name", [p.name for p in default_passes()])
def test_copy_leaves_the_original_unchanged(block_args, pass_name):
    """Each pass (and the whole pipeline after it) on a copy: the copy
    changes, the captured graph stays ``validate()``-clean and as it was,
    and passes on a fresh copy give the same graph as on a fresh capture."""
    g = trace_to_graph(torch_block, *block_args).graph
    before = _snapshot(g)
    c = g.copy()
    (p,) = [p for p in default_passes() if p.name == pass_name]
    p.run(c)
    run_forge_passes(c)
    c.validate()
    g.validate()
    assert _snapshot(g) == before
    assert c.num_nodes() < g.num_nodes()
    fresh = trace_to_graph(torch_block, *block_args).graph
    run_forge_passes(fresh)
    assert [n.op for n in c.nodes.values()] == [n.op for n in fresh.nodes.values()]
    assert score_graph(c).score == pytest.approx(score_graph(fresh).score)


def test_copy_shares_constants_and_new_nodes(block_args):
    g = trace_to_graph(torch_block, *block_args).graph
    c = g.copy()
    assert all(a is b for a, b in zip(c.consts, g.consts))
    assert not any(c.nodes[n] is g.nodes[n] for n in g.nodes)
    assert not any(a is b for a, b in zip(c.invars, g.invars))
    new = c.add_node("aten.neg.default", torch.ops.aten.neg.default,
                     {"args": (), "kwargs": {}}, [c.invars[0]], [c.invars[0].aval])
    assert new.nid not in g.nodes and new.outvars[0].vid not in g.users_of
