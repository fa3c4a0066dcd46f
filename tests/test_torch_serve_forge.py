"""The port's contiguous forge fronts (``BatchedServer(mode="forge")``)
serving the recurrentgemma smoke model (f32) against the JAX package's
server.

Greedy tokens must be identical to the JAX ``mode="forge",
backend="interpret"`` server and to its ``mode="jit"`` server on 3
prompts x 6 tokens (numpy seed 0), with the chunked state-scan prefill;
the prefill program's logits within rtol 2e-4 / atol 2e-5 of the JAX
``prefill_step``.  The ``{1,2,3,5,8,13}`` sweep compiles at most 4 decode
programs and nothing after warmup (the JAX package's
tests/test_serve_forge.py contract).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer
from repro_torch.launch.steps import (
    make_batched_prefill_step,
    make_slot_prefill_step,
    supports_batched_prefill,
)
from repro_torch.models import get_model

from torch_port_support import TOL_F32, as_np, jax_params, port_params


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


def _prompts(batch, n=6, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (batch, n)).astype(np.int32)


@pytest.fixture(scope="module")
def server(setup):
    cfg, _, _, p = setup
    return BatchedServer(cfg, p, max_len=32, mode="forge")


@pytest.fixture(scope="module")
def port_result(server):
    return server.generate(_prompts(3), 4)


@pytest.fixture(scope="module")
def jax_forge_tokens(setup):
    _, jcfg, jp, _ = setup
    srv = JaxBatchedServer(jcfg, jp, max_len=32, mode="forge", backend="interpret")
    res = srv.generate(_prompts(3), 4)
    assert res["prefill_mode"] == "chunked"
    return np.asarray(res["tokens"])


def test_tokens_identical_to_jax_forge_server(port_result, jax_forge_tokens):
    assert port_result["prefill_mode"] == "chunked"
    np.testing.assert_array_equal(port_result["tokens"], jax_forge_tokens)


def test_tokens_identical_to_jax_jit_server(setup, port_result):
    _, jcfg, jp, _ = setup
    want = JaxBatchedServer(jcfg, jp, max_len=32, mode="jit").generate(_prompts(3), 4)
    np.testing.assert_array_equal(port_result["tokens"], np.asarray(want["tokens"]))


def test_result_fields_and_programs(server, port_result):
    r = port_result
    assert r["tokens"].shape == (3, 4) and r["tokens"].dtype == np.int32
    assert r["ttft_s"] > 0 and r["decode_ms_p50"] <= r["decode_ms_p99"]
    assert server.forge_module.result.shape_key == "pow2:B4"
    (pkey,) = server.prefill_bucketed.programs
    assert str(pkey) == "pow2:B4xladder:S16"
    pmod = server.prefill_bucketed.programs[pkey]
    ops_ = [n.op for n in pmod.graph.nodes.values()]
    # the 2 rec layers' scans are single kernel nodes; the banded-window
    # attention fuses with its mask kept as an operand
    assert ops_.count("repro_torch.rg_lru.default") == 2
    assert ops_.count("forge.sdpa") == 1
    dmod = server.bucketed.programs[server.bucketed.key_for_extents(4)]
    assert not any(n.op.startswith("repro_torch.rg_lru") for n in dmod.graph.nodes.values())


def test_sequential_prefill_same_tokens(server, port_result):
    server.prefill_policy = "sequential"
    try:
        compiles = server.bucketed.stats.compiles
        r = server.generate(_prompts(3), 4)
    finally:
        server.prefill_policy = "auto"
    assert r["prefill_mode"] == "sequential"
    assert server.bucketed.stats.compiles == compiles  # the same warmed decode program
    np.testing.assert_array_equal(r["tokens"], port_result["tokens"])


def test_prefill_program_logits_match_jax(setup, server):
    """The served B4 x S16 prefill program against the JAX prefill_step on
    the same edge-padded block with per-row lengths."""
    cfg, jcfg, jp, p = setup
    prompts = np.pad(_prompts(4, 11, seed=3), ((0, 0), (0, 5)), mode="edge")
    lengths = np.asarray([11, 11, 7, 11], np.int32)
    cache = server._build_cache(4)
    args = server._prefill_args(4, torch.from_numpy(prompts), 0, lengths=lengths)
    pmod, key, _ = server.prefill_bucketed.program_for(p, cache, *args)
    logits, new = pmod(p, cache, *args)
    jm = jax_get_model(jcfg)
    step = jax.jit(lambda *a: jm.prefill_step(*a[:4], jcfg, slot_mask=a[4], length=a[5]))
    jl, jc = step(jp, jm.init_cache(jcfg, 4, 32), jnp.asarray(prompts), jnp.int32(0),
                  jnp.ones((4,), bool), jnp.asarray(lengths))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(as_np(logits[b, :n]), as_np(jl[b, :n]), **TOL_F32)
    for g, w in zip(new["layers"], jc["layers"]):
        for k in g:
            np.testing.assert_allclose(as_np(g[k]), as_np(w[k]), rtol=1e-5, atol=1e-5)


def test_sweep_no_compiles_after_warmup(setup):
    cfg, _, _, p = setup
    sweep = (1, 2, 3, 5, 8, 13)
    srv = BatchedServer(cfg, p, max_len=32, mode="forge", bucket_policy="pow2")
    assert srv.warmup(sweep, prompt_lens=[6]) > 0
    front, pfront = srv.bucketed, srv.prefill_bucketed
    compiles0, pcompiles0 = front.stats.compiles, pfront.stats.compiles
    assert compiles0 <= 4 and pcompiles0 <= 4
    for B, res in zip(sweep, srv.run_workload([_prompts(B) for B in sweep], 2)):
        assert res["compile_s"] == 0.0
        assert res["prefill_mode"] == "chunked"
        assert res["tokens"].shape == (B, 2)
    assert srv.bucketed is front
    assert front.stats.compiles == compiles0 and pfront.stats.compiles == pcompiles0
    # B = 3, 5, 13 rode padded buckets; P = 6 rode the S16 rung
    assert front.stats.rows_padded > 0 and pfront.stats.rows_padded > 0


def test_step_builders(setup):
    cfg, _, _, p = setup
    assert supports_batched_prefill(cfg)
    assert supports_batched_prefill(get_config("forge-125m", smoke=True))
    m = get_model(cfg)
    toks = torch.from_numpy(_prompts(2, 5))
    slot = make_slot_prefill_step(cfg)(p, m.init_cache(cfg, 2, 16, device="cpu"), toks,
                                       torch.tensor(0), torch.ones(2, dtype=torch.bool),
                                       torch.full((2,), 5))
    whole = make_batched_prefill_step(cfg)(p, m.init_cache(cfg, 2, 16, device="cpu"), toks,
                                           torch.tensor(0))
    assert torch.equal(slot[0], whole[0])


def test_dense_contiguous_front_refused(setup):
    """No longer refused: the dense decoder's contiguous fronts build its
    whole-prompt prefill grid (tokens against the JAX server are held in
    tests/test_torch_dense_prefill.py)."""
    cfg = get_config("forge-125m", smoke=True)
    p = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    srv = BatchedServer(cfg, p, max_len=32, mode="forge")
    r = srv.generate(_prompts(2, 5), 2)
    assert r["prefill_mode"] == "batched" and r["tokens"].shape == (2, 2)
    assert str(next(iter(srv.prefill_bucketed.programs))) == "pow2:B2xladder:S16"


def test_unknown_prefill_policy_rejected(setup):
    cfg, _, _, p = setup
    with pytest.raises(ValueError):
        BatchedServer(cfg, p, mode="forge", prefill="bogus")


@pytest.mark.parametrize("prefill", ["auto", "sequential"])
def test_cli_on_cpu(capsys, prefill):
    assert serve.main(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
                       "--mode", "forge", "--batch", "2", "--prompt-len", "5", "--gen", "3",
                       "--max-len", "32", "--prefill", prefill]) == 0
    out = capsys.readouterr().out
    want = "chunked" if prefill == "auto" else "sequential"
    assert f"recurrentgemma-2b-smoke batch=2 prompt=5" in out
    assert f"(prefill={want})" in out
    assert "compile_s_after_warmup=0.00" in out
