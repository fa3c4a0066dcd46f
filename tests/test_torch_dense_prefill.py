"""The dense decoder's whole-prompt prefill (``transformer.prefill_step``)
and the contiguous forge fronts serving forge-125m, against the JAX
package.

On forge-125m smoke in f32 with the JAX package's parameters:

* ``prefill_step`` logits and the written KV cache within rtol 2e-4 /
  atol 2e-5 of the JAX ``prefill_step`` (from a zero cache and as a
  continuation at position 7); rows outside ``slot_mask`` keep their
  cache bitwise;
* ``BatchedServer(mode="forge")`` (the contiguous fronts, ``segment_jit``
  on the CPU) gives greedy tokens identical to the JAX ``mode="forge",
  backend="interpret"`` and ``mode="jit"`` servers, with the batched
  prefill and with ``prefill="sequential"``;
* the contiguous ``SlotScheduler`` gives every request's tokens, its
  admission and finish ticks and the scheduling metrics of the JAX
  scheduler (the contract of tests/test_torch_slot_contiguous.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SlotScheduler as JaxSlotScheduler
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler
from repro_torch.launch.steps import make_slot_prefill_step
from repro_torch.models import get_model

from torch_port_support import TOL_F32, as_np, jax_params, port_params

MAX_LEN = 32


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _jax_prefill(jcfg, jp, cache, tokens, pos, mask=None):
    jm = jax_get_model(jcfg)
    return jm.prefill_step(jp, cache, jnp.asarray(tokens), jnp.int32(pos), jcfg,
                           slot_mask=None if mask is None else jnp.asarray(mask))


def _assert_cache_close(got, want):
    for k in ("k", "v"):
        np.testing.assert_allclose(as_np(got[k]), as_np(want[k]), **TOL_F32)


@pytest.mark.parametrize("S", [5, 16])
def test_prefill_step_matches_jax(setup, S):
    cfg, jcfg, jp, p = setup
    m = get_model(cfg)
    assert m.prefill_step is not None and not m.prefill_takes_length
    toks = _tokens((3, S), S)
    logits, cache = m.prefill_step(p, m.init_cache(cfg, 3, MAX_LEN, device="cpu"),
                                   torch.from_numpy(toks), 0, cfg)
    jl, jc = _jax_prefill(jcfg, jp, jax_get_model(jcfg).init_cache(jcfg, 3, MAX_LEN), toks, 0)
    assert tuple(logits.shape) == (3, S, cfg.vocab)
    np.testing.assert_allclose(as_np(logits), as_np(jl), **TOL_F32)
    _assert_cache_close(cache, jc)


def test_continuation_prefill_matches_jax(setup):
    """A second chunk at position 7 on the cache the first chunk wrote."""
    cfg, jcfg, jp, p = setup
    m, jm = get_model(cfg), jax_get_model(jcfg)
    first, second = _tokens((2, 7), 1), _tokens((2, 9), 2)
    _, cache = m.prefill_step(p, m.init_cache(cfg, 2, MAX_LEN, device="cpu"),
                              torch.from_numpy(first), 0, cfg)
    logits, cache = m.prefill_step(p, cache, torch.from_numpy(second),
                                   torch.tensor(7, dtype=torch.int32), cfg)
    _, jc = _jax_prefill(jcfg, jp, jm.init_cache(jcfg, 2, MAX_LEN), first, 0)
    jl, jc = _jax_prefill(jcfg, jp, jc, second, 7)
    np.testing.assert_allclose(as_np(logits), as_np(jl), **TOL_F32)
    _assert_cache_close(cache, jc)


def test_prefill_equals_sequential_decode(setup):
    """One pass over an S-token block gives the S decode steps' logits."""
    cfg, _, _, p = setup
    m = get_model(cfg)
    toks = torch.from_numpy(_tokens((2, 6), 3)).long()
    logits, cache = m.prefill_step(p, m.init_cache(cfg, 2, MAX_LEN, device="cpu"), toks, 0,
                                   cfg)
    seq = m.init_cache(cfg, 2, MAX_LEN, device="cpu")
    for i in range(6):
        step, seq = m.decode_step(p, seq, toks[:, i:i + 1], i, cfg)
        np.testing.assert_allclose(as_np(logits[:, i]), as_np(step[:, -1]), **TOL_F32)
    _assert_cache_close(cache, seq)


def test_masked_rows_keep_their_cache_bitwise(setup):
    cfg, jcfg, jp, p = setup
    m = get_model(cfg)
    g = torch.Generator().manual_seed(4)
    cache = {k: torch.randn(v.shape, generator=g)
             for k, v in m.init_cache(cfg, 3, MAX_LEN, device="cpu").items()}
    mask = np.asarray([True, False, True])
    toks = _tokens((3, 8), 5)
    step = make_slot_prefill_step(cfg)
    logits, new = step(p, {k: v.clone() for k, v in cache.items()}, torch.from_numpy(toks),
                       torch.tensor(0, dtype=torch.int32), torch.from_numpy(mask))
    for k in ("k", "v"):
        assert torch.equal(new[k][:, 1], cache[k][:, 1])
        assert not torch.equal(new[k][:, 0], cache[k][:, 0])
    # the active rows are the JAX step's on the same cache
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    jl, jc = _jax_prefill(jcfg, jp, jcache, toks, 0, mask)
    for b in (0, 2):
        np.testing.assert_allclose(as_np(logits[b]), as_np(jl[b]), **TOL_F32)
    _assert_cache_close(new, jc)


def test_block_past_the_end_is_clamped_as_in_jax(setup):
    """A block that would run past max_len lands at max_len - S, as JAX's
    dynamic_update_slice clamps it; the length mask keeps the positions."""
    cfg, jcfg, jp, p = setup
    m, jm = get_model(cfg), jax_get_model(jcfg)
    toks = _tokens((1, 8), 6)
    logits, cache = m.prefill_step(p, m.init_cache(cfg, 1, 16, device="cpu"),
                                   torch.from_numpy(toks), 12, cfg)
    jl, jc = _jax_prefill(jcfg, jp, jm.init_cache(jcfg, 1, 16), toks, 12)
    np.testing.assert_allclose(as_np(logits), as_np(jl), **TOL_F32)
    _assert_cache_close(cache, jc)


def test_per_row_positions_refused_for_a_chunk(setup):
    cfg, _, _, p = setup
    m = get_model(cfg)
    with pytest.raises(NotImplementedError, match="per-row"):
        m.prefill_step(p, m.init_cache(cfg, 2, MAX_LEN, device="cpu"),
                       torch.from_numpy(_tokens((2, 4), 7)), torch.tensor([0, 1]), cfg)


# --------------------------------------------------------------------------
# the contiguous forge fronts (group admission)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_forge_tokens(setup):
    _, jcfg, jp, _ = setup
    res = JaxBatchedServer(jcfg, jp, max_len=MAX_LEN, mode="forge",
                           backend="interpret").generate(_tokens((3, 6), 0), 4)
    assert res["prefill_mode"] == "batched"
    return np.asarray(res["tokens"])


@pytest.fixture(scope="module")
def server(setup):
    cfg, _, _, p = setup
    return BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge")


@pytest.mark.parametrize("prefill", ["auto", "sequential"])
def test_tokens_identical_to_jax_forge_server(server, jax_forge_tokens, prefill):
    server.prefill_policy = prefill
    try:
        r = server.generate(_tokens((3, 6), 0), 4)
    finally:
        server.prefill_policy = "auto"
    assert r["prefill_mode"] == ("batched" if prefill == "auto" else "sequential")
    np.testing.assert_array_equal(r["tokens"], jax_forge_tokens)


def test_tokens_identical_to_jax_jit_server(setup, server):
    _, jcfg, jp, _ = setup
    want = JaxBatchedServer(jcfg, jp, max_len=MAX_LEN, mode="jit").generate(
        _tokens((3, 6), 0), 4)
    np.testing.assert_array_equal(server.generate(_tokens((3, 6), 0), 4)["tokens"],
                                  np.asarray(want["tokens"]))


def test_programs_and_backend(server):
    server.generate(_tokens((3, 6), 0), 4)
    assert server.backend == "segment_jit"
    pmod = server.prefill_bucketed.programs[server.prefill_bucketed.key_for_extents((4, 16))]
    assert pmod.result.backend == "segment_jit"
    ops_ = [n.op for n in pmod.graph.nodes.values()]
    # the two blocks' projections and FFN fused, attention masked by length
    assert ops_.count("forge.sdpa") == 2
    s = pmod.stats
    assert s.n_segments == s.delta_after + 1 == s.last_segments_executed
    assert s.n_compiled_segments == s.n_segments and s.n_internal_regs > 0


@pytest.mark.parametrize("backend", ["interpret", "reference"])
def test_other_backends_same_tokens(setup, server, backend):
    cfg, _, _, p = setup
    r = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge", backend=backend).generate(
        _tokens((3, 6), 0), 4)
    np.testing.assert_array_equal(r["tokens"], server.generate(_tokens((3, 6), 0), 4)["tokens"])


def test_warmup_then_no_compiles(setup):
    cfg, _, _, p = setup
    srv = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge")
    srv.warmup([1, 3], prompt_lens=[6, 20])
    compiles = [f.stats.compiles for f in (srv.bucketed, srv.prefill_bucketed)]
    assert compiles == [2, 4]
    for B, P in ((1, 6), (3, 20), (3, 6)):
        res = srv.generate(_tokens((B, P), B + P), 2)
        assert res["compile_s"] == 0.0 and res["prefill_mode"] == "batched"
    assert [f.stats.compiles for f in (srv.bucketed, srv.prefill_bucketed)] == compiles


def test_cli_dense_contiguous_on_cpu(capsys):
    assert serve.main(["--arch", "forge-125m", "--smoke", "--device", "cpu", "--mode", "forge",
                       "--batch", "2", "--prompt-len", "5", "--gen", "3",
                       "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "forge-125m-smoke batch=2 prompt=5" in out and "(prefill=batched)" in out
    assert "compile_s_after_warmup=0.00" in out


# --------------------------------------------------------------------------
# the contiguous SlotScheduler
# --------------------------------------------------------------------------

METRICS = ("decode_dispatches", "prefill_dispatches", "swaps", "resizes", "idle_ticks",
           "occupied_row_steps", "capacity_row_steps", "compiles", "real_tokens")
#: (prompt length, budget, arrival tick): swap-ins, a 20-token prompt past
#: the S8/S16 grid (the fill path), a drop to one slot and a late pair
WORKLOAD = [(3, 6, 0), (5, 2, 0), (4, 3, 1), (20, 3, 2), (11, 4, 14), (7, 2, 14)]


def _requests(cls):
    return [cls(rid=i, prompt=_tokens((n,), 30 + i), max_new=m, arrival=a)
            for i, (n, m, a) in enumerate(WORKLOAD)]


def _sched_run(server_cls, sched_cls, req_cls, cfg, params, policy, **kw):
    srv = server_cls(cfg, params, max_len=MAX_LEN, mode="forge", bucket_policy="ladder:1,2",
                     seq_bucket_policy="ladder:8,16", prefill=policy, **kw)
    sched = sched_cls(srv, max_slots=2)
    sched.warmup()
    return sched.run(_requests(req_cls))


@pytest.fixture(scope="module", params=["auto", "sequential"])
def sched_runs(request, setup):
    cfg, jcfg, jp, p = setup
    got = _sched_run(BatchedServer, SlotScheduler, Request, cfg, p, request.param)
    want = _sched_run(JaxBatchedServer, JaxSlotScheduler, JaxRequest, jcfg, jp, request.param,
                      backend="interpret")
    return request.param, got, want


def test_scheduler_tokens_equal_jax(sched_runs):
    _, got, want = sched_runs
    assert sorted(got["results"]) == sorted(want["results"]) == list(range(len(WORKLOAD)))
    for rid, r in want["results"].items():
        assert "error" not in got["results"][rid], got["results"][rid].get("error")
        np.testing.assert_array_equal(got["results"][rid]["tokens"], np.asarray(r["tokens"]),
                                      err_msg=f"request {rid}")


def test_scheduler_ticks_and_metrics_equal_jax(sched_runs):
    policy, got, want = sched_runs
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    for rid, r in want["results"].items():
        g = got["results"][rid]
        assert (g["admitted_tick"], g["finished_tick"], g["swapped_in"]) == (
            r["admitted_tick"], r["finished_tick"], r["swapped_in"]), f"request {rid}"
    assert got["swaps"] >= 1 and got["resizes"] >= 2
    assert (got["prefill_dispatches"] == 0) == (policy == "sequential")
