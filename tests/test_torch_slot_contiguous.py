"""The port's contiguous ``SlotScheduler`` against the JAX package's.

Slot-level continuous batching over the contiguous forge fronts
(``BatchedServer(mode="forge")`` without ``paged``) for the recurrent
families: swapped-in rows reset to init state, admitted through the
slot-masked chunked prefill grid, or consumed token by token inside the
decode loop (the fill path) when the grid does not cover a prompt or
under ``prefill="sequential"``; rung resizes gather the active rows.
The JAX scheduler runs with ``backend="interpret"`` on the same f32 smoke
parameters (the JAX package's tests/test_recurrent_prefill.py and
tests/test_continuous_batching.py scheduler contracts).  Every request's
greedy tokens and the scheduling metrics must be equal.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SlotScheduler as JaxSlotScheduler
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler
from repro_torch.models import get_model

from torch_port_support import jax_params, port_params

ARCHS = ["xlstm-350m", "recurrentgemma-2b"]
POLICIES = ["auto", "sequential"]
#: metrics that must be equal between the port and the JAX scheduler
METRICS = ("decode_dispatches", "prefill_dispatches", "swaps", "resizes", "idle_ticks",
           "occupied_row_steps", "capacity_row_steps", "compiles", "real_tokens")
#: sequence ladder of the prefill grid: the 20-token prompt is beyond it,
#: so even the chunked run takes the fill path for its admission wave;
#: batch rungs 1 and 2, so the scheduler resizes both ways
SEQ_POLICY = "ladder:8,16"


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 512, (n,)).astype(np.int32)


#: (prompt length, budget, arrival tick): two slots, swap-ins, a prompt
#: past the grid, a drop to one active slot (resize 2 -> 1) and a late
#: pair (resize 1 -> 2)
WORKLOAD = [(3, 6, 0), (5, 2, 0), (4, 3, 1), (20, 3, 2), (11, 4, 14), (7, 2, 14)]


def _requests(cls):
    return [cls(rid=i, prompt=_prompt(n, 30 + i), max_new=m, arrival=a)
            for i, (n, m, a) in enumerate(WORKLOAD)]


def _run(server_cls, sched_cls, req_cls, cfg, params, policy, **kw):
    srv = server_cls(cfg, params, max_len=32, mode="forge", backend="interpret",
                     bucket_policy="ladder:1,2", seq_bucket_policy=SEQ_POLICY,
                     prefill=policy, **kw)
    sched = sched_cls(srv, max_slots=2)
    sched.warmup()
    return sched.run(_requests(req_cls))


@pytest.fixture(scope="module", params=[(a, p) for a in ARCHS for p in POLICIES],
                ids=lambda ap: f"{ap[0]}-{ap[1]}")
def runs(request):
    arch, policy = request.param
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    jcfg = jax_get_config(arch, smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    p = port_params(jp)
    got = _run(BatchedServer, SlotScheduler, Request, cfg, p, policy)
    want = _run(JaxBatchedServer, JaxSlotScheduler, JaxRequest, jcfg, jp, policy)
    return policy, got, want


def test_tokens_equal_jax_scheduler(runs):
    _, got, want = runs
    assert sorted(got["results"]) == sorted(want["results"]) == list(range(len(WORKLOAD)))
    for rid, r in want["results"].items():
        assert "error" not in got["results"][rid], got["results"][rid].get("error")
        np.testing.assert_array_equal(got["results"][rid]["tokens"], np.asarray(r["tokens"]),
                                      err_msg=f"request {rid}")
        assert len(r["tokens"]) == WORKLOAD[rid][1]


def test_metrics_equal_jax_scheduler(runs):
    policy, got, want = runs
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    assert got["swaps"] >= 1 and got["resizes"] >= 2
    if policy == "sequential":
        assert got["prefill_dispatches"] == 0  # every prompt through the fill path
    else:
        assert got["prefill_dispatches"] >= 3


def test_swapped_in_and_admission_ticks_equal_jax(runs):
    _, got, want = runs
    for rid, r in want["results"].items():
        g = got["results"][rid]
        assert (g["admitted_tick"], g["finished_tick"], g["swapped_in"]) == (
            r["admitted_tick"], r["finished_tick"], r["swapped_in"]), f"request {rid}"


def test_contiguous_scheduler_guards():
    cfg = get_config("xlstm-350m", smoke=True)
    p = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="forge"):
        SlotScheduler(BatchedServer(cfg, p, max_len=32, mode="interpret"), max_slots=2)
    srv = BatchedServer(cfg, p, max_len=16, mode="forge")
    out = SlotScheduler(srv, max_slots=2).run([
        Request(rid=0, prompt=_prompt(10, 1), max_new=10),  # 10 + 10 > max_len
        Request(rid=1, prompt=_prompt(3, 2), max_new=2),
    ])
    assert out["results"][0]["error_type"] == "RequestError"
    assert out["requests_rejected"] == 1 and len(out["results"][1]["tokens"]) == 2


@pytest.mark.parametrize("extra", [[], ["--continuous", "5", "--max-slots", "2"]],
                         ids=["group", "continuous"])
def test_cli_xlstm_on_cpu(capsys, extra):
    assert serve.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu", "--mode", "forge",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3", "--max-len", "32",
                       *extra]) == 0
    out = capsys.readouterr().out
    if extra:
        assert "xlstm-350m-smoke continuous n=5" in out
        assert "compiles_post_warmup=0" in out and "cache=contiguous" in out
    else:
        assert "xlstm-350m-smoke batch=2 prompt=6" in out and "(prefill=chunked)" in out
        assert "compile_s_after_warmup=0.00" in out


def test_cli_paged_needs_continuous():
    with pytest.raises(SystemExit):
        serve.main(["--mode", "forge", "--paged", "--smoke", "--device", "cpu"])


def _sched_with_random_cache(extent=3):
    cfg = get_config("xlstm-350m", smoke=True)
    p = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    sched = SlotScheduler(BatchedServer(cfg, p, max_len=16, mode="forge"), max_slots=4)
    cache = sched.server._build_cache(extent)
    g = torch.Generator().manual_seed(1)
    leaves, spec = pytree.tree_flatten(cache)
    return sched, pytree.tree_unflatten(
        [torch.randn(v.shape, generator=g).to(v.dtype) for v in leaves], spec)


def test_reset_rows_blends_only_the_admitted_rows():
    sched, cache = _sched_with_random_cache()
    out = sched._reset_rows(cache, [1], 3)
    init = sched.server.model.init_cache(sched.server.cfg, 1, 16, device="cpu")
    for o, c, ini in zip(*(pytree.tree_leaves(t) for t in (out, cache, init))):
        assert torch.equal(o[0], c[0]) and torch.equal(o[2], c[2])  # bitwise
        assert torch.equal(o[1], ini[0])


def test_gather_rows_moves_active_rows_into_the_new_rung():
    sched, cache = _sched_with_random_cache()
    new = sched._gather_rows(cache, sched.server._build_cache(2), [2, 0])
    for n, c in zip(pytree.tree_leaves(new), pytree.tree_leaves(cache)):
        assert n.shape[0] == 2 and torch.equal(n[0], c[2]) and torch.equal(n[1], c[0])
