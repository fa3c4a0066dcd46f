"""The port's paged ``SlotScheduler`` against the JAX package's.

Workload: the JAX package's paged-scheduler fidelity test (8 requests,
prefix sharing, swap-ins, a rung resize) on forge-125m smoke in f32,
both packages with the paged "ref" attend and the interpret backend.
Tokens must be identical per request and the scheduling metrics equal;
the port's run with the paged kernel ("pallas") must give the same
tokens.  A pool too small for the workload is in
``test_torch_paged_exhaustion.py``.
"""
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler

from torch_port_support import (
    PAGED_METRICS,
    jax_paged_run,
    jax_params,
    port_paged_run,
    port_params,
)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


@pytest.fixture(scope="module")
def jax_run(setup):
    _, jcfg, jp, _ = setup
    return jax_paged_run(jcfg, jp)


@pytest.fixture(scope="module")
def port_run(setup):
    cfg, _, _, p = setup
    return port_paged_run(cfg, p)


@pytest.fixture(scope="module")
def port_kernel_run(setup):
    cfg, _, _, p = setup
    res, _ = port_paged_run(cfg.with_(kv_kernel="pallas"), p, warmup=False)
    return res


def test_tokens_identical_to_jax_scheduler(jax_run, port_run):
    res, _ = port_run
    assert set(res["results"]) == set(jax_run["results"]) == set(range(8))
    for rid, want in jax_run["results"].items():
        np.testing.assert_array_equal(res["results"][rid]["tokens"],
                                      np.asarray(want["tokens"]), err_msg=f"rid {rid}")


@pytest.mark.parametrize("metric", PAGED_METRICS)
def test_metrics_equal_to_jax(jax_run, port_run, metric):
    assert port_run[0][metric] == jax_run[metric]


def test_workload_exercises_swaps_and_prefix_hits(port_run):
    res, srv = port_run
    assert res["swaps"] >= 1 and res["prefix_hits"] >= 1 and res["tokens_reused"] >= 16
    assert res["resizes"] >= 1 and res["deferrals"] == 0
    for rid, r in res["results"].items():
        assert len(r["tokens"]) == 2 + (3 * rid) % 5  # every request gets max_new
        assert "error" not in r


def test_pool_clean_after_run(port_run):
    res, srv = port_run
    srv.page_pool.check()
    # every slot freed its pages: only the trash page and the tree's
    # cached chains stay referenced
    assert srv.page_pool.pages_in_use == 1 + srv.prefix_tree.cached_pages
    assert res["kv_pages_in_use"] == srv.page_pool.pages_in_use


def test_no_compiles_after_warmup(port_run):
    res, srv = port_run
    assert res["compiles"] == 0
    assert sorted(str(k) for k in srv.bucketed.programs) == ["pow2:B2", "pow2:B4"]
    assert len(srv.prefill_bucketed.programs) == 6  # {2, 4} x {8, 16, 32}


def test_kernel_route_same_tokens(port_run, port_kernel_run):
    ref = port_run[0]
    for rid, r in ref["results"].items():
        np.testing.assert_array_equal(port_kernel_run["results"][rid]["tokens"],
                                      r["tokens"], err_msg=f"rid {rid}")
    for metric in ("swaps", "prefix_hits", "decode_dispatches", "prefill_dispatches"):
        assert port_kernel_run[metric] == ref[metric]


def test_result_fields_and_report(port_run):
    res, _ = port_run
    assert res["tok_per_s"] > 0 and 0 < res["occupancy"] <= 1
    assert res["real_tokens"] == sum(len(r["tokens"]) for r in res["results"].values())
    assert res["ttft_p50_ticks"] >= 0 and res["tick_ms_p50"] <= res["tick_ms_p99"]
    r0 = res["results"][0]
    assert r0["ttft_ticks"] == r0["admitted_tick"] - 0 and r0["ttft_s"] > 0


def test_invalid_requests_get_typed_errors(setup, port_run):
    _, srv = port_run
    sched = SlotScheduler(srv, max_slots=4)
    good = np.arange(5, dtype=np.int32)
    res = sched.run([
        Request(rid=0, prompt=np.zeros((0,), np.int32), max_new=2),
        Request(rid=1, prompt=good, max_new=40),  # beyond max_len
        Request(rid=2, prompt=good + 1000, max_new=2),  # out of vocabulary
        Request(rid=3, prompt=good, max_new=0),
        Request(rid=4, prompt=good, max_new=3),
    ])
    assert res["requests_rejected"] == 4
    for rid in range(4):
        assert res["results"][rid]["error_type"] == "RequestError"
    assert len(res["results"][4]["tokens"]) == 3
    srv.page_pool.check()


def test_server_guards(setup):
    cfg, _, _, p = setup
    assert not BatchedServer(cfg, p, mode="forge").paged  # the contiguous fronts serve it
    with pytest.raises(ValueError):
        BatchedServer(cfg, p, mode="interpret", paged=True)  # paged needs mode="forge"
    with pytest.raises(ValueError):
        BatchedServer(cfg, p, max_len=30, mode="forge", paged=True, kv_page_size=8)
    srv = BatchedServer(cfg, p, max_len=32, mode="forge", paged=True, kv_page_size=8)
    with pytest.raises(NotImplementedError):
        srv.generate(np.zeros((1, 4), np.int32), 2)
    with pytest.raises(ValueError):
        SlotScheduler(BatchedServer(cfg, p, max_len=32, mode="interpret"), max_slots=4)
