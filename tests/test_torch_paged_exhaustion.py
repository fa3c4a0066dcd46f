"""The port's paged ``SlotScheduler`` against the JAX package's when the
page pool runs out: with 6 pages (capacity 5) the first admission wave
wants 7, so requests bounce back to the queue and re-admit after a
retirement.  Tokens must be identical per request and the scheduling
metrics, deferrals included, equal (forge-125m smoke, f32)."""
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config

from torch_port_support import (
    PAGED_METRICS,
    jax_paged_run,
    jax_params,
    port_paged_run,
    port_params,
)


@pytest.fixture(scope="module")
def runs():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    want = jax_paged_run(jcfg, jp, kv_pages=6)
    got, srv = port_paged_run(cfg, port_params(jp), kv_pages=6)
    return got, want, srv


def test_pool_exhaustion_defers_and_completes(runs):
    got, want, srv = runs
    assert got["deferrals"] >= 1, "the pool must have been exhausted"
    assert set(got["results"]) == set(want["results"]) == set(range(8))
    for rid, w in want["results"].items():
        np.testing.assert_array_equal(got["results"][rid]["tokens"],
                                      np.asarray(w["tokens"]), err_msg=f"rid {rid}")
    srv.page_pool.check()
    assert srv.page_pool.pages_in_use == 1 + srv.prefix_tree.cached_pages


@pytest.mark.parametrize("metric", PAGED_METRICS)
def test_metrics_equal_to_jax(runs, metric):
    got, want, _ = runs
    assert got[metric] == want[metric]
