"""Async compile and the disk-cache restart on the port's paged and
recurrent fronts, against the JAX package's schedulers (the
``tests/test_torch_serve_async.py`` contract beyond forge-125m).

Two fronts, each on its smoke config in f32 with the JAX package's
parameters: qwen2.5-14b (GQA, QKV bias, SwiGLU) over the paged KV pool,
and recurrentgemma-2b (RG-LRU state, local attention) over the
contiguous cache with the slot-masked chunked prefill grid.  On each:

* ``SlotScheduler`` warmed on rung 8 only falls back to it while the
  lower rungs compile on the service's workers (``warm_fallbacks``),
  never waits on a compile, and every request's tokens equal the inline
  scheduler's and the JAX package's scheduler's (``interpret``); once
  the service is idle, the same workload runs on the exact rungs with no
  fallback and the same tokens;
* a second server on the same ``cache_dir``, after every memory tier is
  dropped, warms with zero full builds (block bodies included) and
  serves the same tokens.

The JAX package's schedulers run with copying uploads
(``test_torch_moe_serve._snapshot_uploads``): the scheduler edits host
arrays a pending dispatch may still read.
"""
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SlotScheduler as JaxSlotScheduler
from repro_torch.configs import get_config
from repro_torch.core import get_compile_cache
from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler
from repro_torch.models import _forge

from test_torch_moe_serve import _snapshot_uploads
from torch_port_support import jax_params, port_params

MAX_LEN, PS, SLOTS = 32, 8, 8
#: (arch, paged): the two fronts
FRONTS = [("qwen2.5-14b", True), ("recurrentgemma-2b", False)]
IDS = ["qwen2.5-14b-paged", "recurrentgemma-2b-contiguous"]
METRICS = ("decode_dispatches", "prefill_dispatches", "swaps", "resizes", "real_tokens")


@pytest.fixture(autouse=True)
def _isolate_global_cache():
    """``cache_dir`` attaches a disk store to the process-global cache:
    restore it so no test leaks a temporary store into another."""
    g = get_compile_cache()
    store0 = g.store
    yield
    g.store = store0


def _restart():
    """Drop every in-memory compile tier (what a process restart does)."""
    g = get_compile_cache()
    _forge.clear_cache()
    g.clear()
    g.store = None


def _workload(cls, vocab):
    """One admission wave of 10 requests on 8 slots, budgets of 2 to 10
    tokens: two swap in as the first finish, then the live count walks
    down through the cold rungs 4 and 2."""
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, vocab, (4 + i % 5,)).astype(np.int32),
                max_new=2 + 2 * (i % 5), arrival=0) for i in range(10)]


LENS = sorted({4 + i % 5 for i in range(10)})


def _server(cls, cfg, params, paged, **kw):
    return cls(cfg, params, max_len=MAX_LEN, mode="forge", paged=paged, kv_page_size=PS, **kw)


def _tokens(res):
    return {rid: np.asarray(r["tokens"]).tolist() for rid, r in res["results"].items()}


@pytest.fixture(scope="module", params=FRONTS, ids=IDS)
def front(request):
    arch, paged = request.param
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    jcfg = jax_get_config(arch, smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    p = port_params(jp)
    inline_srv = _server(BatchedServer, cfg, p, paged)
    inline_srv.warmup([SLOTS], prompt_lens=LENS)
    inline = SlotScheduler(inline_srv, max_slots=SLOTS).run(_workload(Request, cfg.vocab))
    jsrv = _server(JaxBatchedServer, jcfg, jp, paged, backend="interpret")
    jsrv.warmup([SLOTS], prompt_lens=LENS)
    with _snapshot_uploads():
        jres = JaxSlotScheduler(jsrv, max_slots=SLOTS).run(_workload(JaxRequest, cfg.vocab))
    return cfg, p, paged, inline, jres


def test_inline_scheduler_equals_jax(front):
    _, _, _, inline, jres = front
    assert _tokens(inline) == _tokens(jres)
    for k in METRICS:
        assert inline[k] == jres[k], (k, inline[k], jres[k])
    assert inline["warm_fallbacks"] == 0 and inline["resizes"] >= 2 and inline["swaps"] >= 1


def test_async_scheduler_falls_back_then_switches(front):
    cfg, p, paged, inline, jres = front
    srv = _server(BatchedServer, cfg, p, paged, async_compile=True, compile_workers=2)
    try:
        srv.warmup([SLOTS], prompt_lens=LENS)
        assert sorted(k.extents[0] for k in srv.bucketed.warm_keys()) == [SLOTS]
        sched = SlotScheduler(srv, max_slots=SLOTS)
        res = sched.run(_workload(Request, cfg.vocab))
        assert srv.compile_service.wait_idle(120.0)
        bs = srv.bucketed.stats
        assert res["warm_fallbacks"] >= 1 and "warm_fallbacks=" in sched.report()
        assert bs.compile_wait_s <= 0.005 and bs.fallback_calls >= 1
        assert all("error" not in r for r in res["results"].values())
        # the background builds landed: the exact rungs, no fallback
        again = SlotScheduler(srv, max_slots=SLOTS).run(_workload(Request, cfg.vocab))
        assert again["warm_fallbacks"] == 0 and again["resizes"] == inline["resizes"]
        assert sorted(k.extents[0] for k in srv.bucketed.warm_keys()) == [2, 4, 8]
    finally:
        srv.compile_service.shutdown()
    assert _tokens(res) == _tokens(inline) == _tokens(jres)
    assert _tokens(again) == _tokens(inline)
    if paged:
        srv.page_pool.check()
        assert srv.page_pool.pages_in_use == 1 + srv.prefix_tree.cached_pages


def test_restart_replays_with_zero_builds(front, tmp_path):
    cfg, p, paged, inline, _ = front
    g = get_compile_cache()
    _restart()
    srv1 = _server(BatchedServer, cfg, p, paged, cache_dir=str(tmp_path))
    srv1.warmup([SLOTS], prompt_lens=LENS)
    assert srv1.compile_cache.stats.misses > 0 and srv1.compile_cache.store.stats.writes > 0
    _restart()
    srv2 = _server(BatchedServer, cfg, p, paged, cache_dir=str(tmp_path))
    srv2.warmup([SLOTS], prompt_lens=LENS)
    assert srv2.compile_cache.stats.misses == 0 and srv2.compile_cache.stats.disk_hits > 0
    assert g.stats.misses == 0
    res = SlotScheduler(srv2, max_slots=SLOTS).run(_workload(Request, cfg.vocab))
    assert _tokens(res) == _tokens(inline)
