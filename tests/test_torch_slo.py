"""The port's SLO-aware slot scheduling against the JAX package's.

Both packages serve the smoke forge-125m with the parameters of
``get_model(cfg).init(PRNGKey(0))`` (through ``bridge.params_from_numpy``),
``backend="interpret"``, the default pipeline and tick-clocked arrivals
(the JAX package's tests/test_slo.py workloads; its own tests build
``segment_jit`` servers, which fail on jax 0.9.0).  Held equal: every
request's tokens, error type, ``preempted``, admitted and finished tick,
and the scheduler metrics.

Also here: the paged fill path (a prompt the prefill grid does not cover
is replayed through the paged decode program, as in the JAX scheduler),
``propose_rungs``, ``PagePool.park`` / ``unpark`` / ``check``, the ladder
re-fit, and preemption and resume on the contiguous xlstm-350m smoke.
"""
import numpy as np
import pytest

import repro.launch.serve as jserve
from repro.configs import get_config as jax_get_config
from repro.core import paging as jpaging
from repro.core import shapekey as jshapekey
from repro_torch.configs import get_config
from repro_torch.core import paging, shapekey
from repro_torch.launch import serve
from repro_torch.models import get_model

from torch_port_support import jax_params, port_params

#: per-request fields and scheduler metrics held equal to the JAX scheduler
FIELDS = ("error_type", "preempted", "admitted_tick", "finished_tick")
METRICS = ("preemptions", "resumes", "shed", "deferrals", "rows_quarantined",
           "dispatch_retries", "tick_failures", "ticks_degraded", "refits",
           "decode_dispatches", "prefill_dispatches", "swaps", "resizes",
           "requests_failed", "requests_rejected", "idle_ticks", "occupied_row_steps",
           "capacity_row_steps", "compiles")


def _prompt(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(np.int32)


def _bg_plus_burst(req_cls, *, bg=2, bg_tokens=24, bursts=2, burst_arrival=4,
                   burst_priority=2, burst_budget=None):
    """Background requests at tick 0 saturating the slots, and short
    high-priority bursts arriving mid-decode (tests/test_slo.py)."""
    reqs = [req_cls(rid=i, prompt=_prompt(6, seed=i), max_new=bg_tokens, priority=0)
            for i in range(bg)]
    for j in range(bursts):
        reqs.append(req_cls(rid=100 + j, prompt=_prompt(4, seed=50 + j), max_new=3,
                            arrival=burst_arrival + j, priority=burst_priority,
                            ttft_budget_s=burst_budget))
    return reqs


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return {"port": (serve, cfg, port_params(jp)), "jax": (jserve, jcfg, jp)}


@pytest.fixture(scope="module")
def servers(setup):
    """One warmed server per (package, paged), reused across runs (the
    prefix tree is cleared before each run)."""
    made = {}

    def get(pkg, paged):
        if (pkg, paged) not in made:
            mod, cfg, params = setup[pkg]
            srv = mod.BatchedServer(cfg, params, max_len=32, mode="forge", backend="interpret",
                                    seq_bucket_policy="ladder:8,16,32", paged=paged,
                                    kv_page_size=8)
            mod.SlotScheduler(srv, max_slots=2).warmup(prompt_lens=[4, 6])
            made[pkg, paged] = srv
        srv = made[pkg, paged]
        if paged:
            srv.prefix_tree.clear()
        return srv

    return get


def _run(servers, pkg, paged, reqs_fn, **kw):
    srv = servers(pkg, paged)
    mod = serve if pkg == "port" else jserve
    out = mod.SlotScheduler(srv, max_slots=2, **kw).run(reqs_fn(mod.Request))
    return out, srv


def _assert_same(got, want):
    assert set(got["results"]) == set(want["results"])
    for rid, w in want["results"].items():
        g = got["results"][rid]
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]), err_msg=f"rid {rid}")
        for f in FIELDS:
            assert g.get(f) == w.get(f), (rid, f, g.get(f), w.get(f))
    for k in METRICS:
        assert got[k] == want[k], (k, got[k], want[k])


# --------------------------------------------------------------------------
# the paged fill path
# --------------------------------------------------------------------------

#: rid 0's prompt (20 tokens) is beyond the ladder:8,16 prefill grid
FILL_TOKENS = {0: [155, 169, 353, 373], 1: [328, 236, 272, 458]}


def _fill_requests(req_cls, vocab):
    rng = np.random.default_rng(0)
    return [req_cls(rid=i, prompt=rng.integers(0, vocab, (n,)).astype(np.int32), max_new=4)
            for i, n in enumerate((20, 6))]


def _fill_server(mod, cfg, params, **kw):
    return mod.BatchedServer(cfg, params, max_len=64, mode="forge", backend="interpret",
                             seq_bucket_policy="ladder:8,16", paged=True, kv_page_size=8, **kw)


def test_paged_fill_path_matches_jax():
    """A prompt beyond the prefill grid is replayed through the paged
    decode program, which writes its K/V through the page table: the
    tokens are the JAX scheduler's (the port refused it before)."""
    cfg = get_config("forge-125m", smoke=True)
    jcfg = jax_get_config("forge-125m", smoke=True)
    jp = jax_params(jcfg)
    outs = {}
    for mod, c, p in ((jserve, jcfg, jp), (serve, cfg, port_params(jp))):
        srv = _fill_server(mod, c, p)
        outs[mod] = mod.SlotScheduler(srv, max_slots=2).run(_fill_requests(mod.Request, c.vocab))
    got, want = outs[serve], outs[jserve]
    for rid, toks in FILL_TOKENS.items():
        assert "error" not in got["results"][rid]
        assert list(got["results"][rid]["tokens"]) == toks
        assert list(want["results"][rid]["tokens"]) == toks
    for k in ("decode_dispatches", "prefill_dispatches", "swaps", "resizes"):
        assert got[k] == want[k], k
    # the 20-token prompt took no prefix match and no prefill: its first
    # token came out of the decode loop after its 20 prompt positions
    assert got["results"][0]["ttft_ticks"] == 20 and got["prefill_dispatches"] == 0


def test_async_paged_admission_takes_fill_path_without_inline_compile():
    """Async, with no warm prefill cell: the admission takes the fill path
    (the cold cell goes to the compile service) and never compiles
    inline; the tokens are the JAX scheduler's fill-path tokens (a ladder
    that admits neither prompt forces its fill path)."""
    cfg = get_config("forge-125m", smoke=True)
    jcfg = jax_get_config("forge-125m", smoke=True)
    jp = jax_params(jcfg)

    def reqs(cls):
        return [cls(rid=i, prompt=_prompt(n, seed=60 + i), max_new=4)
                for i, n in enumerate((12, 6))]

    jsrv = jserve.BatchedServer(jcfg, jp, max_len=64, mode="forge", backend="interpret",
                                seq_bucket_policy="ladder:4", paged=True, kv_page_size=8)
    want = jserve.SlotScheduler(jsrv, max_slots=2).run(reqs(jserve.Request))
    srv = _fill_server(serve, cfg, port_params(jp), async_compile=True, compile_workers=1)
    try:
        sched = serve.SlotScheduler(srv, max_slots=2)
        sched.warmup()  # decode rungs only: no prefill cell is warm
        pf = srv.prefill_bucketed
        assert pf.warm_keys() == []
        res = sched.run(reqs(serve.Request))
        for rid, w in want["results"].items():
            np.testing.assert_array_equal(res["results"][rid]["tokens"], np.asarray(w["tokens"]))
        assert res["prefill_dispatches"] == 0 == want["prefill_dispatches"]
        # nothing waited on a prefill compile: no inline compile ran
        assert pf.stats.compile_wait_s == 0.0
        srv.compile_service.wait_idle()
        assert pf.stats.compiles == 1 and pf.stats.compile_background_s > 0
    finally:
        srv.compile_service.shutdown()


# --------------------------------------------------------------------------
# propose_rungs, PagePool park / unpark
# --------------------------------------------------------------------------

@pytest.mark.parametrize("observed,max_rungs,cap", [
    ([1, 1, 2, 2, 3, 8, 8, 8, 8], 3, None),
    ([4, 4, 4], 2, 16),
    ([], 4, 16),
    ([3, 7, 2], 1, None),
    ([5, 9, 1, 17, 3, 3, 12], 4, None),
    ([2, 2, 2, 2, 1, 1, 1, 4, 3, 3], 4, 4),
    ([1, 2], 0, None),
    ([], 4, None),
])
def test_propose_rungs_matches_jax(observed, max_rungs, cap):
    try:
        want = jshapekey.propose_rungs(observed, max_rungs, cap=cap)
    except ValueError:
        with pytest.raises(ValueError):
            shapekey.propose_rungs(observed, max_rungs, cap=cap)
        return
    got = shapekey.propose_rungs(observed, max_rungs, cap=cap)
    assert got == want
    pol = shapekey.LadderPolicy(rungs=got)
    assert all(pol.bucket(v) >= v for v in observed)


def _park_script(mod):
    """One sequence of pool operations: each step's outcome (value or the
    error's type), the pool's state after it, and whether check() holds."""
    pool = mod.PagePool(num_pages=10, page_size=4)
    trace = []

    def step(fn):
        try:
            r = fn()
        except (ValueError, KeyError, MemoryError) as e:
            r = type(e).__name__
        try:
            pool.check()
            ok = True
        except AssertionError:
            ok = False
        trace.append((r, pool.pages_in_use, pool.parked_owners, pool.parked_pages, ok))

    a = pool.alloc(3)
    b = pool.alloc(2)
    step(lambda: pool.park("r1", a))
    step(lambda: pool.park("r1", b))  # owner already parked
    step(lambda: pool.park("r2", [mod.TRASH_PAGE]))
    step(lambda: pool.fork(b[:1]))
    step(lambda: pool.park("r2", b))
    step(lambda: pool.unpark("r1"))
    step(lambda: pool.unpark("nobody"))
    step(lambda: pool.free(a))
    step(lambda: pool.park("r3", a[:1]))  # a dead page
    step(lambda: pool.free(b))  # drops one of two refs: r2's claim still live
    step(lambda: pool.free(b[:1]))  # r2's first page dies while parked
    step(lambda: pool.unpark("r2"))
    s = pool.stats
    return trace, (s.parks, s.unparks, s.peak_parked_pages)


def test_page_park_matches_jax():
    got, want = _park_script(paging), _park_script(jpaging)
    assert got == want
    # the parked page that died broke reachability: check() refused it
    assert [t[-1] for t in got[0]].count(False) >= 1


# --------------------------------------------------------------------------
# EDF admission, shed, preemption: tests/test_slo.py's workloads
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slo", [True, False], ids=["slo", "fifo"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_bg_plus_burst_matches_jax(servers, paged, slo):
    want, _ = _run(servers, "jax", paged, _bg_plus_burst, slo=slo)
    got, srv = _run(servers, "port", paged, _bg_plus_burst, slo=slo)
    _assert_same(got, want)
    if slo:
        assert got["preemptions"] >= 1 and got["resumes"] >= 1
        assert any(r["preempted"] for r in got["results"].values())
    else:
        assert got["preemptions"] == 0 and got["shed"] == 0
    if paged:
        assert srv.page_pool.parked_owners == 0
        srv.page_pool.check()
    else:
        pool = srv.bucketed.pool
        assert not any(isinstance(k, tuple) and k[:1] == ("parked",) and pool.pooled(k)
                       for k in list(pool._free))


def test_slo_tokens_equal_fifo_tokens(servers):
    """Parking and resuming replays nothing: every request's tokens under
    SLO preemption are the FIFO run's, bitwise."""
    for paged in (True, False):
        a, _ = _run(servers, "port", paged, _bg_plus_burst, slo=True)
        b, _ = _run(servers, "port", paged, _bg_plus_burst, slo=False)
        assert a["preemptions"] >= 1
        for rid, r in b["results"].items():
            np.testing.assert_array_equal(a["results"][rid]["tokens"], r["tokens"])


VARIANTS = {
    "low_priority": dict(burst_priority=0),
    "three_bursts": dict(bursts=3),
    "hopeless": dict(burst_budget=1e-6, burst_priority=0),
    "generous_budget": dict(burst_budget=30.0, burst_priority=0),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bg_plus_burst_variants_match_jax(servers, variant):
    def reqs(cls):
        return _bg_plus_burst(cls, **VARIANTS[variant])

    want, _ = _run(servers, "jax", True, reqs)
    got, _ = _run(servers, "port", True, reqs)
    _assert_same(got, want)
    if variant == "low_priority":
        assert got["preemptions"] == 0  # equal priority never preempts
    if variant == "hopeless":
        assert got["shed"] == 2 and got["shed_rate"] == pytest.approx(2 / 4)
        assert all("shed" in got["results"][100 + j]["error"] for j in range(2))


def _admission_workload(budgets):
    def reqs(cls):
        r = [cls(rid=0, prompt=_prompt(6), max_new=12),
             cls(rid=1, prompt=_prompt(6, seed=9), max_new=24)]
        if budgets:
            r += [cls(rid=2, prompt=_prompt(4, seed=1), max_new=3, arrival=1,
                      ttft_budget_s=100.0),
                  cls(rid=3, prompt=_prompt(4, seed=2), max_new=3, arrival=2,
                      ttft_budget_s=30.0)]
        else:
            r += [cls(rid=2, prompt=_prompt(4, seed=1), max_new=3, arrival=1, priority=0),
                  cls(rid=3, prompt=_prompt(4, seed=2), max_new=3, arrival=2, priority=5)]
        return r
    return reqs


@pytest.mark.parametrize("budgets", [False, True], ids=["priority", "edf"])
def test_admission_order_matches_jax(servers, budgets):
    """A later high-priority arrival jumps the queue (by parking a running
    slot); equal-priority requests go in deadline order."""
    reqs = _admission_workload(budgets)
    want, _ = _run(servers, "jax", True, reqs)
    got, _ = _run(servers, "port", True, reqs)
    _assert_same(got, want)
    res = got["results"]
    if budgets:
        assert got["preemptions"] == 0 and got["shed"] == 0
        assert res[3]["admitted_tick"] <= res[2]["admitted_tick"]
    else:
        assert got["preemptions"] >= 1
        assert res[3]["admitted_tick"] < res[2]["admitted_tick"]


def test_budget_validation_is_typed(servers):
    def reqs(cls):
        return [cls(rid=0, prompt=_prompt(4), max_new=2, ttft_budget_s=-1.0),
                cls(rid=1, prompt=_prompt(4), max_new=2, latency_budget_s=0.0),
                cls(rid=2, prompt=_prompt(4), max_new=2)]

    want, _ = _run(servers, "jax", True, reqs)
    got, _ = _run(servers, "port", True, reqs)
    _assert_same(got, want)
    assert got["requests_rejected"] == 2
    assert [got["results"][i]["error_type"] for i in (0, 1)] == ["RequestError"] * 2


# --------------------------------------------------------------------------
# ladder re-fit
# --------------------------------------------------------------------------

def _refit_requests(cls, n=5, max_new=10):
    return [cls(rid=i, prompt=_prompt(5, seed=i), max_new=max_new, arrival=i) for i in range(n)]


def test_refit_matches_jax_and_keeps_tokens(setup):
    """A mid-run re-fit changes bucket extents, never tokens; the re-fit
    run equals the JAX scheduler's re-fit run."""
    outs = {}
    for pkg in ("jax", "port"):
        mod, cfg, params = setup[pkg]
        for interval in (0, 4):
            srv = mod.BatchedServer(cfg, params, max_len=32, mode="forge", backend="interpret",
                                    seq_bucket_policy="ladder:8,16,32", paged=True,
                                    kv_page_size=8)
            sched = mod.SlotScheduler(srv, max_slots=3, refit_interval=interval)
            sched.warmup(prompt_lens=[5])
            outs[pkg, interval] = sched.run(_refit_requests(mod.Request))
    got = outs["port", 4]
    assert got["refits"] >= 1
    _assert_same(got, outs["jax", 4])
    assert got["refit_evictions"] == outs["jax", 4]["refit_evictions"]
    for rid, r in outs["port", 0]["results"].items():
        np.testing.assert_array_equal(got["results"][rid]["tokens"], r["tokens"])


def test_refit_pins_policy_name_and_addressability(setup):
    """refit_policy keeps the old policy name, so every AxisKey (programs,
    pools, cache entries) stays addressable; the rungs are the JAX
    scheduler's for the same trail."""
    rungs = {}
    for pkg in ("jax", "port"):
        mod, cfg, params = setup[pkg]
        srv = mod.BatchedServer(cfg, params, max_len=32, mode="forge", backend="interpret",
                                seq_bucket_policy="ladder:8,16,32", paged=True, kv_page_size=8)
        sched = mod.SlotScheduler(srv, max_slots=3)
        sched.warmup(prompt_lens=[5])
        front = srv.bucketed
        old_name = front.policy.name
        keys = set(front.warm_keys())
        out = sched.run(_refit_requests(mod.Request, n=4, max_new=6))
        rungs[pkg] = sched.refit()
        assert rungs[pkg] is not None and front.policy.name == old_name
        assert sched.top_extent == front.policy.bucket(sched.max_slots)
        assert sched.metrics["refits"] == out["refits"] + 1
        if pkg == "port":
            assert isinstance(front.policy, shapekey.LadderPolicy)
            # every surviving program is still addressed by its old key
            for k in front.warm_keys():
                assert k in keys and front.lookup_program(front.key_for_extents(k.extents))
    assert rungs["port"] == rungs["jax"]


# --------------------------------------------------------------------------
# contiguous preempt / resume on the recurrent xlstm-350m smoke
# --------------------------------------------------------------------------

def test_xlstm_contiguous_resume_is_bitwise():
    """A parked contiguous row (recurrent state included) resumes into a
    free slot with no replay: every request's tokens equal the FIFO run's,
    and no parked row tree is left in the pool."""
    cfg = get_config("xlstm-350m", smoke=True).with_(dtype="float32")
    import torch

    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    srv = serve.BatchedServer(cfg, params, max_len=32, mode="forge", backend="interpret",
                              seq_bucket_policy="ladder:8,16,32")
    serve.SlotScheduler(srv, max_slots=2).warmup(prompt_lens=[4, 6])
    runs = {slo: serve.SlotScheduler(srv, max_slots=2, slo=slo).run(
        _bg_plus_burst(serve.Request, bg_tokens=12)) for slo in (True, False)}
    assert runs[True]["preemptions"] >= 1 and runs[True]["resumes"] >= 1
    assert runs[True]["compiles"] == 0
    for rid, r in runs[False]["results"].items():
        assert "error" not in r
        np.testing.assert_array_equal(runs[True]["results"][rid]["tokens"], r["tokens"])
    pool = srv.bucketed.pool
    assert not any(isinstance(k, tuple) and k[:1] == ("parked",) and pool.pooled(k)
                   for k in list(pool._free))
