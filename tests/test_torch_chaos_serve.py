"""Fault containment of the port's slot scheduler against the JAX package's.

Seeded fault plans (``runtime/chaos.py``) fire at the scheduler's sites:
``page.alloc`` (raised before any pool state moves), ``dispatch`` (once
per program execution under ``interpret``, once per segment under
``segment_jit``), ``logits.nan`` (one row's token block poisoned on the
host) and ``preempt`` (before any park).  Both packages serve the smoke
forge-125m with the JAX package's parameters and ``backend="interpret"``
(the dispatch site fires per segment under ``segment_jit``, so outcomes
match backend against the same backend only, and the JAX package's
``segment_jit`` fails on jax 0.9.0).  Held equal under one plan seed:
every request's tokens, typed outcome and ticks, and the containment
metrics; the fault_recovery soak also on qwen2.5-14b smoke, paged, and
with the SLO workload on recurrentgemma-2b smoke, contiguous.  Port-only: ``segment_jit`` survivors on the CPU bitwise equal
to the clean run, a mid-program dispatch fault retried state-safely, the
watchdog and the abort giving typed outcomes, and the CLI's ``--chaos``.
"""
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_config as jax_get_config
from repro.core.metrics import bucket_report as jax_bucket_report
from repro.core.shapekey import BucketStats as JaxBucketStats
from repro.runtime import chaos as jchaos
from repro_torch.configs import get_config
from repro_torch.core import metrics, shapekey
from repro_torch.launch import serve
from repro_torch.runtime import chaos

from torch_port_support import jax_params, port_params

MAX_LEN, PS, MAX_SLOTS = 32, 8, 4
FIELDS = ("error_type", "preempted", "admitted_tick", "finished_tick")
METRICS = ("rows_quarantined", "dispatch_retries", "tick_failures", "ticks_degraded",
           "admission_failures", "deferrals", "preemptions", "resumes", "shed",
           "faults_injected", "aborted", "requests_failed", "decode_dispatches",
           "prefill_dispatches", "swaps", "resizes", "idle_ticks", "occupied_row_steps",
           "capacity_row_steps")


@pytest.fixture(autouse=True)
def _no_plan():
    """Every test starts and ends with no plan installed in either package."""
    prev = (chaos.install_plan(None), jchaos.install_plan(None))
    yield
    chaos.install_plan(prev[0])
    jchaos.install_plan(prev[1])


def fault_recovery_workload(req_cls, vocab, n=16):
    """benchmarks/fault_recovery.py's workload: every third request shares
    a 16-token prefix plus 4 tokens, the rest have 3-11 tokens; budgets
    3 + 3i % 6, arrivals i // 3."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, (16,)).astype(np.int32)
    reqs = []
    for i in range(n):
        if i % 3 == 0:
            p = np.concatenate([shared, rng.integers(0, vocab, (4,)).astype(np.int32)])
        else:
            p = rng.integers(0, vocab, (3 + 2 * (i % 5),)).astype(np.int32)
        reqs.append(req_cls(rid=i, prompt=p, max_new=3 + (3 * i) % 6, arrival=i // 3))
    return reqs


def soak_plan(ch):
    """benchmarks/fault_recovery.py's plan."""
    return (ch.FaultPlan(seed=11)
            .arm(ch.SITE_PAGE_ALLOC, rate=0.15, max_faults=3)
            .arm(ch.SITE_DISPATCH, rate=0.08, max_faults=3)
            .arm(ch.SITE_LOGITS_NAN, times=(4,)))


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n,)).astype(np.int32)


def _bg_plus_burst(req_cls, bursts=2):
    reqs = [req_cls(rid=i, prompt=_prompt(6, seed=i), max_new=24) for i in range(2)]
    reqs += [req_cls(rid=100 + j, prompt=_prompt(4, seed=50 + j), max_new=3, arrival=4 + j,
                     priority=2) for j in range(bursts)]
    return reqs


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return {"port": (serve, chaos, cfg, port_params(jp)), "jax": (jserve, jchaos, jcfg, jp)}


@pytest.fixture(scope="module")
def servers(setup):
    """One warmed server per (package, paged, backend), reused across runs
    (each run starts from an empty prefix tree)."""
    return _server_factory(setup)


def _server_factory(setup):
    made = {}

    def get(pkg, paged, backend="interpret"):
        k = (pkg, paged, backend)
        if k not in made:
            mod, _, cfg, params = setup[pkg]
            srv = mod.BatchedServer(cfg, params, max_len=MAX_LEN, mode="forge", backend=backend,
                                    seq_bucket_policy="ladder:8,16,32", paged=paged,
                                    kv_page_size=PS)
            mod.SlotScheduler(srv, max_slots=MAX_SLOTS).warmup(prompt_lens=[4, 8, 16, 24])
            made[k] = srv
        srv = made[k]
        if paged:
            srv.prefix_tree.clear()
        return srv

    return get


def _serve(setup, servers, pkg, paged, reqs_fn, plan_fn=None, backend="interpret",
           max_slots=MAX_SLOTS, **kw):
    mod, ch, _, _ = setup[pkg]
    srv = servers(pkg, paged, backend)
    sched = mod.SlotScheduler(srv, max_slots=max_slots, **kw)
    plan = plan_fn(ch) if plan_fn is not None else None
    prev = ch.install_plan(plan)
    try:
        out = sched.run(reqs_fn(mod.Request))
    finally:
        ch.install_plan(prev)
    return out, srv, plan


def _assert_same(got, want):
    assert set(got["results"]) == set(want["results"])
    for rid, w in want["results"].items():
        g = got["results"][rid]
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]), err_msg=f"rid {rid}")
        for f in FIELDS:
            assert g.get(f) == w.get(f), (rid, f, g.get(f), w.get(f))
    for k in METRICS:
        assert got[k] == want[k], (k, got[k], want[k])


def _assert_no_leaks(srv, n_requests, out):
    assert len(out["results"]) == n_requests
    srv.page_pool.check()
    assert srv.page_pool.parked_owners == 0
    srv.prefix_tree.clear()
    srv.page_pool.check()
    assert srv.page_pool.pages_in_use == 1  # the trash pin only


def _fr(cls):
    return fault_recovery_workload(cls, 512)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_fault_recovery_soak_matches_jax(setup, servers, paged):
    """The fault_recovery soak under FaultPlan(seed=11): the same faults
    fire at the same calls, and every outcome equals the JAX scheduler's;
    survivors equal the clean run bitwise, failures are typed, nothing
    leaks."""
    clean, _, _ = _serve(setup, servers, "port", paged, _fr)
    assert all("error" not in r for r in clean["results"].values())
    want, _, jplan = _serve(setup, servers, "jax", paged, _fr, soak_plan)
    got, srv, plan = _serve(setup, servers, "port", paged, _fr, soak_plan)
    _assert_same(got, want)
    assert plan.log == jplan.log and got["faults_injected"] == plan.faults_injected >= 1
    assert got["dispatch_retries"] >= 1
    for rid, r in got["results"].items():
        if "error" in r:
            assert r["error_type"] in ("RequestError", "SystemError")
        else:
            np.testing.assert_array_equal(r["tokens"], clean["results"][rid]["tokens"])
    if paged:
        assert got["rows_quarantined"] == 1 and got["requests_failed"] >= 1
        _assert_no_leaks(srv, 16, got)


@pytest.fixture(scope="module")
def qwen_setup():
    cfg = get_config("qwen2.5-14b", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("qwen2.5-14b", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return {"port": (serve, chaos, cfg, port_params(jp)), "jax": (jserve, jchaos, jcfg, jp)}


def test_fault_recovery_soak_qwen_paged_matches_jax(qwen_setup):
    """The same soak on qwen2.5-14b smoke (GQA 4 on 2, QKV bias, SwiGLU)
    over the paged pool under FaultPlan(seed=11): every request's tokens,
    typed outcome and ticks, the containment metrics and the plan log
    equal the JAX scheduler's; survivors equal the clean run bitwise,
    nothing leaks."""
    servers = _server_factory(qwen_setup)
    clean, _, _ = _serve(qwen_setup, servers, "port", True, _fr)
    assert all("error" not in r for r in clean["results"].values())
    want, _, jplan = _serve(qwen_setup, servers, "jax", True, _fr, soak_plan)
    got, srv, plan = _serve(qwen_setup, servers, "port", True, _fr, soak_plan)
    _assert_same(got, want)
    assert plan.log == jplan.log and got["faults_injected"] == plan.faults_injected >= 1
    for rid, r in got["results"].items():
        if "error" in r:
            assert r["error_type"] in ("RequestError", "SystemError")
        else:
            np.testing.assert_array_equal(r["tokens"], clean["results"][rid]["tokens"])
    _assert_no_leaks(srv, 16, got)


@pytest.fixture(scope="module")
def rg_servers():
    """recurrentgemma-2b smoke f32 in both packages, one warmed contiguous
    server per package (the RG-LRU rows reset at admission)."""
    cfg = get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    rg_setup = {"port": (serve, chaos, cfg, port_params(jp)), "jax": (jserve, jchaos, jcfg, jp)}
    return rg_setup, _server_factory(rg_setup)


@pytest.mark.parametrize("case", ["soak", "slo", "fifo"])
def test_recurrent_contiguous_matches_jax(rg_servers, case):
    """recurrentgemma-2b over the contiguous cache, against the JAX
    scheduler: the fault_recovery soak under FaultPlan(seed=11) (the same
    faults at the same calls, every outcome equal, survivors bitwise the
    clean run's), and the background-plus-burst workload with SLO
    admission (preemption parks recurrent rows and resumes them) and
    without it."""
    rg_setup, servers = rg_servers
    if case == "soak":
        clean, _, _ = _serve(rg_setup, servers, "port", False, _fr)
        assert all("error" not in r for r in clean["results"].values())
        want, _, jplan = _serve(rg_setup, servers, "jax", False, _fr, soak_plan)
        got, _, plan = _serve(rg_setup, servers, "port", False, _fr, soak_plan)
        _assert_same(got, want)
        assert plan.log == jplan.log and got["faults_injected"] == plan.faults_injected >= 1
        assert got["dispatch_retries"] >= 1
        for rid, r in got["results"].items():
            if "error" in r:
                assert r["error_type"] in ("RequestError", "SystemError")
            else:
                np.testing.assert_array_equal(r["tokens"], clean["results"][rid]["tokens"])
        return
    slo = case == "slo"
    want, _, _ = _serve(rg_setup, servers, "jax", False, _bg_plus_burst, max_slots=2, slo=slo)
    got, srv, _ = _serve(rg_setup, servers, "port", False, _bg_plus_burst, max_slots=2, slo=slo)
    _assert_same(got, want)
    if slo:
        assert got["preemptions"] >= 1 and got["resumes"] >= 1
    else:
        assert got["preemptions"] == 0 and got["shed"] == 0
    pool = srv.bucketed.pool
    assert not any(isinstance(k, tuple) and k[:1] == ("parked",) and pool.pooled(k)
                   for k in list(pool._free))


def _abort_plan(ch):
    # every dispatch from the 8th on fails: bursts have parked a slot
    return ch.FaultPlan(seed=5).arm(ch.SITE_DISPATCH, times=tuple(range(7, 400)))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_abort_drains_parked_slots_like_jax(setup, servers, paged):
    """Containment exhausted while a slot is parked: the run returns, every
    live, parked and queued request ends with a typed SystemError, parked
    KV is released, and the outcomes equal the JAX scheduler's."""
    want, _, _ = _serve(setup, servers, "jax", paged, _bg_plus_burst, _abort_plan,
                        max_slots=2, max_consec_failures=3)
    got, srv, _ = _serve(setup, servers, "port", paged, _bg_plus_burst, _abort_plan,
                         max_slots=2, max_consec_failures=3)
    _assert_same(got, want)
    assert got["aborted"] is True and got["preemptions"] >= 1
    assert all(r["error_type"] == "SystemError" for r in got["results"].values())
    assert any(r.get("preempted") for r in got["results"].values())
    if paged:
        _assert_no_leaks(srv, 4, got)
    else:
        pool = srv.bucketed.pool
        assert not any(isinstance(k, tuple) and k[:1] == ("parked",) and pool.pooled(k)
                       for k in list(pool._free))


def test_preempt_fault_is_contained_like_jax(setup, servers):
    """A fault at the preempt site raises before any park: an ordinary
    tick failure; every request terminates and the pool holds."""
    def plan(ch):
        return ch.FaultPlan(seed=3).arm(ch.SITE_PREEMPT, times=(0,))

    want, _, _ = _serve(setup, servers, "jax", True, _bg_plus_burst, plan, max_slots=2)
    got, srv, _ = _serve(setup, servers, "port", True, _bg_plus_burst, plan, max_slots=2)
    _assert_same(got, want)
    assert got["faults_injected"] == 1 and got["tick_failures"] == 1
    _assert_no_leaks(srv, 4, got)


def test_page_alloc_chaos_never_leaks_parked_like_jax(setup, servers):
    """Page-alloc faults on a preempt-heavy workload (tests/test_slo.py):
    the outcomes are the JAX scheduler's, and clearing the tree leaves
    only the trash pin — parked pages are never stranded."""
    def plan(ch):
        return ch.FaultPlan(seed=9).arm(ch.SITE_PAGE_ALLOC, rate=0.25, max_faults=4)

    def reqs(cls):
        return _bg_plus_burst(cls, bursts=3)

    want, _, _ = _serve(setup, servers, "jax", True, reqs, plan, max_slots=2)
    got, srv, _ = _serve(setup, servers, "port", True, reqs, plan, max_slots=2)
    _assert_same(got, want)
    _assert_no_leaks(srv, 5, got)


def test_every_dispatch_failing_aborts_typed_like_jax(setup, servers):
    """Every dispatch failing exhausts containment: the run aborts, but
    returns, with a typed SystemError per request (tests/test_chaos.py)."""
    def plan(ch):
        return ch.FaultPlan().arm(ch.SITE_DISPATCH, rate=1.0)

    def reqs(cls):
        return fault_recovery_workload(cls, 512, n=4)

    want, _, _ = _serve(setup, servers, "jax", False, reqs, plan, max_consec_failures=3)
    got, _, _ = _serve(setup, servers, "port", False, reqs, plan, max_consec_failures=3)
    _assert_same(got, want)
    assert got["aborted"] is True and got["tick_failures"] >= 3 and got["ticks_degraded"] >= 1
    assert all(r["error_type"] == "SystemError" for r in got["results"].values())


# --------------------------------------------------------------------------
# port-only: segment_jit, retry state safety, the watchdog, determinism
# --------------------------------------------------------------------------

def test_segment_jit_survivors_bitwise(setup, servers):
    """Under segment_jit the dispatch site fires once per segment (another
    schedule than interpret's); survivors still equal the clean run."""
    clean, _, _ = _serve(setup, servers, "port", True, _fr, backend="segment_jit")
    got, srv, plan = _serve(setup, servers, "port", True, _fr, soak_plan, backend="segment_jit")
    assert plan.faults_injected >= 1 and got["faults_injected"] == plan.faults_injected
    for rid, r in got["results"].items():
        if "error" not in r:
            np.testing.assert_array_equal(r["tokens"], clean["results"][rid]["tokens"])
    _assert_no_leaks(srv, 16, got)


def test_mid_program_dispatch_fault_is_retried_state_safely(servers):
    """A dispatch fault after segment k > 0 of a segment_jit decode program
    leaves the caller's store untouched; the retry's tokens and store are
    an unfaulted call's, bitwise."""
    srv = servers("port", True, "segment_jit")
    mod = srv.bucketed.programs[srv.bucketed.key_for_extents(2)]
    n_seg = len(mod.executor.segments)
    assert n_seg >= 3
    rng = np.random.default_rng(3)
    pt = torch.as_tensor(np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32))
    tok = torch.as_tensor(rng.integers(0, 512, (2, 1)).astype(np.int32))
    pos = torch.tensor([5, 9], dtype=torch.int32)
    mask = torch.tensor([True, True])
    store = {k: v.clone() for k, v in srv.page_store.items()}
    before = {k: v.clone() for k, v in store.items()}
    want_tok, want_store = mod(srv.params, store, pt, tok, pos, mask)
    k = n_seg // 2
    prev = chaos.install_plan(chaos.FaultPlan().arm(chaos.SITE_DISPATCH, times=(k,)))
    try:
        with pytest.raises(chaos.InjectedFault):
            mod(srv.params, store, pt, tok, pos, mask)
        assert all(torch.equal(store[n], before[n]) for n in store)
        got_tok, got_store = mod(srv.params, store, pt, tok, pos, mask)
    finally:
        chaos.install_plan(prev)
    assert torch.equal(got_tok, want_tok)
    assert all(torch.equal(got_store[n], want_store[n]) for n in store)


def test_watchdog_trips_degrade_without_changing_tokens(setup, servers):
    """A tick deadline nothing can meet trips the watchdog at every tick:
    degraded mode sheds admissions while anything is active, yet every
    request finishes with the clean run's tokens."""
    clean, _, _ = _serve(setup, servers, "port", True, _fr)
    got, srv, _ = _serve(setup, servers, "port", True, _fr, tick_deadline_s=1e-9,
                         degraded_cooldown=2)
    assert got["watchdog_trips"] >= 1 and got["ticks_degraded"] >= 1
    assert got["tick_failures"] == 0 and got["compiles"] == 0
    for rid, r in clean["results"].items():
        assert "error" not in got["results"][rid]
        np.testing.assert_array_equal(got["results"][rid]["tokens"], r["tokens"])
    _assert_no_leaks(srv, 16, got)


def test_same_plan_seed_reproduces_outcomes(setup, servers):
    def plan(ch):
        return (ch.FaultPlan(seed=13).arm(ch.SITE_DISPATCH, times=(2, 3, 4))
                .arm(ch.SITE_LOGITS_NAN, times=(1,)))

    a, _, pa = _serve(setup, servers, "port", False, _fr, plan)
    b, _, pb = _serve(setup, servers, "port", False, _fr, plan)
    assert pa.log == pb.log and pa.faults_injected == 4
    for rid, r in a["results"].items():
        np.testing.assert_array_equal(r["tokens"], b["results"][rid]["tokens"])
        assert r.get("error") == b["results"][rid].get("error")
    assert a["rows_quarantined"] == b["rows_quarantined"] == 1


def test_run_workload_notes_failed_groups(setup):
    _, _, cfg, params = setup["port"]
    srv = serve.BatchedServer(cfg, params, max_len=MAX_LEN, mode="forge", backend="interpret",
                              seq_bucket_policy="ladder:8,16,32")
    out = srv.run_workload([_prompt(4)[None], np.zeros((2, 40), np.int32)], 3)
    assert out[0]["tokens"].shape == (1, 3) and out[1]["error_type"] == "RequestError"
    assert srv.bucketed.stats.requests_failed == 1


def test_bucket_report_fault_columns_match_jax():
    port, ref = shapekey.BucketStats(), JaxBucketStats()
    for s in (port, ref):
        s.note_fault(injected=3, request_failed=True, retries=2)
        s.note_fault(tick_degraded=True)
        s.kv_pages_capacity, s.kv_pages_in_use, s.kv_peak_pages_in_use = 32, 5, 9
    assert metrics.bucket_report(port) == jax_bucket_report(ref)
    assert "faults=3 req_failed=1 degraded_ticks=1 retries=2" in metrics.bucket_report(port)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_chaos_without_continuous_is_refused_like_jax(capsys):
    argv = ["--smoke", "--chaos", "dispatch=0.1"]
    for main in (jserve.main, serve.main):
        with pytest.raises(SystemExit) as e:
            main(argv + (["--device", "cpu"] if main is serve.main else []))
        assert e.value.code == 2
        assert "--chaos needs --continuous" in capsys.readouterr().err


def test_cli_chaos_run(capsys):
    rc = serve.main(["--smoke", "--device", "cpu", "--mode", "forge", "--paged",
                     "--continuous", "12", "--max-slots", "4", "--prompt-len", "8", "--gen", "4",
                     "--max-len", "32", "--kv-page-size", "8",
                     "--chaos", "page.alloc=0.2,dispatch=0.05", "--chaos-seed", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve] chaos: faults_injected=" in out and "aborted=False" in out
    assert "[serve] decode buckets:" in out
