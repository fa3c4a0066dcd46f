"""The port's CompileService (a copy of the JAX package's) held against
the JAX package's, scenario by scenario.

Each scenario is the JAX package's ``tests/test_compile_service.py::
TestCompileService`` case as a job script over a service class and its
chaos module: it runs once through ``repro.core.compile_service`` and
once through ``repro_torch.core.compile_service``, asserts the scenario's
behaviour on each, and the two services' ``stats.snapshot()`` must agree
on every counter that does not measure time.  Scenarios synchronise on
events, never on sleeps; every test runs under a deadline.
"""
import functools
import threading

import pytest

from repro.core import compile_service as jax_cs
from repro.runtime import chaos as jax_chaos
from repro_torch.core import compile_service as port_cs
from repro_torch.runtime import chaos as port_chaos

IMPLS = {"jax": (jax_cs.CompileService, jax_chaos), "port": (port_cs.CompileService, port_chaos)}
#: counters that depend on wall time or thread timing, not on the script
TIMED = ("busy_s", "peak_queued", "worker_restarts")
DEADLINE_S = 60.0


def within(seconds: float):
    """Fail (instead of hanging the run) when the test body overruns."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            out: dict = {}

            def body():
                try:
                    fn(*a, **kw)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    out["err"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} did not finish within {seconds} s")
            if "err" in out:
                raise out["err"]
        return wrapper
    return deco


def _blocker(svc, key="blocker"):
    """Occupy a one-worker pool: returns (started, gate); the worker has
    claimed the blocker once ``started`` is set."""
    started, gate = threading.Event(), threading.Event()

    def build():
        started.set()
        return gate.wait(10.0)

    svc.submit(key, build)
    assert started.wait(10.0)
    return gate


def dedup_builds_once(Svc, chaos):
    svc = Svc(workers=2)
    built, gate = [], threading.Event()

    def build():
        gate.wait(10.0)
        built.append(1)
        return "value"

    futs = [svc.submit("k", build) for _ in range(8)]
    gate.set()
    assert all(f.result(10.0) == "value" for f in futs)
    assert len(built) == 1
    assert svc.stats.submitted == 1 and svc.stats.dedup_hits == 7
    svc.shutdown()
    return svc.stats.snapshot()


def foreground_preempts_speculative(Svc, chaos):
    svc = Svc(workers=1)
    order = []
    gate = _blocker(svc)
    svc.submit("spec-a", lambda: order.append("spec-a"), foreground=False)
    svc.submit("spec-b", lambda: order.append("spec-b"), foreground=False)
    fg = svc.submit("fg", lambda: order.append("fg"))
    gate.set()
    fg.result(10.0)
    assert svc.wait_idle(10.0)
    assert order == ["fg", "spec-a", "spec-b"]  # jumped the speculative queue
    svc.shutdown()
    return svc.stats.snapshot()


def promotion_shares_future(Svc, chaos):
    svc = Svc(workers=1)
    gate = _blocker(svc)
    spec = svc.submit("k", lambda: 42, foreground=False)
    fg = svc.submit("k", lambda: 43)  # promote, not a second build
    assert fg is spec
    gate.set()
    assert fg.result(10.0) == 42
    assert svc.stats.promoted == 1 and svc.stats.submitted == 2
    svc.shutdown()
    return svc.stats.snapshot()


def failed_build_allows_retry(Svc, chaos):
    svc = Svc(workers=1, max_retries=0, poison_failures=False)

    def boom():
        raise RuntimeError("transient")

    with pytest.raises(RuntimeError):
        svc.submit("k", boom).result(10.0)
    assert svc.submit("k", lambda: "ok").result(10.0) == "ok"
    assert svc.stats.failed == 1 and svc.stats.retries == 0
    svc.shutdown()
    return svc.stats.snapshot()


def transient_failure_retried(Svc, chaos):
    svc = Svc(workers=1, max_retries=2, retry_backoff_s=0.005)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "recovered"

    assert svc.submit("k", flaky).result(10.0) == "recovered"
    assert len(calls) == 3
    assert svc.stats.retries == 2 and svc.stats.failed == 0 and svc.stats.completed == 1
    svc.shutdown()
    return svc.stats.snapshot()


def deterministic_failure_poisons_key(Svc, chaos):
    svc = Svc(workers=1, max_retries=1, retry_backoff_s=0.002)
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("deterministic")

    with pytest.raises(RuntimeError, match="deterministic"):
        svc.submit("k", boom).result(10.0)
    assert len(calls) == 2  # first attempt + 1 retry
    assert svc.poisoned_keys() == ["k"]
    # resubmits fail fast from the quarantine: no rebuild hot-loop
    with pytest.raises(RuntimeError, match="deterministic"):
        svc.submit("k", boom).result(10.0)
    assert len(calls) == 2 and svc.stats.poison_hits == 1
    assert svc.clear_poisoned("k") == 1
    assert svc.submit("k", lambda: "fixed").result(10.0) == "fixed"
    svc.shutdown()
    return svc.stats.snapshot()


def dead_worker_respawned(Svc, chaos):
    svc = Svc(workers=1, max_retries=0)
    prev = chaos.install_plan(chaos.FaultPlan(seed=3).arm(chaos.SITE_COMPILE_WORKER,
                                                          times=(0,)))
    try:
        # the worker dies after claiming this job: the reaper rescues it
        fut = svc.submit("k", lambda: "survived")
        assert svc.result(fut, timeout=10.0) == "survived"
        assert svc.stats.worker_restarts >= 1 and svc.stats.requeued == 1
    finally:
        chaos.install_plan(prev)
        svc.shutdown()
    return svc.stats.snapshot()


def hung_build_abandoned(Svc, chaos):
    svc = Svc(workers=1, max_retries=0, hang_timeout_s=0.05)
    gate = threading.Event()
    fut = svc.submit("hung", lambda: gate.wait(10.0))
    with pytest.raises(chaos.SystemError_, match="hang timeout"):
        svc.result(fut, timeout=10.0)
    assert svc.stats.hangs_abandoned == 1 and svc.stats.worker_restarts >= 1
    # the replacement worker keeps serving new jobs
    assert svc.submit("next", lambda: "ok").result(10.0) == "ok"
    gate.set()
    svc.shutdown()
    return svc.stats.snapshot()


def shutdown_cancels_queued(Svc, chaos):
    svc = Svc(workers=1)
    gate = _blocker(svc)
    queued = svc.submit("never", lambda: 1)
    gate.set()
    svc.shutdown(wait=True)
    assert queued.cancelled() or queued.done()
    snap = svc.stats.snapshot()
    # whether the queued job ran before the shutdown is a race in both
    snap.pop("completed")
    return snap


SCENARIOS = [dedup_builds_once, foreground_preempts_speculative, promotion_shares_future,
             failed_build_allows_retry, transient_failure_retried,
             deterministic_failure_poisons_key, dead_worker_respawned, hung_build_abandoned,
             shutdown_cancels_queued]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__ for f in SCENARIOS])
@within(DEADLINE_S)
def test_scenario_matches_jax_service(scenario):
    snaps = {}
    for name, (Svc, chaos) in IMPLS.items():
        snap = scenario(Svc, chaos)
        snaps[name] = {k: v for k, v in snap.items() if k not in TIMED}
    assert snaps["port"] == snaps["jax"]


def test_port_service_imports_no_jax():
    import ast
    import inspect

    for mod in (port_cs, port_chaos):
        tree = ast.parse(inspect.getsource(mod))
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.split(".")[0] in ("jax", "repro")], mod.__name__
