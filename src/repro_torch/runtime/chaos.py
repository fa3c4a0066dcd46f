"""Seeded fault injection for the serving stack (a copy of the JAX
package's ``runtime/chaos.py``, which imports no JAX).

Where the port consults each site: ``compile.*`` in
``core/compile_service.py``, ``disk.*`` in ``core/cache.py``,
``page.alloc`` in ``core/paging.py``, ``dispatch`` in the ``interpret``
executor (once per program execution) and in ``segment_jit`` (once per
segment), ``logits.nan`` and ``preempt`` in the slot scheduler
(``launch/serve.py``).

A :class:`FaultPlan` is a deterministic, site-addressable schedule of
failures: each *site* is a short string naming one hook point threaded
through the stack (compile builds, disk-cache IO, page allocation,
per-segment dispatch, logits rows).  Production code calls
:func:`should_fault` / :func:`maybe_fault` at those points; with no
plan installed the calls are a single ``is None`` test, so the hooks
are free on the hot path.

Determinism: every site owns an independent counter and an independent
``random.Random`` stream derived from ``(seed, site)``, so whether call
``k`` at site ``s`` faults depends only on the plan's seed and the
per-site call ordinal — never on wall clock, thread interleaving across
*different* sites, or global RNG state.  Two runs of the same workload
under the same plan inject the same faults at the same points.

The plan also fixes the error taxonomy the serving layer degrades
along:

* :class:`RequestError` — scoped to one request (malformed prompt,
  poisoned row).  The request completes with a typed error outcome;
  everything else proceeds untouched.
* :class:`SystemError_` (exported as ``SystemError`` from
  ``repro_torch.runtime``; trailing underscore avoids shadowing the builtin
  at definition site) — infrastructure faults (compile failure, device
  fault, storage error).  The stack retries / falls back / degrades,
  and only after containment is exhausted do requests fail — still
  with typed outcomes, never a crashed loop.
* :class:`InjectedFault` — what the harness raises at raising sites; a
  ``SystemError_`` subclass so containment paths treat injected and
  organic infrastructure faults identically.

"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "RequestError",
    "SystemError_", "ALL_SITES", "install_plan", "current_plan",
    "should_fault", "maybe_fault", "plan_from_spec",
]


# -- error taxonomy ----------------------------------------------------------

class RequestError(RuntimeError):
    """A failure scoped to one request: reject/complete it with a typed
    error outcome and leave the rest of the batch untouched."""


class SystemError_(RuntimeError):
    """An infrastructure failure (compile, device, storage): retry, fall
    back, or degrade — requests only fail once containment is exhausted."""


class InjectedFault(SystemError_):
    """Raised by armed raising sites; carries the site name."""

    def __init__(self, site: str, ordinal: int):
        super().__init__(f"injected fault at {site!r} (call #{ordinal})")
        self.site = site
        self.ordinal = ordinal


# -- fault sites -------------------------------------------------------------

#: Compile stack: a background/foreground build raises mid-build.
SITE_COMPILE_BUILD = "compile.build"
#: Compile stack: the worker *thread* dies after claiming a job (crash
#: between claim and _finish — strands the future unless reaped).
SITE_COMPILE_WORKER = "compile.worker"
#: Compile stack: a build hangs (sleeps) for ``hang_s`` seconds.
SITE_COMPILE_HANG = "compile.hang"
#: Disk cache: entry read raises OSError (unreadable file).
SITE_DISK_READ = "disk.read"
#: Disk cache: entry write raises OSError (full/read-only disk).
SITE_DISK_WRITE = "disk.write"
#: Disk cache: entry payload is corrupted in flight (checksum trips).
SITE_DISK_CORRUPT = "disk.corrupt"
#: KV paging: PagePool.alloc raises MemoryError before touching state.
SITE_PAGE_ALLOC = "page.alloc"
#: Phase-4 dispatch: one segment/op execution raises mid-program.
SITE_DISPATCH = "dispatch"
#: Decode: one active slot row's logits go non-finite this tick.
SITE_LOGITS_NAN = "logits.nan"
#: Scheduler: a preemption (park) raises before touching any state.
SITE_PREEMPT = "preempt"

ALL_SITES: Tuple[str, ...] = (
    SITE_COMPILE_BUILD, SITE_COMPILE_WORKER, SITE_COMPILE_HANG,
    SITE_DISK_READ, SITE_DISK_WRITE, SITE_DISK_CORRUPT,
    SITE_PAGE_ALLOC, SITE_DISPATCH, SITE_LOGITS_NAN, SITE_PREEMPT,
)


@dataclass
class FaultSpec:
    """How one site fires.  Exactly one of (rate, times, every)."""

    rate: float = 0.0                 # P(fault) per call, seeded stream
    times: Optional[Tuple[int, ...]] = None  # fault on these ordinals (0-based)
    every: int = 0                    # fault on every k-th call (k, 2k, ...)
    max_faults: Optional[int] = None  # stop injecting after this many


@dataclass
class _SiteState:
    spec: FaultSpec
    rng: random.Random
    calls: int = 0
    fired: int = 0


@dataclass
class FaultPlan:
    """A seeded, site-addressable fault schedule.

    >>> plan = FaultPlan(seed=7)
    >>> plan.arm("compile.build", times=(0, 1))   # first two builds fail
    >>> plan.arm("dispatch", rate=0.05)           # 5% of dispatches
    >>> install_plan(plan)
    """

    seed: int = 0
    #: seconds a hung build sleeps when ``compile.hang`` fires
    hang_s: float = 0.05
    _sites: Dict[str, _SiteState] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    _log: List[Tuple[str, int]] = field(default_factory=list)

    def arm(self, site: str, *, rate: float = 0.0,
            times: Optional[Tuple[int, ...]] = None, every: int = 0,
            max_faults: Optional[int] = None) -> "FaultPlan":
        if site not in ALL_SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"one of {ALL_SITES}")
        spec = FaultSpec(rate=rate,
                         times=tuple(times) if times is not None else None,
                         every=every, max_faults=max_faults)
        # independent stream per site: ordering across sites never
        # perturbs a site's own draw sequence
        rng = random.Random(f"{self.seed}|{site}")
        with self._lock:
            self._sites[site] = _SiteState(spec=spec, rng=rng)
        return self

    def check(self, site: str) -> bool:
        """Advance the site's counter; True if this call must fault."""
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                return False
            ordinal = st.calls
            st.calls += 1
            spec = st.spec
            if spec.max_faults is not None and st.fired >= spec.max_faults:
                return False
            fire = False
            if spec.times is not None:
                fire = ordinal in spec.times
            elif spec.every > 0:
                fire = (ordinal + 1) % spec.every == 0
            elif spec.rate > 0.0:
                fire = st.rng.random() < spec.rate
            if fire:
                st.fired += 1
                self._log.append((site, ordinal))
            return fire

    # -- introspection (soak tests / benchmark report) --------------------

    @property
    def faults_injected(self) -> int:
        with self._lock:
            return sum(st.fired for st in self._sites.values())

    @property
    def log(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._log)

    def calls(self, site: str) -> int:
        with self._lock:
            st = self._sites.get(site)
            return st.calls if st is not None else 0

    def fired(self, site: str) -> int:
        with self._lock:
            st = self._sites.get(site)
            return st.fired if st is not None else 0


# -- global plan -------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or, with None, clear) the process-wide plan; returns the
    previous plan so tests can restore it."""
    global _PLAN
    prev = _PLAN
    _PLAN = plan
    return prev


def current_plan() -> Optional[FaultPlan]:
    return _PLAN


def plan_from_spec(spec: str, seed: int = 0) -> FaultPlan:
    """Build a plan from a CLI-style spec string.

    ``"compile.build=0.2,page.alloc=0.1"`` arms two sites at the given
    per-call rates; ``"all=0.05"`` arms every site at once.  A bare site
    name means rate 1.0 (always fault).
    """
    plan = FaultPlan(seed=seed)
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, rate_s = part.partition("=")
        rate = float(rate_s) if rate_s else 1.0
        for s in (ALL_SITES if site == "all" else (site,)):
            plan.arm(s, rate=rate)
    return plan


def should_fault(site: str) -> bool:
    """Hot-path hook: False (one ``is None`` test) when no plan is
    installed; otherwise advances the site counter and reports whether
    this call faults."""
    if _PLAN is None:
        return False
    return _PLAN.check(site)


def maybe_fault(site: str) -> None:
    """Raise :class:`InjectedFault` if the installed plan fires here."""
    if _PLAN is None:
        return
    if _PLAN.check(site):
        # the ordinal just consumed is calls-1
        raise InjectedFault(site, _PLAN.calls(site) - 1)
