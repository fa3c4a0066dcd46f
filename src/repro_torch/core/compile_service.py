"""Background compile service (DESIGN.md §Async compilation) — a copy
of the JAX package's ``core/compile_service.py`` (stdlib and ``chaos``
only).

Cold-bucket dispatches used to compile inline under a per-key build
lock — a tail-latency cliff whenever traffic discovered a new
(batch × seq) cell.  The ``CompileService`` moves all bucket
compilations onto a small worker pool so the dispatch path can submit
the exact key and immediately fall back to a warm dominating bucket
(``BucketedModule`` owns that policy; this module owns only execution).

Contract:

* **Per-key deduplication** — concurrent submits of one key share a
  single :class:`concurrent.futures.Future`; only one worker ever
  builds it (the thundering-herd guarantee).
* **Priority ordering** — foreground-discovered keys (a live request
  is padding into a fallback bucket right now) are drained before
  speculative warmup keys.  ``promote`` upgrades a queued speculative
  job in place when traffic discovers it.
* **Failure containment** (DESIGN.md §Fault tolerance) — a build that
  raises is retried up to ``max_retries`` times with exponential
  backoff; when retries are exhausted every waiter sees the exception
  and (with ``poison_failures``) the key is quarantined so resubmits
  fail fast with the cached error instead of hot-looping rebuilds.
  ``clear_poisoned`` lifts the quarantine (e.g. after an operator
  fixes the underlying cause).  With ``poison_failures=False`` the key
  is simply forgotten, so a later submit retries from scratch.
* **Worker resurrection** — a worker thread that dies on an unexpected
  exception (outside the build ``try``) would otherwise strand its
  claimed job's future and silently shrink the pool.  Every public
  entry point reaps: dead workers are respawned
  (``stats.worker_restarts``) and their stranded claimed jobs are
  requeued (``stats.requeued``).
* **Hang abandonment** — with ``hang_timeout_s`` set, a build running
  past the deadline is written off: its future resolves with a
  :class:`repro_torch.runtime.chaos.SystemError_`, the hung thread is left
  to finish in the background (its late result is dropped), and a
  replacement worker restores pool capacity.

Chaos hooks (``repro_torch.runtime.chaos``): ``compile.build`` fails a build
attempt, ``compile.hang`` makes one sleep, ``compile.worker`` kills
the worker thread *after* it claims a job — the exact crash window the
reaper exists for.

Workers are daemon threads.  In the port a build is ``torch.export``
and the Forge passes, pure Python that holds the GIL; the port's
``BucketedModule`` serializes Phases 1-3 under one build lock anyway
(concurrent exports are not known to be sound), so the pool buys
overlap with the serving thread, not parallel builds.  A compiled
program cannot cross a process boundary (it holds closures and, on the
card, CUDA graphs), which rules out a subprocess pool.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..runtime import chaos
from ..runtime.chaos import SystemError_

#: drain order: every foreground job before any speculative job
PRIORITY_FOREGROUND = 0
PRIORITY_SPECULATIVE = 1


@dataclass
class CompileServiceStats:
    submitted: int = 0          #: distinct jobs accepted (post-dedup)
    dedup_hits: int = 0         #: submits coalesced onto an existing job
    promoted: int = 0           #: speculative jobs upgraded to foreground
    completed: int = 0          #: builds that returned a value
    failed: int = 0             #: builds that failed for good (post-retry)
    retries: int = 0            #: failed attempts re-enqueued with backoff
    poisoned: int = 0           #: keys quarantined after exhausting retries
    poison_hits: int = 0        #: submits rejected fast by the quarantine
    worker_restarts: int = 0    #: dead/hung workers replaced by the reaper
    requeued: int = 0           #: claimed jobs rescued from dead workers
    hangs_abandoned: int = 0    #: builds written off past hang_timeout_s
    busy_s: float = 0.0         #: summed worker wall time inside builds
    peak_queued: int = 0        #: high-water mark of jobs waiting + running

    def snapshot(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass(order=True)
class _Job:
    priority: int
    seq: int
    key: str = field(compare=False)
    #: the claim flag: nulled when a worker picks the job up (heap twins
    #: left behind by promotion become tombstones)
    build: Optional[Callable[[], Any]] = field(compare=False, default=None)
    #: the persistent build fn — survives the claim so retries and
    #: dead-worker rescues can re-run it
    build_fn: Optional[Callable[[], Any]] = field(compare=False, default=None)
    future: Optional[Future] = field(compare=False, default=None)
    #: a promoted job leaves its old heap entry behind as a tombstone
    stale: bool = field(compare=False, default=False)
    attempt: int = field(compare=False, default=0)
    claimed_by: Optional[threading.Thread] = field(compare=False,
                                                  default=None)
    claimed_at: float = field(compare=False, default=0.0)
    #: set by the reaper when a hung build is written off: the late
    #: worker result is dropped instead of double-resolving
    abandoned: bool = field(compare=False, default=False)


class CompileService:
    """Priority worker pool with per-key future deduplication."""

    def __init__(
        self,
        workers: int = 2,
        name: str = "forge-compile",
        *,
        max_retries: int = 2,
        retry_backoff_s: float = 0.01,
        poison_failures: bool = True,
        hang_timeout_s: Optional[float] = None,
    ):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.stats = CompileServiceStats()
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.poison_failures = poison_failures
        self.hang_timeout_s = hang_timeout_s
        self._name = name
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._heap: List[_Job] = []
        #: key -> live job (queued or running); the dedup table
        self._jobs: Dict[str, _Job] = {}
        #: key -> terminal exception; submits of these fail fast
        self._poisoned: Dict[str, BaseException] = {}
        self._seq = itertools.count()
        self._spawned = itertools.count()
        self._shutdown = False
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._threads = [self._spawn_locked() for _ in range(workers)]

    def _spawn_locked(self) -> threading.Thread:
        t = threading.Thread(
            target=self._worker,
            name=f"{self._name}-{next(self._spawned)}",
            daemon=True,
        )
        t.start()
        return t

    # ------------------------------------------------------------------
    # submission API
    # ------------------------------------------------------------------
    def submit(
        self,
        key: str,
        build: Callable[[], Any],
        *,
        foreground: bool = True,
    ) -> Future:
        """Enqueue ``build`` under ``key``; returns the shared future.

        A second submit of a live key returns the existing future
        (``build`` is dropped); a foreground re-submit of a queued
        speculative key promotes it to the front of the line.  A submit
        of a poisoned key returns a future already resolved with the
        quarantined exception.
        """
        priority = PRIORITY_FOREGROUND if foreground else PRIORITY_SPECULATIVE
        with self._lock:
            if self._shutdown:
                raise RuntimeError("CompileService is shut down")
            resolve = self._reap_locked()
            exc = self._poisoned.get(key)
            if exc is not None:
                self.stats.poison_hits += 1
                f: Future = Future()
                f.set_exception(exc)
                self._resolve(resolve)
                return f
            job = self._jobs.get(key)
            if job is not None:
                self.stats.dedup_hits += 1
                if foreground and job.priority == PRIORITY_SPECULATIVE:
                    self._promote_locked(job)
                self._resolve(resolve)
                return job.future
            job = _Job(
                priority=priority,
                seq=next(self._seq),
                key=key,
                build=build,
                build_fn=build,
                future=Future(),
            )
            self._jobs[key] = job
            heapq.heappush(self._heap, job)
            self.stats.submitted += 1
            self.stats.peak_queued = max(
                self.stats.peak_queued, len(self._jobs)
            )
            self._wake.notify()
            self._resolve(resolve)
            return job.future

    def promote(self, key: str) -> bool:
        """Upgrade a queued speculative key to foreground priority."""
        with self._lock:
            job = self._jobs.get(key)
            if job is None or job.priority != PRIORITY_SPECULATIVE:
                return False
            self._promote_locked(job)
            return True

    def _promote_locked(self, job: _Job) -> None:
        # Re-push a foreground twin and tombstone the speculative entry;
        # heapq has no decrease-key.  Running jobs are past the queue.
        if job.stale or job.build is None:
            return
        job.stale = True
        twin = _Job(
            priority=PRIORITY_FOREGROUND,
            seq=next(self._seq),
            key=job.key,
            build=job.build,
            build_fn=job.build_fn,
            future=job.future,
        )
        self._jobs[job.key] = twin
        heapq.heappush(self._heap, twin)
        self.stats.promoted += 1
        self._wake.notify()

    def pending(self) -> int:
        """Jobs queued or building right now."""
        with self._lock:
            resolve = self._reap_locked()
            n = len(self._jobs)
            self._resolve(resolve)
            return n

    def lookup(self, key: str) -> Optional[Future]:
        """The live future for ``key``, if a build is queued/running."""
        with self._lock:
            job = self._jobs.get(key)
            return job.future if job is not None else None

    # ------------------------------------------------------------------
    # quarantine
    # ------------------------------------------------------------------
    def poisoned_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._poisoned)

    def clear_poisoned(self, key: Optional[str] = None) -> int:
        """Lift the quarantine for ``key`` (or all keys); returns the
        number of keys cleared so the next submit rebuilds."""
        with self._lock:
            if key is None:
                n = len(self._poisoned)
                self._poisoned.clear()
                return n
            return 1 if self._poisoned.pop(key, None) is not None else 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def reap(self) -> None:
        """Respawn dead workers, rescue their claimed jobs, write off
        hung builds.  Called implicitly by submit/pending/wait_idle."""
        with self._lock:
            resolve = self._reap_locked()
        self._resolve(resolve)

    def result(self, fut: Future, timeout: Optional[float] = None,
               poll_s: float = 0.05) -> Any:
        """``fut.result()`` that keeps reaping while it waits, so a
        caller blocked on a build can't deadlock behind a dead or hung
        worker."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = poll_s
            if deadline is not None:
                remaining = min(poll_s, deadline - time.monotonic())
                if remaining <= 0:
                    return fut.result(timeout=0)  # raises FutureTimeout
            try:
                return fut.result(timeout=remaining)
            except FutureTimeout:
                self.reap()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no jobs are queued or running.  True on success."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._jobs or self._inflight:
                resolve = self._reap_locked()
                self._resolve(resolve)
                if not (self._jobs or self._inflight):
                    return True
                remaining = 0.05
                if deadline is not None:
                    remaining = min(0.05, deadline - time.monotonic())
                    if remaining <= 0:
                        return False
                self._idle.wait(remaining)
            return True

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            # cancel queued (not yet running) jobs so waiters unblock
            for job in self._heap:
                if not job.stale and job.build is not None:
                    job.build = None
                    job.build_fn = None
                    self._jobs.pop(job.key, None)
                    job.future.cancel()
            self._heap.clear()
            self._wake.notify_all()
            self._idle.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=30.0)

    # ------------------------------------------------------------------
    # reaper
    # ------------------------------------------------------------------
    def _reap_locked(self) -> List[Tuple[Future, BaseException]]:
        """Must hold ``self._lock``.  Returns futures to resolve AFTER
        the lock is released (done-callbacks may call back in)."""
        resolve: List[Tuple[Future, BaseException]] = []
        if self._shutdown:
            return resolve
        for i, t in enumerate(self._threads):
            if not t.is_alive():
                self._threads[i] = self._spawn_locked()
                self.stats.worker_restarts += 1
        now = time.monotonic()
        for job in list(self._jobs.values()):
            th = job.claimed_by
            if th is None or job.abandoned or job.future.done():
                continue
            if not th.is_alive():
                # crashed after claiming: undo the claim, requeue
                self._inflight -= 1
                job.claimed_by = None
                job.build = job.build_fn
                heapq.heappush(self._heap, job)
                self.stats.requeued += 1
                self._wake.notify()
            elif (self.hang_timeout_s is not None
                  and now - job.claimed_at > self.hang_timeout_s):
                # hung: write the build off; the stuck thread keeps the
                # claim (its late result is dropped via .abandoned) and
                # a fresh worker restores pool capacity
                job.abandoned = True
                self._inflight -= 1
                del self._jobs[job.key]
                self.stats.hangs_abandoned += 1
                self._threads.append(self._spawn_locked())
                self.stats.worker_restarts += 1
                resolve.append((job.future, SystemError_(
                    f"build {job.key!r} exceeded hang timeout "
                    f"{self.hang_timeout_s:.2f}s; abandoned"
                )))
        if not (self._jobs or self._inflight):
            self._idle.notify_all()
        return resolve

    @staticmethod
    def _resolve(resolve: List[Tuple[Future, BaseException]]) -> None:
        for fut, exc in resolve:
            if not fut.done():
                fut.set_exception(exc)

    # ------------------------------------------------------------------
    # worker loop
    # ------------------------------------------------------------------
    def _worker(self) -> None:
        while True:
            with self._wake:
                while not self._heap and not self._shutdown:
                    self._wake.wait()
                if self._shutdown and not self._heap:
                    return
                job = heapq.heappop(self._heap)
                if job.stale or job.build is None:
                    continue
                build = job.build
                job.build = None  # claim: any heap twin is now a tombstone
                job.claimed_by = threading.current_thread()
                job.claimed_at = time.monotonic()
                self._inflight += 1
            if chaos.should_fault(chaos.SITE_COMPILE_WORKER):
                # simulated worker crash in the claim window: the thread
                # dies without ever reaching _finish; the reaper must
                # notice the dead thread and rescue this job
                return
            t0 = time.perf_counter()
            try:
                chaos.maybe_fault(chaos.SITE_COMPILE_BUILD)
                plan = chaos.current_plan()
                if plan is not None and plan.check(chaos.SITE_COMPILE_HANG):
                    time.sleep(plan.hang_s)
                result = build()
            except BaseException as exc:  # noqa: BLE001 — relay to waiters
                self._finish(job, err=exc, dt=time.perf_counter() - t0)
            else:
                self._finish(job, result=result, dt=time.perf_counter() - t0)

    def _requeue(self, job: _Job) -> None:
        """Timer callback: put a failed job back in line for a retry."""
        with self._lock:
            if self._shutdown or job.abandoned:
                if not job.future.done():
                    job.future.cancel()
                self._jobs.pop(job.key, None)
                self._idle.notify_all()
                return
            job.claimed_by = None
            job.build = job.build_fn
            heapq.heappush(self._heap, job)
            self._wake.notify()

    def _finish(
        self,
        job: _Job,
        *,
        result: Any = None,
        err: Optional[BaseException] = None,
        dt: float = 0.0,
    ) -> None:
        retry_delay: Optional[float] = None
        with self._lock:
            self.stats.busy_s += dt
            if job.abandoned:
                # the reaper already resolved this future with a timeout
                # error and fixed the books; drop the late result
                self._idle.notify_all()
                return
            self._inflight -= 1
            job.claimed_by = None
            retryable = (
                err is not None
                and not self._shutdown
                and job.attempt < self.max_retries
                and not isinstance(err, (KeyboardInterrupt, SystemExit))
            )
            if retryable:
                job.attempt += 1
                self.stats.retries += 1
                # exponential backoff; the key stays in _jobs so submits
                # keep deduping onto the pending retry
                retry_delay = self.retry_backoff_s * (2 ** (job.attempt - 1))
            else:
                # forget the key first so a post-failure resubmit retries
                live = self._jobs.get(job.key)
                if live is not None and live.future is job.future:
                    del self._jobs[job.key]
                if err is not None:
                    self.stats.failed += 1
                    if self.poison_failures:
                        self._poisoned[job.key] = err
                        self.stats.poisoned += 1
                else:
                    self.stats.completed += 1
                self._idle.notify_all()
        if retry_delay is not None:
            t = threading.Timer(retry_delay, self._requeue, args=(job,))
            t.daemon = True
            t.start()
            return
        # resolve outside the lock: done-callbacks may call back in
        if err is not None:
            job.future.set_exception(err)
        else:
            job.future.set_result(result)


#: lazily created process-default service (serve/CLI convenience);
#: tests and servers that want their own pool construct one directly
_DEFAULT: Optional[CompileService] = None
_DEFAULT_LOCK = threading.Lock()


def get_compile_service(workers: int = 2) -> CompileService:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = CompileService(workers=workers)
        return _DEFAULT
