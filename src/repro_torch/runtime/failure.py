"""Fault tolerance: the step supervisor (a copy of the JAX package's
``runtime/failure.py``; pure Python).

``Supervisor.run`` drives the training loop with checkpoint/restart
semantics:

* transient step failures (preemption signals, collective timeouts —
  anything raising) are retried up to ``max_retries`` by restoring the
  last checkpoint and replaying the deterministic data stream from the
  restored step (``TokenDataset`` is stateless given (seed, step)),
* repeated failures at the same step escalate (raise) — a real fleet
  controller would then reschedule the job,
* an injectable ``fault_hook(step)`` lets tests simulate node failures
  at chosen steps (see tests/test_torch_data_ckpt.py).

``restore_fn`` reloads the last checkpoint onto the devices of the
running job (see checkpoint/manager.py).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger("repro_torch.runtime")


@dataclass
class SupervisorReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    history: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class Supervisor:
    """Checkpoint/restart loop around an arbitrary step function."""

    step_fn: Callable[[Any, Any], Tuple[Any, Dict[str, Any]]]
    data_fn: Callable[[int], Any]  # step -> batch (deterministic)
    save_fn: Callable[[int, Any], None]
    restore_fn: Callable[[], Tuple[Any, int]]  # -> (state, step)
    checkpoint_every: int = 50
    max_retries: int = 3
    fault_hook: Optional[Callable[[int], None]] = None  # test injection

    def run(self, state: Any, start_step: int, n_steps: int
            ) -> Tuple[Any, SupervisorReport]:
        report = SupervisorReport()
        step = start_step
        retries_at_step: Dict[int, int] = {}
        while step < start_step + n_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.data_fn(step)
                state, metrics = self.step_fn(state, batch)
                report.steps_run += 1
                report.history.append({"step": step, **metrics})
                step += 1
                if step % self.checkpoint_every == 0:
                    self.save_fn(step, state)
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                report.failures += 1
                n = retries_at_step.get(step, 0) + 1
                retries_at_step[step] = n
                log.warning("step %d failed (%s), retry %d/%d",
                            step, e, n, self.max_retries)
                if n > self.max_retries:
                    raise RuntimeError(
                        f"step {step} failed {n} times; escalating"
                    ) from e
                state, restored_step = self.restore_fn()
                report.restores += 1
                step = restored_step
        return state, report


class SimulatedFault(RuntimeError):
    """Raised by test fault hooks to emulate node loss / preemption."""
