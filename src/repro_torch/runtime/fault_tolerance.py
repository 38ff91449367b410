"""Fault tolerance for training runs, port of
``repro.runtime.fault_tolerance`` (pure Python, copied, on the port's
:class:`~repro_torch.checkpoint.checkpointer.Checkpointer`).

  * ``StepWatchdog``: straggler detection, flags steps slower than
    ``factor × p50`` over a rolling window;
  * ``RestartableLoop``: the training loop as a restartable state machine;
    on a :class:`NodeFailure` it restores the last published checkpoint and
    resumes (bounded retry budget);
  * ``FailureInjector``: deterministic failures for tests, raised at
    configured steps to simulate preemptions or node loss.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer

log = logging.getLogger("repro_torch.fault_tolerance")

__all__ = ["StepWatchdog", "FailureInjector", "RestartableLoop", "NodeFailure",
           "LoopResult"]


class NodeFailure(RuntimeError):
    """Simulated node loss / preemption."""


class StepWatchdog:
    def __init__(self, window: int = 32, straggler_factor: float = 3.0):
        self.times: deque[float] = deque(maxlen=window)
        self.factor = straggler_factor
        self.stragglers: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if it is a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            p50 = sorted(self.times)[len(self.times) // 2]
            if dt > self.factor * p50:
                is_straggler = True
                self.stragglers.append((step, dt))
                log.warning("straggler step %d: %.3fs (p50 %.3fs)", step, dt, p50)
        self.times.append(dt)
        return is_straggler


class FailureInjector:
    def __init__(self, fail_at_steps: tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise NodeFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class LoopResult:
    final_step: int
    restarts: int
    metrics: list[dict]
    stragglers: list[tuple[int, float]]
    # The checkpointer's record of its saves and restores (port only).
    checkpoints: list[dict] = dataclasses.field(default_factory=list)


class RestartableLoop:
    """Checkpoint/restart training loop.

    ``step_fn(state, step) -> (state, metrics)`` must be a pure update of
    ``state = (params, opt_state)``; the data is a function of the step
    index (:mod:`repro_torch.data.synthetic`), so restarts are bit-exact.
    """

    def __init__(self, checkpointer: Checkpointer, *, ckpt_every: int = 10,
                 max_restarts: int = 5):
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts

    def run(self, state: Any, step_fn: Callable, total_steps: int,
            *, injector: Optional[FailureInjector] = None,
            watchdog: Optional[StepWatchdog] = None) -> tuple[Any, LoopResult]:
        watchdog = watchdog or StepWatchdog()
        restarts = 0
        metrics: list[dict] = []
        step = 0
        # resume from the latest checkpoint if one exists
        s0, restored = self.ckpt.restore_latest(state)
        if restored is not None:
            state, step = restored, s0
            log.info("resumed from checkpoint step %d", step)
        # Only ``state`` may hold a state while the loop runs: another name
        # bound to an old one keeps a second copy alive (GBs on a card).
        restored = None

        while step < total_steps:
            try:
                t0 = time.time()
                if injector is not None:
                    injector.maybe_fail(step)
                state, m = step_fn(state, step)
                watchdog.observe(step, time.time() - t0)
                metrics.append({"step": step, **m})
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except NodeFailure as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                log.warning("restart %d after %r", restarts, e)
                self.ckpt.wait()
                s0, restored = self.ckpt.restore_latest(state)
                if restored is not None:
                    state, step = restored, s0
                else:
                    step = 0  # no checkpoint yet: restart from scratch
                restored = None
        self.ckpt.wait()
        return state, LoopResult(final_step=step, restarts=restarts,
                                 metrics=metrics, stragglers=watchdog.stragglers,
                                 checkpoints=self.ckpt.history)
