"""Failure injection + checkpoint/restart training harness.

``run_with_restarts`` is the supervisor a real launcher wraps around the
training loop: it restores the newest complete checkpoint, runs until a
(possibly injected) failure, and restarts — asserting forward progress.
Deterministic data order across restarts comes from deriving the batch from
the step counter (the framework's data pipeline is step-indexed), so a
killed-and-restarted run reproduces the uninterrupted loss trajectory
bit-for-bit. A copy of the JAX package's ``ft/failures.py`` over the
port's ``CheckpointManager``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..checkpoint import CheckpointManager


@dataclass
class FailureInjector:
    """Deterministically fail at given global steps (once each)."""
    fail_at: set = field(default_factory=set)
    fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def run_with_restarts(
    init_state_fn: Callable[[], object],
    step_fn: Callable[[object, int], tuple[object, dict]],
    manager: CheckpointManager,
    total_steps: int,
    checkpoint_every: int = 10,
    injector: FailureInjector | None = None,
    max_restarts: int = 10,
) -> tuple[object, list[dict], int]:
    """Returns (final_state, per-step metrics, restart_count).

    step_fn(state, step) -> (state, metrics). State must be a pytree;
    the supervisor owns checkpoint cadence and crash recovery.
    """
    restarts = 0
    metrics_log: list[dict] = []
    while True:
        # ---- (re)start: restore or init ----
        template = init_state_fn()
        try:
            state, start_step = manager.restore(template)
            start_step += 1
        except FileNotFoundError:
            state, start_step = template, 0
        try:
            for step in range(start_step, total_steps):
                if injector is not None:
                    injector.check(step)
                state, m = step_fn(state, step)
                m = dict(m)
                m["step"] = step
                metrics_log.append(m)
                if (step + 1) % checkpoint_every == 0 or step == total_steps - 1:
                    manager.save(step, state)
            return state, metrics_log, restarts
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            # loop -> restore from newest complete checkpoint
