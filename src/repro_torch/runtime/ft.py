"""Fault-tolerance pieces of the training loop (``repro.runtime.ft``): the
per-step deadline monitor and deterministic failure injection.  Process
local; the Trainer's state machine is monitor → detect (deadline /
injected fault) → recover (restart from checkpoint | log and go on).
Elastic re-meshing (``ElasticController``) waits for tensor parallelism
(ROADMAP A10 (d))."""
from __future__ import annotations

import time
from typing import Callable, Optional


class StepMonitor:
    """Per-step deadline watchdog. Stores (step, duration) of violations."""

    def __init__(self, deadline_s: float,
                 on_straggle: Optional[Callable[[int, float], None]] = None):
        self.deadline = deadline_s
        self.violations: list = []
        self.on_straggle = on_straggle
        self._t0 = 0.0

    def start(self):
        self._t0 = time.monotonic()

    def finish(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        if self.deadline > 0 and dt > self.deadline:
            self.violations.append((step, dt))
            if self.on_straggle:
                self.on_straggle(step, dt)
            return True
        return False


class FailureInjector:
    """Deterministic fault injection for FT tests: raises at chosen steps
    (once each)."""

    class Crash(RuntimeError):
        pass

    def __init__(self, fail_at: set):
        self.fail_at = set(fail_at)
        self.fired: set = set()

    def __call__(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise FailureInjector.Crash(f"injected failure at step {step}")
