"""Fault-tolerance pieces of the training loop (``repro.runtime.ft``): the
per-step deadline monitor, deterministic failure injection, and elastic
re-meshing (``ElasticController``: a checkpoint restored onto a mesh of
another shape).  The Trainer's state machine is monitor → detect
(deadline / injected fault) → recover (restart from checkpoint, on the
same mesh or another | log and go on)."""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch._tree import tree_map
from repro_torch.checkpoint import CheckpointManager, reshard_restore
from repro_torch.parallel import NamedSharding, ParallelCtx, param_sharding
from repro_torch.parallel.rules import P


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


class ElasticController:
    """Elastic scaling: resume a checkpoint onto a different mesh.

    ``rescale(ckpt, step, params_like, opt_like, new_pctx)`` reads the
    checkpoint's 'params' (and 'opt') and gives this rank its slice of
    every leaf on the new mesh: the recovery path when ranks are lost
    (shrink) or added (grow).  ``params_like`` and ``opt_like`` are
    global-shaped templates (dtypes and the device of the result);
    ``new_pctx`` is read as bound (``rules.bind``) where it is, so the
    parameters are placed as the Trainer on that mesh places them.  The
    optimizer state comes replicated, or as ``opt_sharding_fn(opt_like,
    pshard, new_pctx)`` places it (the Trainer's ZeRO-1:
    ``lambda o, p, c: opt_sharding(o, p, c, True)``)."""

    @staticmethod
    def rescale(ckpt: CheckpointManager, step: int, params_like, opt_like,
                new_pctx: ParallelCtx, opt_sharding_fn=None):
        pshard = param_sharding(params_like, new_pctx)
        like = {"params": params_like}
        shard = {"params": tree_map(lambda l, ps: NamedSharding(new_pctx, ps),
                                    params_like, pshard)}
        if opt_like is not None:
            if opt_sharding_fn is None:
                oshard = tree_map(lambda l: NamedSharding(
                    new_pctx, P(*([None] * l.dim()))), opt_like)
            else:
                oshard = opt_sharding_fn(opt_like, pshard, new_pctx)
            like["opt"] = opt_like
            shard["opt"] = oshard
        out = reshard_restore(ckpt, step, like, shard)
        return out["params"], out.get("opt")
