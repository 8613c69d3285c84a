"""QuantizedModel — the calibrate → requantize → decode_params facade.

Owns the :class:`CalibrationSession`, the :class:`FusedRequantPlan` (built
on the first requantize, reused after) and the current quantized tree.
Each requant after the first lands in the previous tree's storage, where a
captured decode graph reads it (``serving/runner.py``): a tree returned
earlier changes with it.  A rebuilt plan (new statistics structure) makes
a fresh tree.
The reference's delta gate, double buffering, low-rank factors, draft tree
and health gate come in later slices.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.awq import AWQConfig
from repro_torch.core.policy import QuantPolicy

from .api import FusedRequantPlan
from .registry import get_quantizer
from .session import CalibrationSession


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return tuple(_structure(v) for v in tree)
    return None


class QuantizedModel:
    def __init__(self, params: Any, policy: QuantPolicy, *,
                 acfg: Optional[AWQConfig] = None, halflife: float = 0.0,
                 session: Optional[CalibrationSession] = None):
        self.params = params
        self.policy = policy
        self.acfg = acfg
        self.session = session if session is not None else \
            CalibrationSession(halflife=halflife)
        self.qparams = None
        self.n_requants = 0
        self._plan: Optional[FusedRequantPlan] = None
        self._plan_key = None

    def calibrate(self, stats: Any, tokens: float) -> "QuantizedModel":
        """Fold one prefill's activation statistics into the session."""
        self.session.update(stats, tokens)
        return self

    def _active(self) -> bool:
        active = [q for q in map(get_quantizer, self.policy.methods())
                  if q.enabled]
        if not active:
            return False
        return self.session.calibrated or not all(q.requires_stats
                                                  for q in active)

    def requantize(self, threshold: Optional[float] = None):
        """Quantize from the session's statistics; returns the tree, or None
        when every method is disabled or statistics are still missing."""
        if threshold is not None:
            raise NotImplementedError(
                "requantize(threshold=...) — the delta gate — is ported in a "
                "later slice")
        if not self._active():
            return None
        stats, count = self.session.as_calib()
        key = _structure(stats)
        into = self.qparams
        if self._plan_key != key:
            self._plan = FusedRequantPlan(self.params, stats, self.policy,
                                          acfg=self.acfg)
            self._plan_key = key
            into = None
        self.qparams = self._plan.run(self.params, stats, count, into=into)
        self.n_requants += 1
        return self.qparams

    @property
    def decode_params(self):
        """The latest quantized tree; the fp parameters before the first."""
        return self.qparams if self.qparams is not None else self.params
