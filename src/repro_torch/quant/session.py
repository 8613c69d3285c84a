"""CalibrationSession — owns the additive activation statistics.

``update`` folds one prefill's Σx² tree in (with exponential decay when
``halflife`` > 0, in updates); ``as_calib`` hands (stats, count) to the
requantization.  ``snapshot``/``fork`` copy the session in O(1): the copy
shares the statistics tree, which ``update`` never writes (it builds new
tensors).  ``merge`` joins two sessions by summing their statistics, exact
since they are additive; sessions with different halflives weight their
statistics differently and refuse to merge.

**Poisoning defense:** constructed with a
:class:`~repro_torch.quant.guards.GuardConfig`, every ``update`` is
validated before it folds.  Non-finite statistics, a bad token count, or a
per-token magnitude beyond ``calib_outlier_factor`` × the running one (once
``calib_warmup_updates`` updates were accepted) is *quarantined* (a bounded
log of :class:`QuarantineRecord`, ``n_rejected``) instead of folded.  Each
accepted fold pushes the state before it onto a bounded last-good ring, so
``rollback(n)`` restores the state before the last n accepted updates.
The ring may hold references: a fold builds new tensors and never writes
the old ones.  Without a guard the session folds everything, as before.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional, Tuple

from .guards import GuardConfig, stats_summary, token_count_ok


def _tree_map(fn, *trees):
    a = trees[0]
    if isinstance(a, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _tree_add(a: Any, b: Any) -> Any:
    """a + b as new tensors; a copy of ``b`` when ``a`` is None.  Never the
    caller's tensors: a prefill graph's statistics are its static outputs,
    which its next replay overwrites."""
    if a is None:
        return None if b is None else _tree_map(lambda x: x.clone(), b)
    if b is None:
        return a
    return _tree_map(lambda x, y: x + y, a, b)


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One rejected calibration update: why, at which update index, which
    request ids produced it, and its measured mean |stat|."""
    reason: str                  # "non-finite-stats" | "bad-token-count"
                                 # | "outlier-stats"
    tokens: float                # claimed token count of the update
    update_idx: int              # n_updates at rejection time
    provenance: Tuple[int, ...]  # request ids that produced the stats
    mean_abs: float              # measured mean |stat| of the update


class CalibrationSession:
    def __init__(self, halflife: float = 0.0, stats: Any = None,
                 count: float = 0.0, n_updates: int = 0,
                 guard: Optional[GuardConfig] = None):
        self.halflife = float(halflife)
        self.stats = stats
        self.count = float(count)
        self.n_updates = int(n_updates)
        self.guard = guard
        self.n_rejected = 0
        self.quarantine: deque = deque(
            maxlen=guard.quarantine_max if guard is not None else 16)
        # (stats, count, n_updates) before each accepted fold, newest last
        self._ring: deque = deque(
            maxlen=guard.snapshot_ring if guard is not None else 4)

    def _validate(self, stats: Any, tokens: float) -> Tuple[str, float]:
        """(reason, mean_abs); an empty reason accepts.  One summary of the
        update and, once the outlier gate is armed, one of the running
        statistics."""
        if not token_count_ok(tokens):
            return "bad-token-count", 0.0
        fin, mean = stats_summary(stats)
        if not fin:
            return "non-finite-stats", mean
        g = self.guard
        if (self.stats is not None and self.n_updates >= g.calib_warmup_updates
                and g.calib_outlier_factor > 0):
            _, run_mean = stats_summary(self.stats)
            run_rate = run_mean / max(self.count, 1.0)
            rate = mean / float(tokens)
            if run_rate > 0 and rate > g.calib_outlier_factor * run_rate:
                return "outlier-stats", mean
        return "", mean

    def update(self, stats: Any, tokens: float,
               provenance: Tuple[int, ...] = ()) -> "CalibrationSession":
        """Fold one prefill's statistics in (decayed when halflife > 0).
        With a guard the update is validated first; a rejected one is
        quarantined with ``provenance`` (the request ids) and leaves the
        session as it was."""
        if self.guard is not None:
            reason, mean = self._validate(stats, tokens)
            if reason:
                self.n_rejected += 1
                self.quarantine.append(QuarantineRecord(
                    reason, float(tokens) if token_count_ok(tokens)
                    else float("nan"), self.n_updates, tuple(provenance),
                    mean))
                return self
            self._ring.append((self.stats, self.count, self.n_updates))
        if self.halflife > 0 and self.stats is not None:
            decay = 0.5 ** (1.0 / self.halflife)
            self.stats = _tree_map(lambda x: x * decay, self.stats)
            self.count *= decay
        self.stats = _tree_add(self.stats, stats)
        self.count += float(tokens)
        self.n_updates += 1
        return self

    def rollback(self, n: int = 1) -> int:
        """Restore the state before the last ``n`` accepted updates (at most
        the ring's depth); returns how many were undone (0 without a guard
        or before the first accepted update)."""
        undone = 0
        for _ in range(n):
            if not self._ring:
                break
            self.stats, self.count, self.n_updates = self._ring.pop()
            undone += 1
        return undone

    def reset(self) -> "CalibrationSession":
        self.stats, self.count, self.n_updates = None, 0.0, 0
        self._ring.clear()
        return self

    def snapshot(self) -> "CalibrationSession":
        """A copy sharing the current statistics tree (with its own, empty,
        quarantine and ring)."""
        return CalibrationSession(self.halflife, self.stats, self.count,
                                  self.n_updates, guard=self.guard)

    fork = snapshot

    def merge(self, other: "CalibrationSession") -> "CalibrationSession":
        """A new session holding the sum of both sessions' statistics."""
        if self.halflife != other.halflife:
            raise ValueError(
                f"cannot merge sessions with different halflives "
                f"({self.halflife} vs {other.halflife}): their statistics "
                f"carry incompatible decay weighting — fork from one parent "
                f"or resample one stream")
        return CalibrationSession(
            self.halflife, _tree_add(self.stats, other.stats),
            self.count + other.count, self.n_updates + other.n_updates,
            guard=self.guard)

    @property
    def calibrated(self) -> bool:
        return self.stats is not None

    def as_calib(self) -> tuple:
        """(stats, count) for the requantization."""
        return self.stats, max(self.count, 1.0)

    def __repr__(self) -> str:
        extra = (f", rejected={self.n_rejected}"
                 if self.guard is not None else "")
        return (f"CalibrationSession(count={self.count:.0f}, "
                f"n_updates={self.n_updates}, halflife={self.halflife}, "
                f"calibrated={self.calibrated}{extra})")
