"""CalibrationSession — owns the additive activation statistics.

``update`` folds one prefill's Σx² tree in (with exponential decay when
``halflife`` > 0, in updates); ``as_calib`` hands (stats, count) to the
requantization.  ``snapshot``/``fork`` copy the session in O(1): the copy
shares the statistics tree, which ``update`` never writes (it builds new
tensors).  ``merge`` joins two sessions by summing their statistics, exact
since they are additive; sessions with different halflives weight their
statistics differently and refuse to merge.  The reference's guards
(quarantine, rollback) come in a later slice.
"""
from __future__ import annotations

from typing import Any


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


class CalibrationSession:
    def __init__(self, halflife: float = 0.0, stats: Any = None,
                 count: float = 0.0, n_updates: int = 0):
        self.halflife = float(halflife)
        self.stats = stats
        self.count = float(count)
        self.n_updates = int(n_updates)

    def update(self, stats: Any, tokens: float) -> "CalibrationSession":
        """Fold one prefill's statistics in (decayed when halflife > 0)."""
        if self.halflife > 0 and self.stats is not None:
            decay = 0.5 ** (1.0 / self.halflife)
            self.stats = _tree_map(lambda x: x * decay, self.stats)
            self.count *= decay
        self.stats = _tree_add(self.stats, stats)
        self.count += float(tokens)
        self.n_updates += 1
        return self

    def reset(self) -> "CalibrationSession":
        self.stats, self.count, self.n_updates = None, 0.0, 0
        return self

    def snapshot(self) -> "CalibrationSession":
        """A copy sharing the current statistics tree."""
        return CalibrationSession(self.halflife, self.stats, self.count,
                                  self.n_updates)

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
            self.count + other.count, self.n_updates + other.n_updates)

    @property
    def calibrated(self) -> bool:
        return self.stats is not None

    def as_calib(self) -> tuple:
        """(stats, count) for the requantization."""
        return self.stats, max(self.count, 1.0)

    def __repr__(self) -> str:
        return (f"CalibrationSession(count={self.count:.0f}, "
                f"n_updates={self.n_updates}, halflife={self.halflife}, "
                f"calibrated={self.calibrated})")
