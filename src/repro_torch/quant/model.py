"""QuantizedModel — the calibrate → requantize → decode_params facade.

Owns the :class:`CalibrationSession`, the data-free low-rank factor tree
(computed once, at construction; a requant never re-runs the SVD), the
:class:`FusedRequantPlan` (built on the first requantize, reused after) and
the quantized tree(s).

* **In place** (default): each requant after the first lands in the
  previous tree's storage, where a captured decode graph reads it
  (``serving/runner.py``): a tree returned earlier changes with it.  A
  rebuilt plan (new statistics structure) makes a fresh tree.
* **Delta gate**: ``requantize(threshold=…)`` requantizes only the families
  whose activation diagonal D drifted (relative L2) by at least the
  threshold since their last quantization (0 → all, ∞ → none); the others
  keep their codes.
* **Double buffer** (``double_buffer=True``): two trees that share no
  storage a requant writes.  A requant after the first writes into the tree
  decode is not reading, on a side stream that first waits for everything
  enqueued before it (the last block against that tree, and the prefill
  that produced the statistics) and then records a completion event;
  ``decode_params`` swaps to that tree once the event's ``query()`` is
  true.  Emitted tokens then depend on device timing (which block sees the
  swap), so it is opt-in.  A family the gate skips is copied into the
  written tree from the tree holding its newest codes.  Each tree gets its
  own decode graph.  On the CPU a written tree is ready at once.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from repro_torch.core.awq import AWQConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.ttq import QuantizedTensor

from .api import FusedRequantPlan, _tree_get, _walk, lowrank_tree
from .registry import get_quantizer
from .session import CalibrationSession

_AUTO = object()   # sentinel: compute the low-rank tree from the policy
_WRITTEN = ("wint", "packed", "scale", "zero", "dinv")   # a requant's fields


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return tuple(_structure(v) for v in tree)
    return None


def _clone_written(tree):
    """A copy of ``tree`` with new storage for every field a requant writes;
    full-precision leaves and the low-rank factors (never written) shared."""
    if isinstance(tree, dict):
        return {k: _clone_written(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_written(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(**{
            f: (None if getattr(tree, f) is None else getattr(tree, f).clone())
            for f in _WRITTEN}, B=tree.B, A=tree.A, bits=tree.bits,
            group_size=tree.group_size, out_features=tree.out_features,
            in_features=tree.in_features)
    return tree


class QuantizedModel:
    def __init__(self, params: Any, policy: QuantPolicy, *,
                 acfg: Optional[AWQConfig] = None, halflife: float = 0.0,
                 session: Optional[CalibrationSession] = None,
                 lowrank: Any = _AUTO, double_buffer: bool = False):
        self.params = params
        self.policy = policy
        self.acfg = acfg
        self.double_buffer = double_buffer
        self.session = session if session is not None else \
            CalibrationSession(halflife=halflife)
        if lowrank is _AUTO:
            self.lowrank_tree = lowrank_tree(params, policy) \
                if policy.any_enabled else None
        else:
            self.lowrank_tree = lowrank
        self.qparams = None
        self.n_requants = 0
        self._plan: Optional[FusedRequantPlan] = None
        self._plan_key = None
        self._qt_by_path: dict = {}      # path → QuantizedTensor with the
                                         # newest codes of that path
        self._last_D: dict = {}          # path → D at its last requant
        self._pending = None             # double buffer: written, not swapped
        self._spare = None               # double buffer: the other tree
        self._done = None                # event after the pending write
        self._stream = None              # the requant's side stream
        self.last_requant_layers = 0
        self.last_skipped_layers = 0
        self.total_requant_layers = 0
        self.total_skipped_layers = 0

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

    @contextlib.contextmanager
    def _side(self, stats):
        """Run the body on the requant's side stream after everything the
        current stream has enqueued; record the completion event."""
        cur = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream(cur.device)
        self._stream.wait_stream(cur)
        for _, t in _walk(stats):        # read here, freed by the session
            t.record_stream(self._stream)
        with torch.cuda.stream(self._stream):
            yield
        self._done = torch.cuda.Event()
        self._done.record(self._stream)

    def requantize(self, threshold: Optional[float] = None):
        """Quantize from the session's statistics; returns the written tree,
        or None when every method is disabled or statistics are still
        missing.  ``threshold`` arms the delta gate (None: requantize
        everything without computing drift)."""
        if not self._active():
            return None
        stats, count = self.session.as_calib()
        key = _structure(stats)
        if self._plan_key != key:
            self._plan = FusedRequantPlan(self.params, stats, self.policy,
                                          acfg=self.acfg,
                                          lowrank_tree=self.lowrank_tree)
            self._plan_key = key
            self.qparams = self._pending = self._spare = None
            self._qt_by_path, self._last_D = {}, {}
        buffered = self.double_buffer and self.qparams is not None
        side = buffered and next(_walk(self.params))[1].is_cuda
        with self._side(stats) if side else contextlib.nullcontext():
            tree = self._write(stats, count, threshold, buffered)
        if buffered:
            self._pending = tree
            if not side:
                self._done = None
        else:
            self.qparams = tree
        self.n_requants += 1
        return tree

    def _write(self, stats, count, threshold, buffered):
        """Gate, pick the tree to write, fill it, refresh the snapshots;
        returns the written tree."""
        plan = self._plan
        only, n_requant, n_skip = None, plan.n_layers, 0
        if threshold is not None and self._qt_by_path:
            drifts = plan.drift(stats, count, self._last_D)
            only, n_requant, n_skip = plan.gate(drifts, threshold,
                                                set(self._qt_by_path))
        if not buffered:
            into = self.qparams
        elif self._pending is not None:
            into = self._pending
        elif self._spare is not None:
            into, self._spare = self._spare, None
        else:
            into = _clone_written(self.qparams)
        if only is not None:                 # skipped families: newest codes
            for key, members in plan.families.items():
                if key in only:
                    continue
                for m in members:
                    dst, src = _tree_get(into, m.path), self._qt_by_path[
                        m.path_str]
                    if dst is not src:
                        for f in _WRITTEN:
                            if getattr(dst, f) is not None:
                                getattr(dst, f).copy_(getattr(src, f))
        tree = plan.run(self.params, stats, count, self.lowrank_tree,
                        only=only, into=into)
        for key, members in plan.families.items():
            for m in members:
                qt = _tree_get(tree, m.path)
                if only is None or key in only:
                    self._last_D[m.path_str] = 1.0 / qt.dinv
                self._qt_by_path[m.path_str] = qt
        self.last_requant_layers, self.last_skipped_layers = n_requant, n_skip
        self.total_requant_layers += n_requant
        self.total_skipped_layers += n_skip
        return tree

    def _ready(self) -> bool:
        """Whether the pending tree's write has finished on the device."""
        return self._done is None or self._done.query()

    @property
    def decode_params(self):
        """The tree decode reads: the newest one that is ready (double
        buffer: the previous tree while a requant is in flight); the fp
        parameters before the first requant."""
        if self._pending is not None and self._ready():
            if self._done is not None:   # order decode after the write
                torch.cuda.current_stream().wait_event(self._done)
            self._spare, self.qparams, self._pending = \
                self.qparams, self._pending, None
        return self.qparams if self.qparams is not None else self.params
