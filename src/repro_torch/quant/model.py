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
* **Draft tree** (``draft_policy``, self-speculative decoding): a second
  quantized tree from the same statistics, with its own plan, delta-gate
  snapshots, double-buffer trees and completion event.  Its requant runs
  right after the verify tree's, on the same side stream.  A disabled draft
  policy (``NO_QUANT``) keeps ``draft_params`` on the fp weights; a disabled
  verify policy with an enabled draft is draft-only quantization (the
  quantized model speculates for its fp self).
* ``fused=False`` runs the eager per-leaf :func:`quantize_params` instead of
  the plan; it refuses the delta gate and a draft tree.
* ``fork()`` shares params and low-rank factors with a fresh copy of the
  session; ``adopt(session)`` merges a forked stream's statistics back.
* **Health gate** (``health_gate=GuardConfig``): every candidate tree is
  validated (:func:`~repro_torch.quant.guards.qt_health`: finite scales,
  zeros and D⁻¹, bounded D⁻¹ drift) before it is swapped in or refreshes
  the delta gate's snapshots.  A rejected candidate is retried once; a
  second rejection rolls the session's newest accepted update back and
  keeps the last-good tree (a rejected draft tree beside a healthy verify
  tree keeps its old draft).  A candidate must never land where decode
  reads, so under the gate every requant after the first writes the tree
  decode is not reading (the double buffer's spare, cloned once), validates
  it and swaps it in at once: two trees alternate, each with its own decode
  graph.  With the double buffer as well, a pending tree is first waited
  for and swapped in, so a candidate never overwrites the newest good
  codes.  ``_fault_hook`` (the fault injector's ``requant.tree`` site)
  sees each candidate before the gate and returns a tree built of new
  tensors.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from repro_torch.core.awq import AWQConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.ttq import QuantizedTensor

from .api import (FusedRequantPlan, _tree_get, _walk, lowrank_tree,
                  quantize_params)
from .guards import GuardConfig, qt_health
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


class _Tree:
    """One quantized tree's requant state: its policy, factors and plan,
    the tree decode reads, the double buffer's pending (written, not
    swapped) and spare trees with the pending write's completion event,
    and the delta gate's snapshots."""

    def __init__(self, policy: QuantPolicy, lowrank):
        self.policy, self.lowrank = policy, lowrank
        self.plan: Optional[FusedRequantPlan] = None
        self.reset()

    def reset(self):
        self.qparams = self.pending = self.spare = self.done = None
        self.qt_by_path: dict = {}       # path → QuantizedTensor with the
                                         # newest codes of that path
        self.last_D: dict = {}           # path → D at its last requant

    def ready(self) -> bool:
        """Whether the pending tree's write has finished on the device."""
        return self.done is None or self.done.query()

    def swap(self):
        if self.done is not None:        # order decode after the write
            torch.cuda.current_stream().wait_event(self.done)
        self.spare, self.qparams, self.pending = \
            self.qparams, self.pending, None


class QuantizedModel:
    def __init__(self, params: Any, policy: QuantPolicy, *,
                 acfg: Optional[AWQConfig] = None, halflife: float = 0.0,
                 session: Optional[CalibrationSession] = None,
                 lowrank: Any = _AUTO, fused: bool = True,
                 double_buffer: bool = False,
                 draft_policy: Optional[QuantPolicy] = None,
                 health_gate: Optional[GuardConfig] = None):
        self.params = params
        self.policy = policy
        self.acfg = acfg
        self.fused = fused
        self.double_buffer = double_buffer
        self.session = session if session is not None else \
            CalibrationSession(halflife=halflife)
        if lowrank is _AUTO:
            self.lowrank_tree = lowrank_tree(params, policy) \
                if policy.any_enabled else None
        else:
            self.lowrank_tree = lowrank
        self.draft_policy = draft_policy
        drafting = draft_policy is not None and draft_policy.any_enabled
        if drafting and not fused:
            raise ValueError("draft_policy (self-speculative decoding) needs "
                             "the fused requant plan; construct "
                             "QuantizedModel(fused=True) (the default)")
        self._v = _Tree(policy, self.lowrank_tree)
        self._d = _Tree(draft_policy, lowrank_tree(params, draft_policy)
                        if draft_policy.rank > 0 else None) \
            if drafting else None
        self.n_requants = 0
        self._plan_key = _AUTO           # no plan built yet
        self._stream = None              # the requant's side stream
        self.last_requant_layers = 0     # verify-tree counts
        self.last_skipped_layers = 0
        self.total_requant_layers = 0
        self.total_skipped_layers = 0
        self.health_gate = health_gate
        self.requant_rejections = 0      # candidates the gate refused
        self.last_health_drift = 0.0
        self._fault_hook = None          # called with each candidate tree

    # the verify tree's state, under the names the single-tree model had
    qparams = property(lambda self: self._v.qparams)
    _plan = property(lambda self: self._v.plan)
    _qt_by_path = property(lambda self: self._v.qt_by_path)
    _last_D = property(lambda self: self._v.last_D)
    _pending = property(lambda self: self._v.pending)
    _spare = property(lambda self: self._v.spare)

    @property
    def draft_qparams(self):
        return None if self._d is None else self._d.qparams

    @property
    def requant_families(self) -> int:
        """Weight families of the plan(s), the draft tree's included: the
        counterpart of the reference's requant programs (one jitted program
        per family)."""
        return sum(len(t.plan.families) for t in self._trees()
                   if t.plan is not None)

    def _trees(self):
        return [t for t in (self._v, self._d) if t is not None]

    def calibrate(self, stats: Any, tokens: float,
                  provenance: tuple = ()) -> "QuantizedModel":
        """Fold one prefill's activation statistics into the session;
        ``provenance`` (request ids) goes into the quarantine log when a
        guarded session rejects the update."""
        self.session.update(stats, tokens, provenance=provenance)
        return self

    def _active(self) -> bool:
        active = [q for t in self._trees()
                  for q in map(get_quantizer, t.policy.methods()) if q.enabled]
        if not active:
            return False
        return self.session.calibrated or not all(q.requires_stats
                                                  for q in active)

    @contextlib.contextmanager
    def _side(self, stats, tree: _Tree):
        """Run the body on the requant's side stream after everything the
        current stream has enqueued; record ``tree``'s completion event."""
        cur = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream(cur.device)
        self._stream.wait_stream(cur)
        for _, t in _walk(stats):        # read here, freed by the session
            t.record_stream(self._stream)
        with torch.cuda.stream(self._stream):
            yield
        tree.done = torch.cuda.Event()
        tree.done.record(self._stream)

    def requantize(self, threshold: Optional[float] = None):
        """Quantize from the session's statistics; returns the written
        verify tree (the draft tree in draft-only mode), or None when every
        method is disabled or statistics are still missing.  ``threshold``
        arms the delta gate (None: requantize everything without computing
        drift)."""
        if not self._active():
            return None
        stats, count = self.session.as_calib()
        if not self.fused:
            if threshold is not None:
                raise ValueError(
                    "requantize(threshold=...) — the delta gate — needs the "
                    "fused plan; construct QuantizedModel(fused=True) (the "
                    "default) or drop the threshold")
            self._v.qparams = quantize_params(
                self.params, stats, self.policy, count=count, acfg=self.acfg,
                lowrank_tree=self.lowrank_tree)
            self.n_requants += 1
            return self._v.qparams
        self._v.lowrank = self.lowrank_tree  # callers may swap the factors
        key = _structure(stats)
        if self._plan_key != key:
            for t in self._trees():
                t.plan = FusedRequantPlan(
                    self.params, stats, t.policy, acfg=self.acfg,
                    lowrank_tree=t.lowrank) if t.policy.any_enabled else None
                t.reset()
            self._plan_key = key
        gated = self.health_gate is not None
        if gated:                        # never overwrite the newest codes
            for t in self._trees():
                if t.pending is not None and t.done is not None:
                    t.done.synchronize()
            self._swap_ready()
        written = []
        for t in self._trees():
            if t.plan is None:           # draft-only: the verify tree is fp
                continue
            tree = None
            for _ in range(2 if gated else 1):   # one retry under the gate
                tree = self._try(t, stats, count, threshold)
                if tree is not None:
                    break
            if tree is None:
                if not written:          # the primary tree: keep the last
                    self.session.rollback(1)   # good one, drop the newest
                    return None                # update (prime suspect)
                continue                 # a rejected draft keeps its old one
            written.append(tree)
        self.n_requants += 1
        return written[0]

    def _try(self, t: _Tree, stats, count, threshold):
        """One candidate for ``t``: written where decode is not reading
        (double buffer or gate) or in place, held to the gate, then made
        pending (double buffer) or current.  Returns the tree, or None when
        the gate rejected it (snapshots untouched)."""
        db = self.double_buffer and t.qparams is not None
        gated = self.health_gate is not None
        side = db and next(_walk(self.params))[1].is_cuda
        with self._side(stats, t) if side else contextlib.nullcontext():
            tree = self._write(t, stats, count, threshold, buffered=db or (
                gated and t.qparams is not None))
        if tree is None:
            return None
        if db:
            t.pending = tree
            if not side:
                t.done = None
        else:
            if gated and t.qparams is not None and t.qparams is not tree:
                t.spare = t.qparams
            t.qparams = tree
        return tree

    def _write(self, t: _Tree, stats, count, threshold, buffered):
        """Gate, pick the tree to write, fill it, hold it to the health
        gate, refresh the snapshots; returns the written tree, or None when
        the health gate rejected it."""
        plan = t.plan
        only, n_requant, n_skip = None, plan.n_layers, 0
        if threshold is not None and t.qt_by_path:
            drifts = plan.drift(stats, count, t.last_D)
            only, n_requant, n_skip = plan.gate(drifts, threshold,
                                                set(t.qt_by_path))
        if not buffered:
            into = t.qparams
        elif t.pending is not None:
            into = t.pending
        elif t.spare is not None:
            into, t.spare = t.spare, None
        else:
            into = _clone_written(t.qparams)
        if only is not None:                 # skipped families: newest codes
            for key, members in plan.families.items():
                if key in only:
                    continue
                for m in members:
                    dst, src = _tree_get(into, m.path), t.qt_by_path[
                        m.path_str]
                    if dst is not src:
                        for f in _WRITTEN:
                            if getattr(dst, f) is not None:
                                getattr(dst, f).copy_(getattr(src, f))
        tree = plan.run(self.params, stats, count, t.lowrank, only=only,
                        into=into)
        if self._fault_hook is not None:
            tree = self._fault_hook(tree)
        if self.health_gate is not None:
            prev = {p: qt.dinv for p, qt in t.qt_by_path.items()
                    if qt.dinv is not None}
            ok, self.last_health_drift = qt_health(
                tree, prev, self.health_gate.requant_max_drift)
            if not ok:
                self.requant_rejections += 1
                if buffered:
                    t.spare = into           # rewritten by the retry
                return None
        for key, members in plan.families.items():
            for m in members:
                qt = _tree_get(tree, m.path)
                if only is None or key in only:
                    t.last_D[m.path_str] = 1.0 / qt.dinv
                t.qt_by_path[m.path_str] = qt
        if t is self._v:
            self.last_requant_layers, self.last_skipped_layers = \
                n_requant, n_skip
            self.total_requant_layers += n_requant
            self.total_skipped_layers += n_skip
        return tree

    def _ready(self) -> bool:
        """Whether the verify tree's pending write has finished."""
        return self._v.ready()

    def _swap_ready(self):
        """Swap the pending trees in once every pending write has finished:
        the draft tree with the verify tree, so a speculative block reads
        the pair one requant wrote and a double-buffered engine alternates
        between two pairs (two speculative graphs, not up to four)."""
        pending = [t for t in self._trees() if t.pending is not None]
        if pending and self._ready() and (self._d is None
                                          or self._d.ready()):
            for t in pending:
                t.swap()

    @property
    def decode_params(self):
        """The verify tree decode reads: the newest one that is ready
        (double buffer: the previous tree while a requant is in flight);
        the fp parameters before the first requant."""
        self._swap_ready()
        t = self._v
        return t.qparams if t.qparams is not None else self.params

    @property
    def draft_params(self):
        """The draft tree a speculative block drafts with, by the same rule
        as :attr:`decode_params`; the fp parameters before the first requant
        or when the draft policy is disabled (an fp draft is a valid, most
        accurate, speculator)."""
        self._swap_ready()
        t = self._d
        if t is None:
            return self.params
        return t.qparams if t.qparams is not None else self.params

    def fork(self) -> "QuantizedModel":
        """An independent calibration stream sharing params and the verify
        tree's low-rank factors."""
        return QuantizedModel(self.params, self.policy, acfg=self.acfg,
                              session=self.session.fork(),
                              lowrank=self.lowrank_tree, fused=self.fused,
                              double_buffer=self.double_buffer,
                              draft_policy=self.draft_policy,
                              health_gate=self.health_gate)

    def adopt(self, session: CalibrationSession) -> "QuantizedModel":
        """Join a forked stream's statistics into this model's session."""
        self.session = self.session.merge(session)
        return self
