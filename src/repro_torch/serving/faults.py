"""Deterministic fault injection for the serving stack.

This module is the engine's designated fault boundary: the one place in
``serving/`` allowed to hold broad exception handlers, because a bug in the
injection harness itself must never take down the serving run it probes.
They guard the harness's own bookkeeping only; a kernel's or a graph's
failure is never caught anywhere.

A :class:`Fault` names a **site** (a seam the engine already exposes), a
site-local trigger index ``at``, a ``kind`` and a repeat ``count``.  The
:class:`FaultInjector` holds a list of them and an optional
:class:`VirtualClock`; the engine calls its hooks at fixed points of the
serving loop, so a given (faults, seed, traffic) triple replays exactly.

==================  ====================================================
``calib.stats``     corrupt an admission's calibration update before it
                    reaches ``CalibrationSession.update``: ``nan`` /
                    ``inf`` (non-finite stats), ``outlier`` (scaled by
                    ``magnitude``), ``bad-tokens`` (token count 0),
                    ``drop`` (no fold: the clean twin of a comparison).
``requant.tree``    corrupt the candidate quantized tree between the
                    requant and the health gate (float leaves → NaN).
``pool.steal``      take up to ``magnitude`` free KV-pool blocks for
                    ``count`` engine steps, then give them back.
``decode.logits``   poison the decode logits of the lane running request
                    ``rid`` (every lane when ``rid < 0``) for ``count``
                    decode blocks.
``clock.skew``      move the virtual clock forward by ``magnitude``
                    seconds at engine step ``at``.
==================  ====================================================

A corruption builds new tensors: it never writes into a tensor the engine
holds (a prefill graph's statistics are its static outputs, a quantized
tree may be the one a decode graph reads).  Lane poisoning only selects
slots; the runner owns the device-side mask.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["Fault", "FaultInjector", "VirtualClock", "demo_injector"]


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault: fires at site-local index ``at`` (each site counts its own
    events), ``count`` consecutive times."""
    site: str                 # calib.stats | requant.tree | pool.steal |
                              # decode.logits | clock.skew
    at: int = 0               # site-local trigger index
    kind: str = ""            # site-specific (see the module docstring)
    rid: int = -1             # decode.logits: target request (-1 = all)
    magnitude: float = 1e6    # outlier factor / blocks stolen / skew seconds
    count: int = 1            # consecutive triggers


class VirtualClock:
    """A clock the harness owns.  The engine reads it through
    ``FaultInjector.clock``, so deadlines expire reproducibly; ``tick``
    advances it by a fixed step per engine iteration."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.now = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float):
        self.now += float(dt)


def _map(fn, tree):
    """``fn`` over the tensors of a nested dict/list tree and of its
    quantized leaves, as new trees (other leaves shared)."""
    from repro_torch.core.ttq import QuantizedTensor
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, **{
            f: _map(fn, getattr(tree, f))
            for f in ("wint", "packed", "scale", "zero", "dinv", "B", "A")})
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _nan_floats(tree):
    """The tree with every floating tensor NaN, as new tensors (integer
    ones, such as packed codes, kept)."""
    return _map(lambda x: x * float("nan") if x.is_floating_point() else x,
                tree)


class FaultInjector:
    """Replays a fault list against the engine's injection sites.

    ``TTQEngine(..., faults=injector)`` wires the hooks: ``on_step`` at the
    top of every step, ``calib_site`` for each admission's statistics,
    ``requant_hook`` for each candidate quantized tree, ``decode_site`` for
    the lanes to poison before each decode block.  ``fired`` logs every
    injection as ``(site, index, detail)``."""

    def __init__(self, faults, clock: Optional[VirtualClock] = None):
        self.faults: List[Fault] = list(faults)
        self.clock = clock
        self.fired: List[Tuple[str, int, str]] = []
        self.errors: List[str] = []          # harness bugs, never re-raised
        self._step_n = 0
        self._calib_n = 0
        self._requant_n = 0
        self._decode_n = 0
        self._decode_fired: Dict[int, int] = {}
        self._stolen: List[Tuple[int, object, List[int]]] = []

    def _active(self, site: str, n: int) -> Optional[Fault]:
        for f in self.faults:
            if f.site == site and f.at <= n < f.at + f.count:
                return f
        return None

    def _log(self, f: Fault, n: int, detail: str = ""):
        self.fired.append((f.site, n, detail or f.kind or str(f.rid)))

    def on_step(self, engine):
        """Step-indexed sites: clock skew and pool theft.  The fault
        boundary proper: a harness bug is recorded and swallowed, so it
        cannot crash the serving loop it probes."""
        n = self._step_n
        self._step_n += 1
        try:
            if self.clock is not None and self.clock.tick:
                self.clock.advance(self.clock.tick)
            f = self._active("clock.skew", n)
            if f is not None and self.clock is not None:
                self.clock.advance(f.magnitude)
                self._log(f, n, f"+{f.magnitude}s")
            self._pool_site(engine, n)
        except Exception as e:      # the harness's own bugs only
            self.errors.append(f"on_step[{n}]: {e!r}")

    def _pool_site(self, engine, n: int):
        a = getattr(engine, "allocator", None)
        if a is None:
            return
        keep = []                   # give back blocks whose window closed
        for until, alloc, blocks in self._stolen:
            if n >= until:
                alloc.free.extend(blocks)
            else:
                keep.append((until, alloc, blocks))
        self._stolen = keep
        f = self._active("pool.steal", n)
        if f is not None and n == f.at:      # once per fault window
            take = min(int(f.magnitude), len(a.free))
            blocks = [a.free.pop() for _ in range(take)]
            self._stolen.append((f.at + f.count, a, blocks))
            self._log(f, n, f"stole {take} blocks")

    def calib_site(self, stats, tokens, rids: Tuple[int, ...]):
        """One admission's calibration update, possibly corrupted: returns
        ``(stats, tokens)``; stats None means the engine skips the fold."""
        n = self._calib_n
        self._calib_n += 1
        f = self._active("calib.stats", n)
        if f is None or stats is None:
            return stats, tokens
        self._log(f, n, f"{f.kind} rids={list(rids)}")
        if f.kind == "drop":
            return None, tokens
        if f.kind == "nan":
            return _nan_floats(stats), tokens
        if f.kind == "inf":
            return _map(lambda x: x * float("inf"), stats), tokens
        if f.kind == "outlier":
            return _map(lambda x: x * f.magnitude, stats), tokens
        if f.kind == "bad-tokens":
            return stats, 0
        return stats, tokens

    def requant_hook(self, tree):
        """A candidate quantized tree, NaN-corrupted (float leaves) while a
        ``requant.tree`` fault is active; called once per candidate, so with
        ``count=1`` the gate's retry builds a clean tree."""
        n = self._requant_n
        self._requant_n += 1
        f = self._active("requant.tree", n)
        if f is None:
            return tree
        self._log(f, n, f.kind or "nan-scale")
        return _nan_floats(tree)

    def decode_site(self, slot_req, round_: int = 0) -> List[int]:
        """The slots to poison in the next decode block: lanes whose request
        matches a live ``decode.logits`` fault.  At most ``count`` blocks per
        fault, counted only once the target runs, so the trigger does not
        depend on admission timing."""
        n = self._decode_n
        self._decode_n += 1
        slots: List[int] = []
        for f in self.faults:
            if f.site != "decode.logits" or n < f.at:
                continue
            done = self._decode_fired.get(id(f), 0)
            if done >= f.count:
                continue
            hit = [s for s, r in enumerate(slot_req)
                   if r is not None and (f.rid < 0 or r.rid == f.rid)]
            if not hit:
                continue
            self._decode_fired[id(f)] = done + 1
            self._log(f, n, f"slots={hit}")
            slots.extend(hit)
        return sorted(set(slots))


RECIPES = {
    "nan-stats": [Fault("calib.stats", at=1, kind="nan")],
    "outlier-stats": [Fault("calib.stats", at=1, kind="outlier",
                            magnitude=1e6)],
    "bad-requant": [Fault("requant.tree", at=0, kind="nan-scale")],
    "pool-steal": [Fault("pool.steal", at=2, magnitude=4, count=3)],
    "poison-lane": [Fault("decode.logits", at=0, rid=0)],
}


def demo_injector(name: str) -> FaultInjector:
    """A named single-fault injector (``launch/serve.py --inject``)."""
    if name not in RECIPES:
        raise ValueError(f"unknown fault recipe {name!r}; "
                         f"choose from {sorted(RECIPES)}")
    return FaultInjector(RECIPES[name])
