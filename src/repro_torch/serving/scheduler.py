"""Scheduler — the host half of the engine: requests, slots, cadence.

FIFO intake; each round's admissions are grouped by padded prompt bucket
so every group is ONE batched prefill.  Requantization cadence: with
``recalibrate_tokens > 0`` once that many prefill + generated tokens have
passed since the last requant and fresh statistics arrived, otherwise
after every ``recalibrate_every`` admissions.  No tensors live here.
(Priorities, deadlines, chunked prefill, the paged pool and fault
isolation of the reference come in later slices.)
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional


def pick_decode_chunk(slots: int) -> int:
    """Default fused-decode chunk: per-token at one slot (nothing to
    amortize, and fixed-K steps past EOS are wasted), 8 from two slots up
    (the reference's tuning, ``scheduler.py:50``)."""
    return 1 if slots <= 1 else 8


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.out)


class GenResult(list):
    """A request's generated tokens; ``unfinished`` marks a partial output."""

    def __init__(self, tokens=(), unfinished: bool = False):
        super().__init__(tokens)
        self.unfinished = unfinished


@dataclasses.dataclass
class AdmissionGroup:
    bucket: int
    slots: List[int] = dataclasses.field(default_factory=list)
    requests: List[Request] = dataclasses.field(default_factory=list)

    @property
    def tokens(self) -> float:
        return float(len(self.requests) * self.bucket)


class Scheduler:
    def __init__(self, ecfg):
        self.ecfg = ecfg
        self.queue: deque = deque()
        self.slot_req: List[Optional[Request]] = [None] * ecfg.max_slots
        self.finished: Dict[int, Request] = {}
        self._rid = itertools.count()
        self.admits_since_cal = 0
        self.tokens_since_cal = 0.0
        self._fresh_stats = False
        self.prefill_tokens = 0.0
        self.pending_releases: List[int] = []

    @property
    def max_prompt_len(self) -> int:
        return min(max(self.ecfg.prompt_buckets), self.ecfg.max_len)

    def submit(self, prompt, max_new: int = 16) -> int:
        prompt = list(prompt)
        if not prompt or len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens is outside the admissible "
                f"length 1..{self.max_prompt_len} (max_len="
                f"{self.ecfg.max_len}, largest bucket "
                f"{max(self.ecfg.prompt_buckets)})")
        if max_new < 1:
            raise ValueError(f"max_new={max_new} must be >= 1")
        rid = next(self._rid)
        self.queue.append(Request(rid, prompt, max_new))
        return rid

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def bucket(self, n: int) -> int:
        for b in self.ecfg.prompt_buckets:
            if n <= b:
                return min(b, self.ecfg.max_len)
        return self.ecfg.max_len

    def plan_admissions(self) -> List[AdmissionGroup]:
        """Pop queued requests into free slots (FIFO) and group them by
        padded bucket: one prefill dispatch per group."""
        groups: Dict[int, AdmissionGroup] = {}
        for slot in self.free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            self.slot_req[slot] = req
            b = self.bucket(len(req.prompt))
            g = groups.setdefault(b, AdmissionGroup(b))
            g.slots.append(slot)
            g.requests.append(req)
        return list(groups.values())

    def note_admitted(self, n: int, tokens: float):
        self.admits_since_cal += n
        self.tokens_since_cal += tokens
        self.prefill_tokens += tokens
        self._fresh_stats = True

    def note_decoded(self, tokens: int):
        self.tokens_since_cal += tokens

    def should_requant(self) -> bool:
        if self.ecfg.recalibrate_tokens > 0:
            return (self._fresh_stats
                    and self.tokens_since_cal >= self.ecfg.recalibrate_tokens)
        return self.admits_since_cal >= self.ecfg.recalibrate_every

    def note_requant(self):
        self.admits_since_cal = 0
        self.tokens_since_cal = 0.0
        self._fresh_stats = False

    def finish(self, slot: int):
        req = self.slot_req[slot]
        req.done = True
        self.slot_req[slot] = None
        self.pending_releases.append(slot)
        self.finished[req.rid] = req

    def record_block(self, tokens, valid, done) -> int:
        """Fold one decode block's host copies ((B, K) tokens/valid, (B,)
        done) into the requests; returns the tokens accepted."""
        accepted = 0
        for slot in self.active_slots():
            req = self.slot_req[slot]
            for k in range(tokens.shape[1]):
                if valid[slot, k]:
                    req.out.append(int(tokens[slot, k]))
                    accepted += 1
            if done[slot]:
                self.finish(slot)
        self.note_decoded(accepted)
        return accepted

    def results(self) -> Dict[int, GenResult]:
        out = {rid: GenResult(req.out) for rid, req in self.finished.items()}
        for req in [r for r in self.slot_req if r is not None] + list(self.queue):
            out[req.rid] = GenResult(req.out, unfinished=True)
        return out
