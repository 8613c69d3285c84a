"""Scheduler — the host half of the engine: requests, slots, cadence.

FIFO intake; each round's admissions are grouped by (padded prompt
bucket, cached prefix length) so every group is ONE batched prefill.
Requantization cadence: with ``recalibrate_tokens > 0`` once that many
prefill + generated tokens have passed since the last requant and fresh
statistics arrived, otherwise after every ``recalibrate_every``
admissions.  With a paged KV cache the scheduler owns the
:class:`~repro_torch.serving.blocks.BlockAllocator`: each admission
reserves its blocks upfront, and pool exhaustion preempts the youngest
running admission.  No tensors live here.  (Priorities, deadlines,
retries, chunked prefill and fault isolation of the reference come in
later slices.)
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional

from .blocks import BlockAllocator


def pick_decode_chunk(slots: int, speculate_k: int = 0) -> int:
    """Default fused-decode chunk: per-token at one slot (nothing to
    amortize, and fixed-K steps past EOS are wasted), 8 from two slots up
    (the reference's tuning, ``scheduler.py:50``).  With self-speculative
    decoding the chunk counts windows, each emitting up to W+1 tokens per
    lane, so it is divided by W+1 (at least 1) to keep the work past EOS
    or budget comparable; one slot stays at one window."""
    base = 1 if slots <= 1 else 8
    if speculate_k <= 0:
        return base
    return max(1, base // (speculate_k + 1))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list                    # grows on preemption: orig + generated
    max_new: int                    # original budget
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    blocks: list = dataclasses.field(default_factory=list)  # paged: owned
    prefix_len: int = 0             # paged: cached-prefix tokens this admission
    admit_seq: int = -1             # admission order (preemption victim pick)
    orig_len: int = 0               # submitted prompt length

    def __post_init__(self):
        if not self.orig_len:
            self.orig_len = len(self.prompt)

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.out)


class GenResult(list):
    """A request's generated tokens; ``unfinished`` marks a partial output
    (still queued or running, or cancelled — ``cancelled``)."""

    def __init__(self, tokens=(), unfinished: bool = False,
                 cancelled: bool = False):
        super().__init__(tokens)
        self.unfinished = unfinished
        self.cancelled = cancelled


@dataclasses.dataclass
class AdmissionGroup:
    """One bucketed prefill.  A nonzero ``prefix_len`` (paged prefix-cache
    hits) pads the prompt tails, which attend to the cached prefix."""
    bucket: int
    prefix_len: int = 0
    slots: List[int] = dataclasses.field(default_factory=list)
    requests: List[Request] = dataclasses.field(default_factory=list)

    @property
    def tokens(self) -> float:
        return float(len(self.requests) * self.bucket)


class Scheduler:
    def __init__(self, ecfg, kvcfg=None, num_blocks: int = 0):
        self.ecfg = ecfg
        self.queue: deque = deque()
        self.slot_req: List[Optional[Request]] = [None] * ecfg.max_slots
        self.finished: Dict[int, Request] = {}
        self._rid = itertools.count()
        self.admits_since_cal = 0
        self.tokens_since_cal = 0.0
        self._fresh_stats = False
        self.prefill_tokens = 0.0       # padded tokens dispatched to prefill
        self.pending_releases: List[int] = []   # slots to release on device
        self.allocator = None
        if kvcfg is not None and kvcfg.paged:
            self.allocator = BlockAllocator(num_blocks, kvcfg.block_size,
                                            prefix_cache=ecfg.prefix_cache)
        self._admit_seq = itertools.count()
        self.preemptions = 0
        self._recent_victims: set = set()       # no re-preemption until decode

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
        if self.allocator is not None:
            need = self.allocator.blocks_needed(len(prompt), max_new,
                                                self.ecfg.max_len)
            if need > self.allocator.capacity:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool holds "
                    f"{self.allocator.capacity}; raise kv_pool_blocks or "
                    f"shrink the prompt/max_new")
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

    def _evict(self, slot: int, req: Request, finished: bool):
        """Clear the slot, free its (paged) blocks and queue the device
        release; ``finished`` lands the request in the results."""
        self.slot_req[slot] = None
        if self.allocator is not None:
            self.allocator.free_request(req.blocks)
            req.blocks = []
        self.pending_releases.append(slot)
        if finished:
            self.finished[req.rid] = req

    def _pick_victim(self, exclude) -> Optional[int]:
        """The youngest running admission outside ``exclude`` (older work
        keeps running; the victim's re-prefill is cheap, because its own
        prompt blocks stay in the prefix cache)."""
        cands = [(self.slot_req[s].admit_seq, s) for s in self.active_slots()
                 if s not in exclude]
        return max(cands)[1] if cands else None

    def _preempt(self, slot: int) -> Request:
        """Evict a running slot: free its blocks and fold the generated
        tokens into the prompt, so a later re-prefill resumes the greedy
        stream exactly (per-token KV quantization makes the re-prefilled
        rows the evicted ones; ``len(prompt) + remaining`` stays
        ``orig_len + max_new``).  The caller requeues the request once the
        round's planning is done."""
        req = self.slot_req[slot]
        req.prompt = list(req.prompt[:req.orig_len]) + list(req.out)
        self._evict(slot, req, finished=False)
        self.preemptions += 1
        self._recent_victims.add(req.rid)
        return req

    def plan_admissions(self) -> List[AdmissionGroup]:
        """Pop queued requests into free slots in FIFO (rid) order and group
        the round's admissions by (bucket of the uncached tail, prefix_len):
        one prefill dispatch per group.

        Paged: each admission reserves its blocks upfront (prompt +
        generation budget, less prefix-cache hits).  On pool exhaustion the
        youngest running slot is preempted (blocks freed, its slot handed
        to the admission) instead of stalling; victims are held out of the
        queue until planning ends, then requeued at the front, and resume by
        re-prefill in a later round.  A fresh victim may not preempt in turn
        until decode has progressed, which breaks admit-round ping-pong.
        Each MemoryError preempts a slot not picked this round, so the
        retry loop ends: with every slot preempted no request holds a
        block, and ``submit``'s capacity check makes the allocation fit."""
        picked: List[tuple] = []
        victims: List[Request] = []
        free = self.free_slots()
        while free and self.queue:
            req = min(self.queue, key=lambda r: r.rid)
            if self.allocator is not None:
                try:
                    req.blocks, req.prefix_len = self.allocator.allocate(
                        req.prompt, req.remaining, self.ecfg.max_len)
                except MemoryError:
                    victim = self._pick_victim({s for s, _ in picked})
                    if victim is None or req.rid in self._recent_victims:
                        break               # nothing evictable: wait
                    victims.append(self._preempt(victim))
                    free = self.free_slots()
                    continue                # retry with the freed blocks
            self.queue.remove(req)
            req.admit_seq = next(self._admit_seq)
            slot = free.pop(0)
            self.slot_req[slot] = req       # claimed now: a later preemption
            picked.append((slot, req))      # in this round must not free it
        for req in reversed(victims):       # oldest victim resumes first
            self.queue.appendleft(req)
        groups: Dict[tuple, AdmissionGroup] = {}
        for slot, req in picked:
            key = (self.bucket(len(req.prompt) - req.prefix_len),
                   req.prefix_len)
            g = groups.setdefault(key, AdmissionGroup(*key))
            g.slots.append(slot)
            g.requests.append(req)
        # dispatch in ascending prefix_len: a same-round prefix hit on a
        # sibling's freshly registered blocks reads blocks that the writer
        # prefills, and along one hash chain the reader's match extends
        # past the writer's own prefix, so reader prefix_len > writer
        # prefix_len.  The sort is a topological order of same-round
        # dependencies: every group's gather runs after the scatters it
        # reads.
        return sorted(groups.values(), key=lambda g: g.prefix_len)

    def note_admitted(self, n: int, tokens: float):
        self.admits_since_cal += n
        self.tokens_since_cal += tokens
        self.prefill_tokens += tokens
        self._fresh_stats = True

    def note_decoded(self, tokens: int):
        self.tokens_since_cal += tokens
        self._recent_victims.clear()    # decode progressed: preemption rearmed

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
        self._evict(slot, req, finished=True)

    def cancel(self, rid: int) -> bool:
        """Abort a queued or running request: its slot and (paged) blocks
        free at once and its partial output lands as ``cancelled``.
        Returns False for an unknown or already finished rid."""
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                req.cancelled = True
                self.finished[rid] = req
                return True
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.rid == rid:
                req.cancelled = True
                self._evict(slot, req, finished=True)
                return True
        return False

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
        out = {rid: GenResult(req.out, unfinished=req.cancelled,
                              cancelled=req.cancelled)
               for rid, req in self.finished.items()}
        for req in [r for r in self.slot_req if r is not None] + list(self.queue):
            out[req.rid] = GenResult(req.out, unfinished=True)
        return out
