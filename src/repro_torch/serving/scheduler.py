"""Scheduler — the host half of the engine: requests, slots, cadence.

Admission picks the eligible request minimizing (priority, absolute
deadline, submission order): priority classes (lower = more urgent)
dominate, earliest deadline first within a class, FIFO when neither is set.
Each round's admissions are grouped by (padded prompt bucket, cached prefix
length), so every group is ONE batched prefill.  Requantization cadence:
with ``recalibrate_tokens > 0`` once that many prefill + generated tokens
have passed since the last requant and fresh statistics arrived, otherwise
after every ``recalibrate_every`` admissions.  With a paged KV cache the
scheduler owns the :class:`~repro_torch.serving.blocks.BlockAllocator`:
each admission reserves its blocks upfront, and pool exhaustion preempts a
running admission of the least urgent class (the youngest within it), never
one more urgent than the admitter.

Robustness: a lane whose logits went non-finite fails alone
(:meth:`fail_lane`: retried from its original prompt with backoff in
planning rounds, up to ``guard_cfg.max_retries``, then ``error="non-finite
logits"``); requests past their deadline fail with ``error="deadline"``;
the MemoryError → preempt → retry loop is capped per request and round
(``error="admission retries exhausted"``).  Streaming: every emitted token
goes through :meth:`emit` (its time stamped for TTFT/ITL, ``on_token``
fired), every terminal landing through :meth:`_land` (``on_finish``).
Chunked prefill: a prompt tail longer than ``prefill_chunk`` claims its
slot and blocks at admission but is ingested chunk by chunk
(:meth:`plan_prefill_chunks`, at most ``prefill_budget`` padded tokens per
round), its lane parked until the final chunk.  No tensors live here.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .blocks import BlockAllocator


class QueueFull(RuntimeError):
    """``submit`` refused: the intake queue holds ``max_queue`` requests.
    The engine raises it to the caller (shed load or retry later); the
    async front end awaits a semaphore instead."""


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
    deadline_s: float = 0.0         # wall budget from submit (0 = none)
    submit_t: float = 0.0           # engine-clock submission time
    error: str = ""                 # terminal failure ("" = none)
    attempts: int = 0               # decode-fault retries used
    not_before: int = 0             # planning round a retry waits for
    priority: int = 0               # class: lower = more urgent
    prefilled: int = 0              # chunked prefill: rows resident
    tok_times: list = dataclasses.field(default_factory=list)  # emit times
    frames: Any = None              # encoder-decoder: (n_frames, D) f32

    def __post_init__(self):
        if not self.orig_len:
            self.orig_len = len(self.prompt)

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.out)


class GenResult(list):
    """A request's generated tokens; ``unfinished`` marks a partial output
    (still queued or running, cancelled — ``cancelled`` — or failed, with
    the reason in ``error``: "deadline", "non-finite logits", "admission
    retries exhausted")."""

    def __init__(self, tokens=(), unfinished: bool = False,
                 cancelled: bool = False, error: str = ""):
        super().__init__(tokens)
        self.unfinished = unfinished
        self.cancelled = cancelled
        self.error = error


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


@dataclasses.dataclass
class ChunkPlan:
    """One chunk of one request's ingestion: prompt rows [start, start +
    length) into the slot's cache, padded to ``prefill_chunk``.  The final
    chunk samples the first token and arms the lane."""
    slot: int
    req: Request
    start: int                      # rows already resident
    length: int                     # real tokens in this chunk
    final: bool


class Scheduler:
    def __init__(self, ecfg, kvcfg=None, num_blocks: int = 0, *,
                 exact_buckets: bool = False):
        self.ecfg = ecfg
        # a recurrent state would absorb pad tokens: prefill at the exact
        # prompt length
        self.exact_buckets = exact_buckets
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
        # the guard knobs (retries, admission cap) apply with guards off
        # too: EngineConfig.guards gates detection, not bookkeeping
        self.gcfg = ecfg.guard_cfg
        self.lane_faults = 0            # decode lanes failed on bad logits
        self.deadline_expirations = 0
        self.admission_failures = 0     # requests failed at the attempt cap
        self._round = 0                 # planning rounds (the backoff unit)
        self._starve: Dict[int, int] = {}       # rid → idle-starved rounds
        self.prefilling: Dict[int, Request] = {}  # slot → mid-ingestion
        self.prefill_chunks = 0         # chunks dispatched
        self.queue_rejections = 0       # submits refused at max_queue
        self.on_token: Optional[Callable] = None    # (rid, tok, now)
        self.on_finish: Optional[Callable] = None   # (rid, req)

    # ---------------------------------------------------------------- intake

    @property
    def max_prompt_len(self) -> int:
        """The cache must hold a prompt and the largest bucket must fit it;
        exact-length prefill and chunked prefill lift the bucket limit
        (nothing is padded, or the chunks are, not the prompt)."""
        if self.exact_buckets or self.ecfg.prefill_chunk > 0:
            return self.ecfg.max_len
        return min(max(self.ecfg.prompt_buckets), self.ecfg.max_len)

    def submit(self, prompt, max_new: int = 16, frames=None,
               deadline_s: Optional[float] = None, now: float = 0.0,
               priority: int = 0) -> int:
        prompt = list(prompt)
        if not prompt or len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens is outside the admissible "
                f"length 1..{self.max_prompt_len} (max_len="
                f"{self.ecfg.max_len}, largest bucket "
                f"{max(self.ecfg.prompt_buckets)}, prefill_chunk="
                f"{self.ecfg.prefill_chunk})")
        if max_new < 1:
            raise ValueError(f"max_new={max_new} must be >= 1")
        mq = self.ecfg.max_queue
        if mq and len(self.queue) >= mq:
            self.queue_rejections += 1
            raise QueueFull(
                f"intake queue at capacity (max_queue={mq}); shed load or "
                f"retry after the engine drains")
        if self.allocator is not None:
            need = self.allocator.blocks_needed(len(prompt), max_new,
                                                self.ecfg.max_len)
            if need > self.allocator.capacity:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool holds "
                    f"{self.allocator.capacity}; raise kv_pool_blocks or "
                    f"shrink the prompt/max_new")
        rid = next(self._rid)
        dl = float(self.ecfg.deadline_s if deadline_s is None else deadline_s)
        self.queue.append(Request(rid, prompt, max_new, deadline_s=dl,
                                  submit_t=float(now), priority=int(priority),
                                  frames=frames))
        return rid

    # ------------------------------------------------------------- streaming

    def emit(self, req: Request, tok: int, now: float = 0.0):
        """Land one generated token: output, emission time, ``on_token``.
        Every path that produces a token comes through here, so
        ``len(out) == len(tok_times)``."""
        req.out.append(int(tok))
        req.tok_times.append(float(now))
        if self.on_token is not None:
            self.on_token(req.rid, int(tok), float(now))

    def _land(self, req: Request):
        """A terminal landing (done, failed, cancelled, expired): record the
        request and fire ``on_finish``."""
        self.finished[req.rid] = req
        if self.on_finish is not None:
            self.on_finish(req.rid, req)

    # ------------------------------------------------------------- admission

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def decode_slots(self) -> List[int]:
        """Slots with an armed decode lane: active ones not mid-ingestion
        (those are parked done on the device until their final chunk)."""
        return [s for s in self.active_slots() if s not in self.prefilling]

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def bucket(self, n: int) -> int:
        if self.exact_buckets:
            return n
        for b in self.ecfg.prompt_buckets:
            if n <= b:
                return min(b, self.ecfg.max_len)
        return self.ecfg.max_len

    def _evict(self, slot: int, req: Request, finished: bool):
        """Clear the slot, free its (paged) blocks — partially written ones
        of a chunked prefill included — and queue the device release;
        ``finished`` lands the request."""
        self.slot_req[slot] = None
        self.prefilling.pop(slot, None)
        if self.allocator is not None:
            self.allocator.free_request(req.blocks)
            req.blocks = []
        self.pending_releases.append(slot)
        if finished:
            self._land(req)

    def fail_lane(self, slot: int, reason: str):
        """A decode lane went bad (non-finite logits): fail only this
        request, the rest of the batch untouched.  Within the retry budget
        it is requeued from its original prompt, after a backoff of 2^attempt
        planning rounds; past it, it finishes with ``error=reason``."""
        req = self.slot_req[slot]
        self.lane_faults += 1
        if req.attempts < self.gcfg.max_retries:
            req.attempts += 1
            self._evict(slot, req, finished=False)
            req.prompt = list(req.prompt[:req.orig_len])
            req.out, req.tok_times = [], []
            req.prefix_len = req.prefilled = 0
            req.not_before = self._round + (1 << req.attempts)
            self.queue.append(req)
        else:
            req.error = reason
            self._evict(slot, req, finished=True)

    def expire_deadlines(self, now: float):
        """Fail queued and running requests past their ``deadline_s`` (no
        retry: the clock that expired them keeps running); running ones keep
        their partial output."""
        for req in [r for r in self.queue
                    if r.deadline_s > 0 and now - r.submit_t > r.deadline_s]:
            self.queue.remove(req)
            req.error = "deadline"
            self._land(req)
            self.deadline_expirations += 1
        for slot, req in enumerate(self.slot_req):
            if (req is not None and req.deadline_s > 0
                    and now - req.submit_t > req.deadline_s):
                req.error = "deadline"
                self._evict(slot, req, finished=True)
                self.deadline_expirations += 1

    def has_deferred_work(self) -> bool:
        """Queued work to keep stepping for with no lane active: retries
        waiting out their backoff, and requests waiting out a transient
        pool starvation.  Both are bounded (the retry budget, the admission
        cap), so ``run_all`` cannot spin forever."""
        return (any(r.not_before > self._round for r in self.queue)
                or any(r.rid in self._starve for r in self.queue))

    def _pick_victim(self, exclude, limit_priority: int = 0) -> Optional[int]:
        """The least urgent running class loses first (highest priority
        number), the youngest admission within it; never a lane more urgent
        than the admitter (``priority >= limit_priority``; equal classes
        may preempt each other)."""
        cands = [(self.slot_req[s].priority, self.slot_req[s].admit_seq, s)
                 for s in self.active_slots()
                 if s not in exclude
                 and self.slot_req[s].priority >= limit_priority]
        return max(cands)[2] if cands else None

    def _preempt(self, slot: int) -> Request:
        """Evict a running slot: free its blocks and fold the generated
        tokens into the prompt, so a later re-prefill resumes the greedy
        stream exactly (per-token KV quantization makes the re-prefilled
        rows the evicted ones; ``len(prompt) + remaining`` stays
        ``orig_len + max_new``).  A victim mid-ingestion restarts.  The
        caller requeues it once the round's planning is done."""
        req = self.slot_req[slot]
        req.prompt = list(req.prompt[:req.orig_len]) + list(req.out)
        req.prefilled = 0
        self._evict(slot, req, finished=False)
        self.preemptions += 1
        self._recent_victims.add(req.rid)
        return req

    def _fail_admission(self, req: Request):
        self.queue.remove(req)
        self._starve.pop(req.rid, None)
        req.error = "admission retries exhausted"
        self._land(req)
        self.admission_failures += 1

    def plan_admissions(self) -> List[AdmissionGroup]:
        """Pop eligible queued requests (backoff round reached) into free
        slots in :meth:`_sel_key` order and group the round's admissions by
        (bucket of the uncached tail, prefix_len): one prefill per group.

        Paged: each admission reserves its blocks upfront.  On pool
        exhaustion a running slot is preempted (:meth:`_pick_victim`)
        instead of stalling; victims are held out of the queue until
        planning ends, then requeued at the front, and resume by re-prefill
        in a later round.  A fresh victim may not preempt in turn until
        decode has progressed (no admit-round ping-pong).  The loop is
        capped per request per round (``guard_cfg.max_admission_attempts``,
        at least ``max_slots + 1``), and a pool short with no lane running
        to free it (theft, a leak) is waited out for as many rounds: past
        either, the request fails with ``error="admission retries
        exhausted"``.  A request whose uncached tail exceeds
        ``prefill_chunk`` claims its slot and blocks (registered in the
        trie only as rows land) and enters the ``prefilling`` ledger, its
        lane parked, instead of a group."""
        self._round += 1
        cap = max(self.gcfg.max_admission_attempts, self.ecfg.max_slots + 1)
        attempts: Dict[int, int] = {}
        picked: List[tuple] = []
        victims: List[Request] = []
        free = self.free_slots()
        while free:
            req = min((r for r in self.queue if r.not_before <= self._round),
                      key=self._sel_key, default=None)
            if req is None:
                break
            if self.allocator is not None:
                try:
                    req.blocks, req.prefix_len = self.allocator.allocate(
                        req.prompt, req.remaining, self.ecfg.max_len,
                        register=not self._maybe_chunked(req))
                except MemoryError:
                    attempts[req.rid] = attempts.get(req.rid, 0) + 1
                    if attempts[req.rid] >= cap:
                        self._fail_admission(req)
                        continue            # next eligible request
                    victim = self._pick_victim({s for s, _ in picked},
                                               limit_priority=req.priority)
                    if victim is None or req.rid in self._recent_victims:
                        if not self.active_slots() and not picked:
                            n = self._starve.get(req.rid, 0) + 1
                            self._starve[req.rid] = n
                            if n >= cap:
                                self._fail_admission(req)
                        break               # nothing evictable: wait
                    victims.append(self._preempt(victim))
                    free = self.free_slots()
                    continue                # retry with the freed blocks
            self._starve.pop(req.rid, None)
            self.queue.remove(req)
            req.admit_seq = next(self._admit_seq)
            slot = free.pop(0)
            self.slot_req[slot] = req       # claimed now: a later preemption
            picked.append((slot, req))      # in this round must not free it
            if self._chunked(req):
                req.prefilled = req.prefix_len
                self.prefilling[slot] = req
                self.pending_releases.append(slot)  # park the lane
            elif self.allocator is not None and self._maybe_chunked(req):
                # prefix hits shrank the tail under one chunk: a group
                # after all, so register the deferred blocks now
                self.allocator.register_blocks(req.prompt, req.blocks,
                                               len(req.prompt))
        for req in reversed(victims):       # oldest victim resumes first
            self.queue.appendleft(req)
        groups: Dict[tuple, AdmissionGroup] = {}
        for slot, req in picked:
            if slot in self.prefilling:
                continue
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

    @staticmethod
    def _sel_key(req: Request):
        """Admission order: priority class, then absolute deadline (none
        last), then submission."""
        dl = (req.submit_t + req.deadline_s if req.deadline_s > 0
              else float("inf"))
        return (req.priority, dl, req.rid)

    def _maybe_chunked(self, req: Request) -> bool:
        """Whether the request may need chunked ingestion, decided before
        the prefix match (defers the trie registration)."""
        c = self.ecfg.prefill_chunk
        return c > 0 and len(req.prompt) > c

    def _chunked(self, req: Request) -> bool:
        """Whether the uncached tail exceeds one chunk."""
        c = self.ecfg.prefill_chunk
        return c > 0 and len(req.prompt) - req.prefix_len > c

    # ------------------------------------------------------- chunked prefill

    def plan_prefill_chunks(self) -> List[ChunkPlan]:
        """The round's chunks, most urgent request first, at most
        ``prefill_budget`` padded tokens (default one chunk per round, so
        decode runs between chunks); at least one while ingestion is
        pending.  The engine lands each with :meth:`note_chunk`."""
        if not self.prefilling:
            return []
        chunk = self.ecfg.prefill_chunk
        budget = self.ecfg.prefill_budget or chunk
        plans: List[ChunkPlan] = []
        spent = 0
        for slot, req in sorted(self.prefilling.items(),
                                key=lambda kv: self._sel_key(kv[1])):
            plen, prog = len(req.prompt), req.prefilled
            while prog < plen and (spent < budget or not plans):
                n = min(chunk, plen - prog)
                plans.append(ChunkPlan(slot, req, prog, n,
                                       final=prog + n >= plen))
                prog += n
                spent += chunk          # padded tokens
            if spent >= budget:
                break
        return plans

    def note_chunk(self, plan: ChunkPlan, tokens: float):
        """A chunk landed: advance the resident mark, register the freshly
        written full blocks in the prefix trie, count the padded chunk into
        the cadence.  The final chunk counts as the admission and leaves
        the ledger."""
        req = plan.req
        req.prefilled = plan.start + plan.length
        if self.allocator is not None:
            self.allocator.register_blocks(req.prompt, req.blocks,
                                           req.prefilled)
        self.prefill_chunks += 1
        self.note_admitted(1 if plan.final else 0, tokens)
        if plan.final:
            self.prefilling.pop(plan.slot, None)

    # -------------------------------------------------------- requant cadence

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

    # --------------------------------------------------------------- results

    def finish(self, slot: int):
        req = self.slot_req[slot]
        req.done = True
        self._evict(slot, req, finished=True)

    def cancel(self, rid: int) -> bool:
        """Abort a queued or running request: its slot and (paged) blocks,
        a chunked prefill's partly written ones included, free at once and
        its partial output lands as ``cancelled``.  False for an unknown or
        already finished rid."""
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                req.cancelled = True
                self._land(req)
                return True
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.rid == rid:
                req.cancelled = True
                self._evict(slot, req, finished=True)
                return True
        return False

    def record_block(self, tokens, valid, done, fault=None,
                     now: float = 0.0) -> int:
        """Fold one decode block's host copies ((B, C) tokens/valid, (B,)
        done, (B,) fault flags or None) into the requests; returns the
        tokens accepted.  A faulted lane's block is dropped whole and the
        request fails alone (:meth:`fail_lane`); lanes mid-ingestion are
        parked done, which is not an EOS, and are skipped."""
        accepted = 0
        for slot in self.decode_slots():
            req = self.slot_req[slot]
            if fault is not None and fault[slot]:
                self.fail_lane(slot, "non-finite logits")
                continue
            for k in range(tokens.shape[1]):
                if valid[slot, k]:
                    self.emit(req, int(tokens[slot, k]), now)
                    accepted += 1
            if done[slot]:
                self.finish(slot)
        self.note_decoded(accepted)
        return accepted

    def results(self, include_partials: bool = True) -> Dict[int, GenResult]:
        """Finished outputs and, by default, queued or running partials
        flagged ``unfinished``; cancelled and failed ones are flagged too."""
        out = {rid: GenResult(req.out,
                              unfinished=req.cancelled or bool(req.error),
                              cancelled=req.cancelled, error=req.error)
               for rid, req in self.finished.items()}
        if include_partials:
            pending = [r for r in self.slot_req if r is not None]
            for req in pending + list(self.queue):
                out[req.rid] = GenResult(req.out, unfinished=True)
        return out
