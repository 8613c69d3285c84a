"""TTQEngine — continuous-batching serving with online test-time quantization.

  submit → [queue] → admit: PREFILL in full precision, stats tap on
                     → CALIBRATE (CalibrationSession)
                     → REQUANTIZE: D = f(stats); W_int,S,Z = G[(W−BA)∘D]
                       — ``ttq_quantize`` launches per weight stack, only
                       for the families the delta gate lets through
                       (``requant_threshold``), landing in the tree decode
                       reads or, with ``double_buffer``, in the other one
                     → DECODE in fused K-step blocks, each one replay of
                       a CUDA graph on the card; every packed-weight
                       matmul runs ``ttq_gemm`` and every int8/int4 KV read
                       ``ttq_decode_attention`` (dense slab) or
                       ``ttq_paged_decode_attention`` (paged pool)
                     → or, with ``speculate_k`` = W, SPECULATE: K windows
                       per block, each W draft decode steps on the draft
                       tree (``draft_policy``, by default
                       ``policy.draft_variant()``, requantized beside the
                       verify tree) and one verify pass over the window

A facade over the :class:`Scheduler` (host policy), the
:class:`DeviceRunner` (device execution) and :class:`QuantizedModel` (TTQ
state; ``lowrank=`` hands it low-rank factors computed earlier, so the
engine runs no SVD).  ``EngineConfig`` keeps the reference's field names
and defaults.

The robustness layer (``guards``, on by default) validates each
calibration update (quarantine, rollback), holds each requant's candidate
tree to a health gate before it is swapped in, isolates a lane whose
logits go non-finite (it fails or retries alone), and under KV-pool
pressure climbs a degradation ladder: 1 speculation off, 2 K = 1 decode
blocks, 3 cached prefix blocks dropped.  ``faults=`` (a
:class:`~repro_torch.serving.faults.FaultInjector`) drives its injection
sites and may bring a virtual clock.  Streaming and SLOs: ``submit(
deadline_s=, priority=)``, ``prefill_chunk``/``prefill_budget`` (long
prompts ingested in chunks between decode blocks), ``max_queue``
(``QueueFull``), ``set_stream_callbacks`` and ``latency_percentiles``.

Tensor parallelism: ``pctx=`` (``launch/mesh.py:make_ctx``) serves on one
rank of a model axis.  Every rank constructs the engine with the whole
parameters (the same seed everywhere) and runs the same requests; the
engine binds the layout (``parallel/rules.py:bind``, with the policies'
column alignment), computes the low-rank factors on the whole weights
(the verify tree's and a rank > 0 draft tree's), keeps the rank's slices
(``DeviceRunner.place_params``, ``rules.shard_lowrank``) and from then
on holds only those.  Every family serves this way: a MoE layer takes
``pctx.moe_impl`` (``"a2a"`` by default, as the reference's: token
dispatch with capacity, count statistics; ``"dense"``: each rank's
experts over every token).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.stack import mixer_kinds
from repro_torch.parallel.rules import bind, col_align, shard_lowrank
from repro_torch.quant import CalibrationSession, QuantizedModel
from repro_torch.quant.api import lowrank_tree
from repro_torch.quant.guards import GuardConfig
from repro_torch.quant.model import _AUTO

from .runner import DeviceRunner
from .scheduler import GenResult, Scheduler, pick_decode_chunk


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    max_len: int = 256
    decode_chunk: int = 1           # K fused decode steps per host sync;
                                    # 0 → auto via pick_decode_chunk(slots)
    recalibrate_every: int = 1      # requantize after every N admissions
    recalibrate_tokens: int = 0     # >0: token-budget cadence instead
    stats_halflife: int = 0         # >0: exponential decay of stats (updates)
    temperature: float = 0.0
    eos_token: int = -1             # -1 → run to max_new
    prompt_buckets: tuple = (16, 32, 64, 128, 256)
    kv_dtype: str = ""              # "" → policy.kvcache; else bf16|int8|int4
    use_kernels: Optional[bool] = None  # None → policy.kernel.use_pallas;
                                    # flips only the decode GEMM dispatch
    requant_threshold: float = -1.0  # ≥0 → delta-gated requantization
    double_buffer: bool = False     # requant into the tree decode is not
                                    # reading; swap when it is ready
    # ---- paged KV pool ----
    kv_paged: Optional[bool] = None  # None → policy.kvcache.paged
    kv_block_size: int = 0          # tokens per pool block; 0 → policy
    kv_pool_blocks: int = 0         # physical blocks per layer incl. the
                                    # sink; 0 → max_slots·max_len/block_size
                                    # + 1, which never preempts; smaller
                                    # pools oversubscribe and preempt
    prefix_cache: bool = True       # share quantized prompt-prefix blocks
    speculate_k: int = 0            # W drafted tokens per verify window (0
                                    # off); greedy only, so it turns off at
                                    # temperature > 0; decode_chunk then
                                    # counts windows
    # ---- robustness layer ----
    guards: bool = True             # calibration validation, requant health
                                    # gate, decode fault isolation and the
                                    # degradation ladder; off = the
                                    # unguarded engine, decode program
                                    # included
    guard_cfg: GuardConfig = GuardConfig()  # its knobs
    deadline_s: float = 0.0         # default per-request wall budget from
                                    # submit (0 = none)
    # ---- streaming and SLO scheduling ----
    prefill_chunk: int = 0          # >0: ingest prompt tails longer than
                                    # this in chunks between decode blocks
                                    # (plain-attention families; must divide
                                    # a paged pool's block size); lifts the
                                    # bucket cap on prompt length
    prefill_budget: int = 0         # padded prefill tokens per engine round
                                    # (0 → one chunk per round)
    max_queue: int = 0              # >0: submit() raises QueueFull at this
                                    # queue depth; 0 = unbounded


class TTQEngine:
    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 ecfg: EngineConfig = EngineConfig(), *, device="cuda",
                 generator=None, draft_policy: Optional[QuantPolicy] = None,
                 lowrank=_AUTO, faults=None, pctx=None):
        if ecfg.speculate_k > 0 and ecfg.temperature > 0.0:
            # greedy acceptance would bias sampled streams
            ecfg = dataclasses.replace(ecfg, speculate_k=0)
        if ecfg.speculate_k > 0 and mixer_kinds(cfg) != {"attn"}:
            raise ValueError(
                f"speculate_k needs a plain-attention family, got "
                f"{sorted(mixer_kinds(cfg))} (windowed/latent/recurrent "
                f"decode states cannot roll back rejected drafts)")
        if ecfg.prefill_chunk > 0 and mixer_kinds(cfg) != {"attn"}:
            raise ValueError(
                f"prefill_chunk needs a plain-attention family, got "
                f"{sorted(mixer_kinds(cfg))} (chunked ingestion gathers and "
                f"extends one per-layer k/v context per chunk)")
        self.device = resolve_device(device)
        if ecfg.decode_chunk <= 0:
            ecfg = dataclasses.replace(
                ecfg, decode_chunk=pick_decode_chunk(ecfg.max_slots,
                                                     ecfg.speculate_k))
        self.cfg, self.params, self.policy, self.ecfg = cfg, params, policy, ecfg
        # the draft tree: the policy's uniform low-bit variant unless given;
        # a disabled verify policy with an enabled draft_policy is
        # draft-only quantization
        self.draft_policy = None
        if ecfg.speculate_k > 0:
            self.draft_policy = (draft_policy if draft_policy is not None
                                 else policy.draft_variant())
        self.kvcfg = policy.kvcache
        if ecfg.kv_dtype:
            self.kvcfg = dataclasses.replace(self.kvcfg, dtype=ecfg.kv_dtype)
        if ecfg.kv_paged is not None:
            self.kvcfg = dataclasses.replace(self.kvcfg, paged=ecfg.kv_paged)
        if ecfg.kv_block_size:
            self.kvcfg = dataclasses.replace(self.kvcfg,
                                             block_size=ecfg.kv_block_size)
        # paged pool geometry: blocks per layer, block 0 the sink.  The
        # default holds every slot at max_len, so it never preempts.
        self.num_blocks = 0
        if self.kvcfg.paged:
            if ecfg.max_len % self.kvcfg.block_size:
                raise ValueError(
                    f"max_len={ecfg.max_len} must divide by "
                    f"kv block_size={self.kvcfg.block_size}")
            self.num_blocks = (ecfg.kv_pool_blocks or ecfg.max_slots
                               * (ecfg.max_len // self.kvcfg.block_size) + 1)
            if (ecfg.prefill_chunk > 0
                    and ecfg.prefill_chunk % self.kvcfg.block_size):
                raise ValueError(
                    f"prefill_chunk={ecfg.prefill_chunk} must divide by kv "
                    f"block_size={self.kvcfg.block_size}: chunk boundaries "
                    f"must align with pool blocks so the prefix gather "
                    f"reads whole written blocks")
        self.kncfg = policy.kernel
        if ecfg.use_kernels is not None:
            self.kncfg = dataclasses.replace(self.kncfg,
                                             use_pallas=ecfg.use_kernels)
        self.pctx = bind(pctx, cfg, col_align(policy, self.draft_policy)) \
            if pctx is not None else None
        self.runner = DeviceRunner(cfg, ecfg, self.kvcfg, kncfg=self.kncfg,
                                   device=self.device, generator=generator,
                                   num_blocks=self.num_blocks, pctx=self.pctx)
        draft_lowrank = _AUTO
        if self.pctx is not None:       # factors of the whole weights
            if lowrank is _AUTO:
                lowrank = lowrank_tree(params, policy) \
                    if policy.any_enabled else None
            dp = self.draft_policy
            if dp is not None and dp.any_enabled and dp.rank > 0:
                draft_lowrank = shard_lowrank(lowrank_tree(params, dp),
                                              self.pctx)
            params, lowrank = self.runner.place_params(params, lowrank)
            self.params = params
        # one GuardConfig drives the session's validation, the model's
        # health gate, the scheduler's retries and the degradation ladder
        guard = ecfg.guard_cfg if ecfg.guards else None
        self.qmodel = QuantizedModel(
            params, policy,
            session=CalibrationSession(halflife=ecfg.stats_halflife,
                                       guard=guard, pctx=self.pctx),
            double_buffer=ecfg.double_buffer, draft_policy=self.draft_policy,
            lowrank=lowrank, draft_lowrank=draft_lowrank, health_gate=guard,
            pctx=self.pctx)
        self.scheduler = Scheduler(
            ecfg, self.kvcfg, self.num_blocks,
            exact_buckets=cfg.family in ("hybrid", "ssm"))
        self.requant_wall_s = 0.0
        self.faults = faults
        self._clock = time.monotonic
        if faults is not None:
            if faults.clock is not None:
                self._clock = faults.clock
            self.qmodel._fault_hook = faults.requant_hook
        self.degrade_level = 0          # 0 normal, 1 no speculation, 2 K = 1,
        self.degrade_events = 0         # 3 cached prefix blocks dropped

    def _requantize(self):
        thr = self.ecfg.requant_threshold
        t0 = time.perf_counter()
        tree = self.qmodel.requantize(threshold=thr if thr >= 0 else None)
        self.requant_wall_s += time.perf_counter() - t0
        if tree is not None:
            self.scheduler.note_requant()

    @property
    def decode_params(self):
        return self.qmodel.decode_params

    @property
    def draft_params(self):
        """The tree a speculative block drafts with (None when speculation
        is off)."""
        if self.ecfg.speculate_k <= 0:
            return None
        return self.qmodel.draft_params

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted drafts over drafted tokens, across all windows."""
        r = self.runner
        return r.spec_accepted / r.spec_drafted if r.spec_drafted else 0.0

    @property
    def spec_windows(self) -> int:
        return self.runner.spec_windows

    @property
    def qparams(self):
        return self.qmodel.qparams

    @property
    def n_requants(self) -> int:
        return self.qmodel.n_requants

    @property
    def lowrank_tree(self):
        return self.qmodel.lowrank_tree

    @property
    def layers_requantized(self) -> int:
        """Quantized-leaf requantizations dispatched across all requants."""
        return self.qmodel.total_requant_layers

    @property
    def layers_skipped(self) -> int:
        """Quantized-leaf requantizations the delta gate skipped."""
        return self.qmodel.total_skipped_layers

    @property
    def host_syncs(self) -> int:
        return self.runner.host_syncs

    # the reference's facade over the session, scheduler and runner
    # (``repro/serving/engine.py:309-343``)

    @property
    def agg_stats(self):
        return self.qmodel.session.stats

    @property
    def stat_count(self):
        return self.qmodel.session.count

    @property
    def admits_since_cal(self):
        return self.scheduler.admits_since_cal

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def slot_req(self):
        return self.scheduler.slot_req

    @property
    def finished(self):
        return self.scheduler.finished

    @property
    def pos(self):
        return self.runner.pos

    @property
    def cur_tok(self):
        return self.runner.cur_tok

    @property
    def compiled_programs(self) -> int:
        """Programs resident on the device, the reference's count
        (``src/repro/serving/engine.py:compiled_programs``): the runner's
        decode graphs (one per layout of the tree(s) a block reads: two
        under the double buffer, whose draft and verify trees swap together)
        and prefill graphs (one per admission shape).  The requant runs
        eagerly and holds none.  Flat once every shape of the traffic
        has been admitted."""
        return self.runner.compiled_programs

    @property
    def state(self):
        return self.runner.state

    # ------------------------------------------------- paged-pool metrics

    @property
    def allocator(self):
        """The paged pool's ``BlockAllocator`` (None on the dense slab)."""
        return self.scheduler.allocator

    @property
    def kv_pool_utilization(self) -> float:
        """Peak fraction of allocatable pool blocks ever in use."""
        a = self.allocator
        return a.peak_in_use / max(a.capacity, 1) if a else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        a = self.allocator
        return a.prefix_hit_rate() if a else 0.0

    @property
    def preemptions(self) -> int:
        return self.scheduler.preemptions

    @property
    def prefill_tokens(self) -> float:
        """Padded tokens dispatched to prefill (prefix hits shrink this)."""
        return self.scheduler.prefill_tokens

    # ------------------------------------- streaming and SLO telemetry

    @property
    def queue_depth(self) -> int:
        """Requests waiting in the intake queue."""
        return len(self.scheduler.queue)

    @property
    def queue_rejections(self) -> int:
        """Submits refused at ``max_queue``."""
        return self.scheduler.queue_rejections

    @property
    def prefill_chunks(self) -> int:
        """Chunked-prefill chunks dispatched (0 with chunking off)."""
        return self.scheduler.prefill_chunks

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 time to first token and inter-token latency (seconds on
        the engine's clock) over every request that emitted tokens, finished
        or running."""
        reqs = list(self.scheduler.finished.values())
        reqs += [r for r in self.scheduler.slot_req if r is not None]
        ttfts, itls = [], []
        for r in reqs:
            ts = r.tok_times
            if not ts:
                continue
            ttfts.append(ts[0] - r.submit_t)
            itls += [b - a for a, b in zip(ts, ts[1:])]

        def pct(xs, q):
            if not xs:
                return 0.0
            s = sorted(xs)
            return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]

        return {"ttft_p50": pct(ttfts, 0.50), "ttft_p99": pct(ttfts, 0.99),
                "itl_p50": pct(itls, 0.50), "itl_p99": pct(itls, 0.99),
                "n_streams": len(ttfts), "n_itl": len(itls)}

    # -------------------------------------------------- robustness telemetry

    @property
    def calib_rejections(self) -> int:
        """Calibration updates the session's guard quarantined."""
        return self.qmodel.session.n_rejected

    @property
    def quarantine(self):
        """The session's bounded quarantine log (``QuarantineRecord``s)."""
        return self.qmodel.session.quarantine

    @property
    def requant_rejections(self) -> int:
        """Candidate trees the health gate refused."""
        return self.qmodel.requant_rejections

    @property
    def lane_faults(self) -> int:
        return self.scheduler.lane_faults

    @property
    def deadline_expirations(self) -> int:
        return self.scheduler.deadline_expirations

    @property
    def admission_failures(self) -> int:
        """Requests failed at the admission-attempt cap."""
        return self.scheduler.admission_failures

    # --------------------------------------------------------------- serving

    def submit(self, prompt, max_new: int = 16, frames=None,
               deadline_s=None, priority: int = 0) -> int:
        """Queue a request; refuses prompts the engine cannot admit, and
        raises ``QueueFull`` at ``max_queue``.  ``frames`` (n_frames,
        d_model), or (1, n_frames, d_model): the encoder-decoder family's
        input, which its encoder reads at admission (required there, refused
        elsewhere).  ``deadline_s`` (seconds from now, 0 none; default
        ``EngineConfig.deadline_s``) fails the request with ``error ==
        "deadline"`` once it is past, queued or running; ``priority`` (lower
        = more urgent) orders admission, preemption and chunked
        ingestion."""
        if (frames is None) != (self.cfg.family != "encdec"):
            raise ValueError(
                f"frames go with the encoder-decoder family only, and it "
                f"needs them (family {self.cfg.family!r}, frames "
                f"{'missing' if frames is None else 'given'})")
        if frames is not None:
            want = (self.cfg.encdec.n_frames, self.cfg.d_model)
            frames = np.asarray(frames, np.float32)
            if frames.shape not in (want, (1, *want)):
                raise ValueError(f"frames of shape {frames.shape}, want "
                                 f"{want}")
            frames = frames.reshape(want)
        return self.scheduler.submit(prompt, max_new, frames=frames,
                                     deadline_s=deadline_s,
                                     now=self._clock(), priority=priority)

    def set_stream_callbacks(self, on_token=None, on_finish=None):
        """``on_token(rid, tok, t)`` for every emitted token (the first one
        included), ``on_finish(rid, req)`` once per terminal landing.  They
        run on the thread that drives the engine and must do no device
        work."""
        self.scheduler.on_token = on_token
        self.scheduler.on_finish = on_finish

    def cancel(self, rid: int) -> bool:
        """Abort a queued or running request: its slot and (paged) blocks
        free at once, and ``results()`` returns its partial output flagged
        ``cancelled``.  False for an unknown or finished rid."""
        ok = self.scheduler.cancel(rid)
        self._flush_releases()
        return ok

    def _flush_releases(self):
        """Deactivate on the device the slots the scheduler freed (finish,
        preempt, cancel, park) before their blocks can be handed out
        again."""
        if self.scheduler.pending_releases:
            self.runner.release_slots(self.scheduler.pending_releases)
            self.scheduler.pending_releases = []

    def _calibrate(self, stats, tokens, rids):
        """Fold one prefill's statistics, through the fault site."""
        if self.faults is not None:
            stats, tokens = self.faults.calib_site(stats, tokens, rids)
        if stats is not None:           # a "drop" fault skips the fold
            self.qmodel.calibrate(stats, tokens=tokens, provenance=rids)

    def admit(self):
        """Admit queued requests into free slots (one prefill per bucket
        group), calibrate on their stats, requantize per cadence.  Loops
        while planning admits: a request that finishes at admission frees
        its slot for the next one."""
        while True:
            groups = self.scheduler.plan_admissions()
            self._flush_releases()   # preempted slots → sink before prefill
            if not groups:
                break
            for group in groups:
                first, fin, stats = self.runner.admit_group(self.params, group)
                self._calibrate(stats, group.tokens,
                                tuple(r.rid for r in group.requests))
                self.scheduler.note_admitted(len(group.requests), group.tokens)
                now = self._clock()
                for i, (slot, req) in enumerate(zip(group.slots,
                                                    group.requests)):
                    self.scheduler.emit(req, int(first[i]), now)
                    if fin[i]:
                        self.scheduler.finish(slot)
        self._flush_releases()
        if self.scheduler.should_requant():
            self._requantize()

    def _run_chunks(self):
        """This round's chunks (at most ``prefill_budget`` padded tokens,
        most urgent first).  Each folds its statistics into the session:
        additive, so the requant sees the whole prompt over its chunks.  A
        final chunk arms the lane and emits the first token."""
        plans = self.scheduler.plan_prefill_chunks()
        for plan in plans:
            first, fin, stats = self.runner.prefill_chunk(self.params, plan)
            C = float(self.ecfg.prefill_chunk)
            self._calibrate(stats, C, (plan.req.rid,))
            self.scheduler.note_chunk(plan, C)
            if plan.final:
                self.scheduler.emit(plan.req, int(first[0]), self._clock())
                if fin[0]:
                    self.scheduler.finish(plan.slot)
        if plans:
            self._flush_releases()

    def _update_ladder(self):
        """The degradation ladder under KV-pool pressure (paged, guards on):
        pressure = share of allocatable blocks not free.  At or above
        ``degrade_pressure`` one rung up, at or below ``recover_pressure``
        one down: 1 speculation off, 2 K = 1 decode blocks (one more graph,
        captured once), 3 cached prefix blocks dropped to the free list.
        Each climb counts in ``degrade_events``."""
        a, gcfg = self.allocator, self.ecfg.guard_cfg
        if a is None or not self.ecfg.guards:
            return
        pressure = 1.0 - len(a.free) / max(a.capacity, 1)
        if pressure >= gcfg.degrade_pressure and self.degrade_level < 3:
            self.degrade_level += 1
            self.degrade_events += 1
            if self.degrade_level >= 3:
                a.drop_cached()
        elif pressure <= gcfg.recover_pressure and self.degrade_level > 0:
            self.degrade_level -= 1

    def step(self) -> bool:
        """One iteration: fault sites, deadlines, admission, chunks, the
        ladder, then one fused block over the decoding slots.  True while
        there is work to drive, rounds spent waiting out a retry backoff
        included."""
        now = self._clock()
        if self.faults is not None:
            self.faults.on_step(self)
        self.scheduler.expire_deadlines(now)
        self._flush_releases()
        self.admit()
        self._run_chunks()
        self._update_ladder()
        if not self.scheduler.decode_slots():
            return (bool(self.scheduler.prefilling)
                    or self.scheduler.has_deferred_work())
        draft = None if self.degrade_level >= 1 else self.draft_params
        if self.faults is not None and self.runner.detect_faults:
            self.runner.set_poison(self.faults.decode_site(
                self.scheduler.slot_req, self.scheduler._round))
        toks, valid, done, fault = self.runner.decode_block(
            self.decode_params, draft, small_chunk=self.degrade_level >= 2)
        self.scheduler.record_block(toks, valid, done, fault=fault,
                                    now=self._clock())
        self._flush_releases()
        if self.scheduler.should_requant():
            self._requantize()
        return True

    def run_all(self, max_iters: int = 10_000) -> Dict[int, GenResult]:
        """Drive until every request finished; partial outputs come back
        flagged ``unfinished`` when ``max_iters`` is hit."""
        it = 0
        while self.scheduler.has_work() and it < max_iters:
            if not self.step():
                break
            it += 1
        return self.scheduler.results()
