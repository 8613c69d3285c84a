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
and defaults; options whose machinery is not ported yet raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from repro_torch._device import resolve_device
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.stack import mixer_kinds, stack_spec
from repro_torch.quant import CalibrationSession, QuantizedModel
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
    # ---- paged KV pool ----
    kv_paged: Optional[bool] = None  # None → policy.kvcache.paged
    kv_block_size: int = 0          # tokens per pool block; 0 → policy
    kv_pool_blocks: int = 0         # physical blocks per layer incl. the
                                    # sink; 0 → max_slots·max_len/block_size
                                    # + 1, which never preempts; smaller
                                    # pools oversubscribe and preempt
    prefix_cache: bool = True       # share quantized prompt-prefix blocks
    requant_threshold: float = -1.0  # ≥0 → delta-gated requantization
    double_buffer: bool = False     # requant into the tree decode is not
                                    # reading; swap when it is ready
    speculate_k: int = 0            # W drafted tokens per verify window (0
                                    # off); greedy only, so it turns off at
                                    # temperature > 0; decode_chunk then
                                    # counts windows
    # ---- fields of the reference whose machinery comes in later slices;
    # a non-default value raises NotImplementedError ----
    guards: bool = True             # guards and faults (this slice: False)
    guard_cfg: object = None
    deadline_s: float = 0.0
    prefill_chunk: int = 0          # chunked prefill / streaming server
    prefill_budget: int = 0
    max_queue: int = 0


_LATER = [  # (field, value that keeps it off, slice that brings it)
    ("guards", False, "guards and faults"),
    ("guard_cfg", None, "guards and faults"),
    ("deadline_s", 0.0, "guards and faults"),
    ("prefill_chunk", 0, "chunked prefill and the server"),
    ("prefill_budget", 0, "chunked prefill and the server"),
    ("max_queue", 0, "chunked prefill and the server"),
]


def _check_slice(ecfg: EngineConfig):
    for field in {f for f, _, _ in _LATER}:
        val = getattr(ecfg, field)
        offs = [v for f, v, _ in _LATER if f == field]
        if val not in offs:
            later = next(s for f, _, s in _LATER if f == field)
            raise NotImplementedError(
                f"EngineConfig.{field}={val!r}: {later} is ported in a later "
                f"slice (set {field}={offs[0]!r})")


class TTQEngine:
    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 ecfg: EngineConfig = EngineConfig(), *, device="cuda",
                 generator=None, draft_policy: Optional[QuantPolicy] = None,
                 lowrank=_AUTO):
        _check_slice(ecfg)
        if ecfg.speculate_k > 0 and ecfg.temperature > 0.0:
            # greedy acceptance would bias sampled streams
            ecfg = dataclasses.replace(ecfg, speculate_k=0)
        if ecfg.speculate_k > 0 and mixer_kinds(cfg) != {"attn"}:
            raise ValueError(
                f"speculate_k needs a plain-attention family, got "
                f"{sorted(mixer_kinds(cfg))} (windowed/latent/recurrent "
                f"decode states cannot roll back rejected drafts)")
        stack_spec(cfg)                       # rejects families not ported
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
        self.kncfg = policy.kernel
        if ecfg.use_kernels is not None:
            self.kncfg = dataclasses.replace(self.kncfg,
                                             use_pallas=ecfg.use_kernels)
        self.runner = DeviceRunner(cfg, ecfg, self.kvcfg, kncfg=self.kncfg,
                                   device=self.device, generator=generator,
                                   num_blocks=self.num_blocks)
        self.qmodel = QuantizedModel(
            params, policy,
            session=CalibrationSession(halflife=ecfg.stats_halflife),
            double_buffer=ecfg.double_buffer, draft_policy=self.draft_policy,
            lowrank=lowrank)
        self.scheduler = Scheduler(ecfg, self.kvcfg, self.num_blocks)
        self.requant_wall_s = 0.0

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

    def submit(self, prompt, max_new: int = 16) -> int:
        return self.scheduler.submit(prompt, max_new)

    def cancel(self, rid: int) -> bool:
        """Abort a queued or running request: its slot and (paged) blocks
        free at once, and ``results()`` returns its partial output flagged
        ``cancelled``.  False for an unknown or finished rid."""
        ok = self.scheduler.cancel(rid)
        self._flush_releases()
        return ok

    def _flush_releases(self):
        """Deactivate on the device the slots the scheduler freed (finish,
        preempt, cancel) before their blocks can be handed out again."""
        if self.scheduler.pending_releases:
            self.runner.release_slots(self.scheduler.pending_releases)
            self.scheduler.pending_releases = []

    def admit(self):
        """Admit queued requests into free slots (one prefill per bucket
        group), calibrate on their stats, requantize per cadence."""
        while True:
            groups = self.scheduler.plan_admissions()
            self._flush_releases()   # preempted slots → sink before prefill
            if not groups:
                break
            for group in groups:
                first, fin, stats = self.runner.admit_group(self.params, group)
                self.qmodel.calibrate(stats, tokens=group.tokens)
                self.scheduler.note_admitted(len(group.requests), group.tokens)
                for i, (slot, req) in enumerate(zip(group.slots,
                                                    group.requests)):
                    req.out.append(int(first[i]))
                    if fin[i]:
                        self.scheduler.finish(slot)
        self._flush_releases()
        if self.scheduler.should_requant():
            self._requantize()

    def step(self) -> bool:
        """Admit, then decode one fused block over the active slots."""
        self.admit()
        if not self.scheduler.active_slots():
            return False
        toks, valid, done = self.runner.decode_block(self.decode_params,
                                                     self.draft_params)
        self.scheduler.record_block(toks, valid, done)
        self._flush_releases()
        if self.scheduler.should_requant():
            self._requantize()
        return True

    def run_all(self, max_iters: int = 10_000) -> Dict[int, GenResult]:
        it = 0
        while self.scheduler.has_work() and it < max_iters:
            if not self.step():
                break
            it += 1
        return self.scheduler.results()
