"""DeviceRunner — the device half of the engine.

Owns the batched decode state (per-layer slot caches, positions, per-slot
done flags and budgets) and runs:

* a bucketed batched prefill per admission group, stats tap on;
* ``lm.decode_many`` — ``decode_chunk`` fused decode steps with sampling,
  EOS, budget and capacity masking on the device, so the host sees ONE
  transfer per block (tokens, valid flags and done flags in one tensor);
* with ``speculate_k`` = W > 0 and a draft tree, ``lm.speculate_many``
  instead — ``decode_chunk`` draft/verify windows of W drafts each, the
  block K·(W+1) columns wide, its acceptance read from the same one
  transfer (``spec_windows``, ``spec_drafted``, ``spec_accepted``).

With a paged ``KVCacheConfig`` the slot caches are per-layer block pools
plus a per-slot ``block_table``: admission scatters the prefill's rows
into the slots' physical blocks (a prefix-cache hit prefills only the
prompt's tail, gathering the cached prefix from the pool), and
``release_slots`` points freed slots at the sink block 0, so their
done-lane writes never reach blocks handed to someone else.

On a CUDA device a decode block and an admission group's prefill are CUDA
graphs, the port's counterparts of the reference's ``jax.jit(lm.
decode_many)`` and ``_prefill_jit``.  The first run at a new key runs
eagerly on a side stream (it warms cuBLAS and the kernel library), then
its work is captured; every later run at that key replays the graph.  A
decode graph is keyed by the layout (see :func:`_layout`) of everything a
block reads (a speculative block reads two trees, and is keyed by both);
a prefill graph by (bucket, group size, prefix length) and the parameter
tree's layout (paged or not is the runner's).  A graph reads
the addresses it captured, so everything it reads keeps its storage: the
decode state, ``cur_tok``/``pos``/``done``/``remaining`` (written in
place; the block ends by copying its carry into them), the parameter tree
(a requant lands in place, ``quant/api.py:FusedRequantPlan.run``) and a
prefill graph's input buffers (tokens, last-row index, slots, the paged
block rows and prefix table, an encoder-decoder group's frames), which
each admission writes in place.  A tree at new storage has a new layout
and gets its own graph, so a replay
never reads a stale tree.  The prefill graphs share one memory pool: they
replay one at a time, and each replay's outputs (first tokens, stats) are
consumed before the next.  On the CPU both run eagerly, the plain
version.  There is no switch between the two and no fallback: a capture
or replay that fails raises.

With ``EngineConfig.guards`` (the default) a block runs the guarded
program: ``lm.decode_many(detect_faults=True)`` checks each step's logits
for finiteness on the device and reports a per-lane fault flag as one more
column of the block's one transfer, and a static (B,) poison mask, written
in place by :meth:`set_poison`, is the fault injector's ``decode.logits``
site.  ``decode_block(small_chunk=True)`` (the degradation ladder's rung 2)
runs a K = 1 block, its own graph, captured once per layout.

Chunked prefill (:meth:`prefill_chunk`) ingests a long prompt C =
``prefill_chunk`` tokens at a time into its parked slot: the chunk, padded
to C, attends to the rows earlier chunks wrote (gathered from the slot's
pool blocks or slab rows) and writes its own.  On the card each chunk is a
replay of a graph keyed by (C, rows already resident, parameter-tree
layout), in the prefill graphs' memory pool.

``host_syncs`` counts blocking device→host transfers.

Tensor parallelism (``pctx``): every rank runs a runner on its slice of
the parameters (:meth:`place_params`, the reference's ``runner.py:191-200``)
and of the decode state (the rank's KV heads, ``runner.py:138-143`` there),
on the same requests, so the host's decisions agree and every rank emits
the same tokens.  Under NCCL the decode, prefill, speculative and chunk
graphs capture the collectives (one eager collective creates the
communicator before the first capture).  gloo collectives cannot be
captured: over gloo the runner runs every block eagerly, says so in
``graph_mode`` and prints it once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from repro_torch.core.kvquant import dequantize_kv
from repro_torch.core.ttq import QuantizedTensor
from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_paged_kv
from repro_torch.models import lm
from repro_torch.models.common import sample_logits
from repro_torch.parallel import comm
from repro_torch.parallel.rules import shard_lowrank, shard_params

from .blocks import SINK


def _write_slots(batched, src, idx: torch.Tensor):
    """Write the rows of a batch-``n`` prefill state into slots ``idx`` of
    the batched decode state, in place (stack leaves are (L, B, ...), the
    encoder output ``enc_out`` (B, ...))."""
    for run_b, run_s in zip(batched["stack"], src["stack"]):
        for u in run_b:
            for k, leaf in run_b[u].items():
                leaf[:, idx] = run_s[u][k].to(leaf.dtype)
    if "enc_out" in src:
        batched["enc_out"][idx] = src["enc_out"].to(batched["enc_out"].dtype)


def _write_paged(pools, compact, phys: torch.Tensor, block_size: int):
    """Scatter a compact prefill state into the paged pools, in place.
    pools: per-run {'u0': {leaf: (L, NB, Hkv, bs, D·)}}; compact: the same
    with (L, n, Hkv, Sb, D·) leaves (Sb = the group's padded tail bucket);
    phys (n, nbw): the physical block of each written logical block — pad
    blocks past the prompt point at the sink."""
    bs, nbw = block_size, phys.shape[1]
    idx = phys.long()
    for run_p, run_c in zip(pools, compact):
        for u in run_p:
            for k, pool in run_p[u].items():
                cl = run_c[u][k]
                L, n, Hkv, Sb, D = cl.shape
                if nbw * bs > Sb:
                    cl = torch.nn.functional.pad(cl, (0, 0, 0, nbw * bs - Sb))
                blk = cl.reshape(L, n, Hkv, nbw, bs, D).permute(0, 1, 3, 2, 4, 5)
                pool[:, idx] = blk.to(pool.dtype)


def _write_rows(stack_state, compact, slot: torch.Tensor, start: int,
                max_len: int):
    """Write a compact chunk state into rows [start, start + C) of one slot
    of the dense slab, in place: per run {'u0': {leaf: (L, B, Hkv, ML, ·)}}
    ← (L, 1, Hkv, C, ·) leaves; ``slot`` (1,) int64.  The last chunk's pad
    columns may overhang the slab and are dropped (they hold pad rows)."""
    for run_b, run_c in zip(stack_state, compact):
        for u in run_b:
            for k, leaf in run_b[u].items():
                cl = run_c[u][k]
                n = min(cl.shape[3], max_len - start)
                leaf[:, slot, :, start:start + n] = cl[:, :, :, :n].to(
                    leaf.dtype)


def _gather_dense_prefix(stack_state, slot: torch.Tensor, pfx: int, kvcfg):
    """One slot's first ``pfx`` slab rows as the context of a prefill
    chunk, the dense twin of :func:`_gather_prefix`: quantized layouts
    dequantized to f32, the values the chunk's own attention read uses.
    ``slot`` (1,) int64.  Per run (k, v), each (L, 1, Hkv, pfx, ·)."""
    out = []
    for run in stack_state:
        st = run["u0"]
        if "k" in st:
            out.append((st["k"][:, slot, :, :pfx], st["v"][:, slot, :, :pfx]))
        else:
            out.append(tuple(
                dequantize_kv(st[nm + "_q"][:, slot, :, :pfx],
                              st[nm + "_s"][:, slot, :, :pfx],
                              torch.float32, bits=kvcfg.bits,
                              group_size=kvcfg.group_size)
                for nm in ("k", "v")))
    return out


def _gather_pool(pool: torch.Tensor, ptab: torch.Tensor) -> torch.Tensor:
    """pool (L, NB, Hkv, bs, D·) + ptab (n, nbp) → (L, n, Hkv, nbp·bs, D·):
    the plain version's per-slot gather, layer by layer, so the two layouts
    cannot drift apart."""
    return torch.stack([gather_paged_kv(p, ptab) for p in pool])


def _gather_prefix(stack_state, ptab: torch.Tensor, kvcfg):
    """The shared-prefix k/v of a tail prefill: per run, ``ptab``'s (n,
    nbp) physical blocks gathered from each layer's pool and (quantized
    layouts) dequantized to f32, the values the tail's quantize→dequantize
    attention read uses.  Per run (k, v), each (L, n, Hkv, P, ·),
    post-RoPE."""
    out = []
    for run in stack_state:
        st = run["u0"]
        if "k" in st:
            out.append((_gather_pool(st["k"], ptab),
                        _gather_pool(st["v"], ptab)))
        else:
            out.append(tuple(
                dequantize_kv(_gather_pool(st[nm + "_q"], ptab),
                              _gather_pool(st[nm + "_s"], ptab),
                              torch.float32, bits=kvcfg.bits,
                              group_size=kvcfg.group_size)
                for nm in ("k", "v")))
    return out


def _layout(tree):
    """What a captured graph bakes in about a tree of tensors: each tensor's
    address, shape, strides and dtype, and each quantized leaf's static
    fields.  Equal layouts are read at the same addresses in the same way,
    so a graph captured on one replays correctly on the other."""
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_layout(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return (tree.bits, tree.group_size, *(
            _layout(getattr(tree, f)) for f in ("wint", "packed", "scale",
                                                "zero", "dinv", "B", "A")))
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(), tuple(tree.shape), tree.stride(), tree.dtype)
    return tree


def _counters() -> dict:
    """The counts besides ``build.LAUNCHES`` that a graph's capture records
    and each replay adds again: collectives, and the tile of each GEMM
    launch."""
    return {"comm": comm.COUNTS, "tile": build.EXPERTS_TILES,
            "gemm_tile": build.GEMM_TILES}


@contextlib.contextmanager
def _collector_paused():
    """Python's cycle collector off for the block.  A graph capture runs
    under it: the collector may otherwise free cyclic garbage in the middle
    of the capture, such as an engine no longer referenced whose runner
    holds captured graphs, and freeing a graph calls CUDA, which a
    capturing stream forbids ("operation not permitted when stream is
    capturing"), invalidating the capture.  The garbage is collected after
    the capture instead."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: object                     # its outputs, overwritten per replay
    launches: dict                  # kernel launches per replay
    inputs: dict                    # static input buffers (prefill)


class DeviceRunner:
    def __init__(self, cfg, ecfg, kvcfg, *, kncfg=None, device="cuda",
                 generator=None, num_blocks: int = 0, pctx=None):
        self.cfg, self.ecfg, self.kvcfg, self.kncfg = cfg, ecfg, kvcfg, kncfg
        self.pctx = pctx
        self.device = torch.device(device)
        # graphs on the card, unless a gloo group's collectives run in the
        # blocks (they cannot be captured)
        self.graphs = self.device.type == "cuda" and (
            pctx is None or pctx.mesh is None or pctx.mesh.backend == "nccl")
        self.graph_mode = ("graphs" if self.graphs else "eager (gloo "
                           "collectives cannot be captured)"
                           if self.device.type == "cuda" else "eager (cpu)")
        if self.device.type == "cuda" and not self.graphs \
                and pctx.rank == 0:
            print(f"runner: {pctx.mesh.backend} over {pctx.world} ranks on "
                  f"{self.device}: blocks run eagerly, no CUDA graphs")
        self._warm_comm = pctx is not None and self.graphs
        self.generator = generator
        self.paged = kvcfg is not None and kvcfg.paged
        B, ML = ecfg.max_slots, ecfg.max_len
        self.K = max(1, ecfg.decode_chunk)
        self.W = ecfg.speculate_k
        self.state = lm.init_decode_state(cfg, B, ML, kvcfg=kvcfg,
                                          device=self.device,
                                          num_blocks=num_blocks, pctx=pctx)
        dev = self.device
        self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.cur_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.done = torch.ones((B,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((B,), dtype=torch.int32, device=dev)
        # fault isolation: the guarded program and its injection site, a
        # static mask that set_poison writes in place (all False outside
        # fault-injection runs)
        self.detect_faults = bool(ecfg.guards)
        self._poison = (torch.zeros((B,), dtype=torch.bool, device=dev)
                        if self.detect_faults else None)
        self.host_syncs = 0
        self._graphs: dict = {}         # K, layout → decode _Graph (CUDA)
        self._prefills: dict = {}       # shape, layout → prefill _Graph
        self._chunks: dict = {}         # C, start, layout → chunk _Graph
        self._pool = None               # the prefill graphs' memory pool
        self._stream = None             # the side stream of warm + capture
        self.capture_s = 0.0            # wall time of warm blocks + captures
        self.spec_windows = 0           # live speculation windows
        self.spec_drafted = 0           # drafted tokens in them
        self.spec_accepted = 0          # drafted tokens the verifier kept
        self.prefill_capture_s: dict = {}   # (bucket, n, prefix) → seconds

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def place_params(self, params, lowrank=None):
        """This rank's slice of ``params`` (and of the low-rank factors of
        the whole weights, ``rules.shard_lowrank``) under the runner's
        ``pctx``; both unchanged without one."""
        if self.pctx is None:
            return params, lowrank
        return (shard_params(params, self.pctx),
                shard_lowrank(lowrank, self.pctx))

    def set_poison(self, slots):
        """Arm the ``decode.logits`` injection site: the lanes ``slots`` get
        NaN logits at every step of the next block.  Written in place, so a
        replay reads it where its graph captured it.  Needs guards (the
        fault-detecting program)."""
        if self._poison is None:
            raise RuntimeError("fault injection needs EngineConfig.guards")
        mask = np.zeros((self.ecfg.max_slots,), bool)
        mask[list(slots)] = True
        self._poison.copy_(torch.from_numpy(mask))

    def _prefill_inputs(self, group) -> dict:
        """A group's prefill inputs as host arrays: tokens (n, bucket) — the
        prompts past ``prefix_len``, right-padded — the last real row of
        each, the slots; the encoder-decoder family's frames (n, n_frames,
        D) f32, each request's own; paged, each written logical block's
        physical block (pad blocks past the prompt, and logical blocks a
        request does not own, go to the sink), the slots' block-table rows
        and, after a prefix hit, the prefix's blocks."""
        reqs, pfx = group.requests, group.prefix_len
        toks = np.zeros((len(reqs), group.bucket), np.int32)
        for i, r in enumerate(reqs):
            tail = r.prompt[pfx:]
            toks[i, :len(tail)] = tail
        plens = np.asarray([len(r.prompt) for r in reqs], np.int64)
        inp = dict(tokens=toks, last=plens - pfx - 1,
                   slots=np.asarray(group.slots, np.int64))
        if self.cfg.family == "encdec":
            inp["frames"] = np.stack([r.frames for r in reqs])
        if self.paged:
            bs = self.kvcfg.block_size
            nbw, pb0 = -(-group.bucket // bs), pfx // bs
            phys = np.full((len(reqs), nbw), SINK, np.int32)
            rows = np.full((len(reqs), self.ecfg.max_len // bs), SINK,
                           np.int32)
            for i, r in enumerate(reqs):
                rows[i, :len(r.blocks)] = r.blocks
                for j in range(nbw):
                    lb = pb0 + j
                    if lb * bs < len(r.prompt) and lb < len(r.blocks):
                        phys[i, j] = r.blocks[lb]
            inp.update(phys=phys, rows=rows)
            if pfx:
                inp["ptab"] = np.asarray([r.blocks[:pb0] for r in reqs],
                                         np.int32)
        return inp

    def _prefill(self, params, state, inp: dict, pfx: int, generator):
        """An admission group's device work, the body of a prefill graph:
        the stack with the stats tap on (a paged tail over the prefix
        gathered from the pool; the encoder over the frames first), each
        row's last-position logits, the cache writes into ``state`` (the
        slots' slab rows, with the cross k/v and ``enc_out``, or the pool
        blocks and block-table rows) and the first tokens.  ``inp``: the
        tensors of :meth:`_prefill_inputs`.  Returns (first tokens (n,)
        int32, stats)."""
        prefix_kv = None
        if pfx:
            prefix_kv = _gather_prefix(state["stack"], inp["ptab"],
                                       self.kvcfg)
        batch = {k: inp[k] for k in ("tokens", "frames") if k in inp}
        logits, sstate, stats = lm.prefill(
            self.cfg, params, batch, self.ecfg.max_len,
            collect_stats=True, full_logits=True, kvcfg=self.kvcfg,
            prefix_kv=prefix_kv, pos0=pfx, pctx=self.pctx)
        n = inp["tokens"].shape[0]
        last = logits[torch.arange(n, device=logits.device), inp["last"]]
        if self.paged:
            _write_paged(state["stack"], sstate["stack"], inp["phys"],
                         self.kvcfg.block_size)
            state["block_table"][inp["slots"]] = inp["rows"]
        else:
            _write_slots(state, sstate, inp["slots"])
        return sample_logits(last, generator, self.ecfg.temperature), stats

    def admit_group(self, params, group):
        """One bucketed prefill for ``len(group.slots)`` prompts: right-pad to
        ``group.bucket`` (causal masking keeps the real rows clean; decode
        overwrites the pad rows), prefill with the stats tap on, sample each
        row's first token and write each row's cache into its slot.  A paged
        group prefills only the prompt tails past its ``prefix_len``, over
        the prefix gathered from the pool, and scatters the tails' rows into
        each slot's blocks.  On a CUDA device that work is one replay of the
        group shape's prefill graph (captured at its first admission); an
        encoder-decoder group's frames are staged into the graph's input
        buffer, so a replay encodes the admitted requests' own frames.

        Returns (first tokens (n,), finished (n,)) as host arrays — one sync
        for the group — and the group's statistics (a graph's outputs: the
        next admission overwrites them)."""
        reqs, pfx = group.requests, group.prefix_len
        host = self._prefill_inputs(group)
        if self.graphs:
            first, stats = self._prefill_graph(params, host, group)
        else:
            inp = {k: self._tensor(v) for k, v in host.items()}
            first, stats = self._prefill(params, self.state, inp, pfx,
                                         self.generator)
        plens_h = host["last"] + pfx + 1
        idx = torch.as_tensor(group.slots, dtype=torch.long, device=self.device)
        ecfg = self.ecfg
        budget_h = np.asarray([r.remaining for r in reqs], np.int32) - 1
        self.pos[idx] = self._tensor(plens_h.astype(np.int32))
        self.cur_tok[idx] = first[:, None]
        self.remaining[idx] = self._tensor(budget_h)
        first_h = first.cpu().numpy()          # the one sync of the group
        self.host_syncs += 1
        fin_h = ((plens_h >= ecfg.max_len) | (budget_h <= 0)
                 | (first_h == ecfg.eos_token))
        self.done[idx] = self._tensor(fin_h)
        return first_h, fin_h, stats

    def _prefill_graph(self, params, host: dict, group):
        """The prefill graph of this group's key (see :meth:`_pooled`)."""
        pfx = group.prefix_len
        shape = (group.bucket, len(group.requests), pfx)
        out, dt = self._pooled(
            self._prefills, (shape, _layout(params)), host,
            lambda inp: self._prefill(params, self.state, inp, pfx,
                                      self.generator))
        if dt:
            self.prefill_capture_s[shape] = \
                self.prefill_capture_s.get(shape, 0.0) + dt
        return out

    def _pooled(self, graphs: dict, key, host: dict, body):
        """Replay ``graphs[key]`` (a graph of the prefill memory pool) after
        writing ``host``'s arrays into its input buffers; capture it first
        if there is none, from ``body(inputs)``, and return the warm run's
        results.  Returns (outputs, capture seconds or 0)."""
        g = graphs.get(key)
        if g is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            inputs = {k: self._tensor(v) for k, v in host.items()}
            return self._capture(lambda: body(inputs), graphs, key,
                                 pool=self._pool, inputs=inputs)
        for k, buf in g.inputs.items():
            buf.copy_(torch.from_numpy(host[k]))
        return self._replay(g), 0.0

    # -------------------------------------------------------- chunked prefill

    def _chunk_inputs(self, plan) -> dict:
        """A chunk's inputs as host arrays: tokens (1, C), the last real
        row, the slot; paged, the physical block of each of the chunk's C/bs
        logical blocks (the sink past the prompt) and, past the first chunk,
        the blocks of the rows already written."""
        req, C, start, n = plan.req, self.ecfg.prefill_chunk, plan.start, \
            plan.length
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = req.prompt[start:start + n]
        inp = dict(tokens=toks, last=np.asarray([n - 1], np.int64),
                   slot=np.asarray([plan.slot], np.int64))
        if self.paged:
            bs = self.kvcfg.block_size
            pb0, end = start // bs, start + n
            phys = np.full((1, C // bs), SINK, np.int32)
            for j in range(C // bs):
                lb = pb0 + j
                if lb * bs < end and lb < len(req.blocks):
                    phys[0, j] = req.blocks[lb]
            inp["phys"] = phys
            if start:
                inp["ptab"] = np.asarray([req.blocks[:pb0]], np.int32)
        return inp

    def _chunk(self, params, state, inp: dict, start: int):
        """A chunk's device work, the body of a chunk graph: the stack with
        the stats tap on over the resident rows' context, the cache writes
        into ``state``, and the last real row's logits (1, V)."""
        prefix_kv = None
        if start:
            prefix_kv = (_gather_prefix(state["stack"], inp["ptab"],
                                        self.kvcfg) if self.paged else
                         _gather_dense_prefix(state["stack"], inp["slot"],
                                              start, self.kvcfg))
        logits, sstate, stats = lm.prefill(
            self.cfg, params, {"tokens": inp["tokens"]}, self.ecfg.max_len,
            collect_stats=True, full_logits=True, kvcfg=self.kvcfg,
            prefix_kv=prefix_kv, pos0=start, compact_state=True,
            pctx=self.pctx)
        if self.paged:
            _write_paged(state["stack"], sstate["stack"], inp["phys"],
                         self.kvcfg.block_size)
        else:
            _write_rows(state["stack"], sstate["stack"], inp["slot"], start,
                        self.ecfg.max_len)
        return logits[0, inp["last"]], stats

    def prefill_chunk(self, params, plan):
        """One chunked-prefill step: prompt rows [start, start + length) of
        one request into its parked slot (padded to ``prefill_chunk``;
        causal masking keeps the pad columns out of the real rows, and they
        land past the prompt, in sink blocks or slab rows decode overwrites
        before reading).  On the card a replay of the chunk graph of
        (C, start, tree layout), captured at its first use.

        A non-final chunk returns (None, None, stats) and the lane stays
        parked.  The final one samples the first token from the last real
        row's logits, installs the slot's block-table row (paged), arms the
        lane and returns (first (1,), finished (1,)) host arrays, one sync,
        and the stats (a graph's outputs: the next replay overwrites them)."""
        host = self._chunk_inputs(plan)
        if self.graphs:
            last, stats = self._chunk_graph(params, host, plan.start)
        else:
            inp = {k: self._tensor(v) for k, v in host.items()}
            last, stats = self._chunk(params, self.state, inp, plan.start)
        if not plan.final:
            return None, None, stats
        ecfg, req, slot = self.ecfg, plan.req, plan.slot
        first = sample_logits(last, self.generator, ecfg.temperature)
        if self.paged:
            rows = np.full((1, ecfg.max_len // self.kvcfg.block_size), SINK,
                           np.int32)
            rows[0, :len(req.blocks)] = req.blocks
            self.state["block_table"][slot] = self._tensor(rows[0])
        plen, budget = len(req.prompt), req.remaining - 1
        self.pos[slot] = plen
        self.cur_tok[slot] = first
        self.remaining[slot] = budget
        first_h = first.cpu().numpy()           # the one sync of the prompt
        self.host_syncs += 1
        fin_h = np.asarray([plen >= ecfg.max_len or budget <= 0
                            or int(first_h[0]) == ecfg.eos_token])
        self.done[slot] = bool(fin_h[0])
        return first_h, fin_h, stats

    def _chunk_graph(self, params, host: dict, start: int):
        """The chunk graph of (C, start, tree layout) (see
        :meth:`_pooled`)."""
        out, dt = self._pooled(
            self._chunks, (self.ecfg.prefill_chunk, start, _layout(params)),
            host, lambda inp: self._chunk(params, self.state, inp, start))
        self.capture_s += dt
        return out

    def release_slots(self, slots):
        """Deactivate freed slots (finished, preempted, cancelled): done
        lane on, budget zeroed, pos pushed to max_len so the lane's held
        writes land in its last row, which the next admission overwrites
        with the whole slab — or, paged, the slot's block-table row pointed
        at the sink, so those writes never reach blocks the allocator has
        handed to someone else.  Also parks a lane whose prompt is being
        chunk-ingested: its held writes go to row max_len - 1, which no
        chunk's context gather reads (a chunk reads rows before its own).
        In place: a decode graph reads these tensors where it captured
        them."""
        mask_h = np.zeros((self.ecfg.max_slots,), bool)
        mask_h[list(slots)] = True
        mask = torch.from_numpy(mask_h).to(self.device)
        self.done |= mask
        self.remaining.masked_fill_(mask, 0)
        self.pos.masked_fill_(mask, self.ecfg.max_len)
        if self.paged:
            self.state["block_table"].masked_fill_(mask[:, None], SINK)

    @property
    def compiled_programs(self) -> int:
        """Graphs held, the reference's count of its decode and prefill jit
        caches: decode graphs (one per K and layout of the tree(s) a block
        reads: the full-precision tree before the first requant, then each
        quantized tree; a speculative block's pair of trees; the K = 1
        graph of the degradation ladder), prefill graphs (one per admission
        key) and chunk graphs (one per chunk key); 0 on the CPU."""
        return len(self._graphs) + len(self._prefills) + len(self._chunks)

    def _eager_block(self, params, draft=None, K=None) -> torch.Tensor:
        """One block from the runner's state: K (default ``decode_chunk``)
        steps of ``lm.decode_many``, or with ``draft`` K windows of
        ``lm.speculate_many``; the carry is copied back into the same
        tensors.  Returns (B, 2C+1) int32, C columns: tokens, valid flags,
        done flags; with guards (B, 2C+2), the last column the fault
        flags."""
        ecfg = self.ecfg
        kw = dict(K=K or self.K, max_len=ecfg.max_len,
                  eos_token=ecfg.eos_token, kvcfg=self.kvcfg, kcfg=self.kncfg,
                  detect_faults=self.detect_faults, pctx=self.pctx)
        if draft is None:
            ys, (_, tok, pos, done, rem, _) = lm.decode_many(
                self.cfg, params, self.state, self.cur_tok, self.pos,
                self.done, self.remaining, self.generator, self._poison,
                temperature=ecfg.temperature, **kw)
        else:
            ys, (_, tok, pos, done, rem, _) = lm.speculate_many(
                self.cfg, draft, params, self.state, self.cur_tok, self.pos,
                self.done, self.remaining, self.generator, self._poison,
                W=self.W, **kw)
        for dst, src in ((self.cur_tok, tok), (self.pos, pos),
                         (self.done, done), (self.remaining, rem)):
            dst.copy_(src)
        cols = [ys[0], ys[1].to(torch.int32),
                self.done.to(torch.int32)[:, None]]
        if self.detect_faults:
            cols.append(ys[2].to(torch.int32)[:, None])
        return torch.cat(cols, dim=1)

    def _capture(self, fn, graphs: dict, key, pool=None, inputs=None):
        """Run ``fn`` once eagerly on the side stream (the warm-up: cuBLAS
        handles and workspaces, the kernel library and the split rules'
        caches are set up outside the capture), then capture its work as a
        graph without running it, stored in ``graphs[key]``, with the cycle
        collector paused (:func:`_collector_paused`).  Returns the
        warm run's result and the seconds both took."""
        t0 = time.perf_counter()
        if self._warm_comm:             # NCCL's communicator, before any
            comm.warm(self.pctx)        # capture
            self._warm_comm = False
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            warm = fn()
        cur.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None and self.ecfg.temperature > 0:
            graph.register_generator_state(self.generator)
        before = dict(build.LAUNCHES)
        before_t = {kind: dict(c) for kind, c in _counters().items()}
        with _collector_paused(), torch.cuda.graph(graph, pool=pool,
                                                   stream=self._stream):
            out = fn()
        launches = {k: build.LAUNCHES[k] - n for k, n in before.items()}
        for kind, c in _counters().items():
            launches.update({(kind, k): c[k] - n
                             for k, n in before_t[kind].items()})
            c.update(before_t[kind])    # captured, not launched
        build.LAUNCHES.update(before)
        graphs[key] = _Graph(graph, out, launches, inputs or {})
        return warm, time.perf_counter() - t0

    @staticmethod
    def _replay(g: _Graph):
        g.graph.replay()
        counters = _counters()
        for k, n in g.launches.items():
            if isinstance(k, tuple):    # a collective, or a GEMM's tile
                counters[k[0]][k[1]] += n
            else:
                build.LAUNCHES[k] += n
        return g.out

    def _key(self, params, draft=None, K=None):
        return (K or self.K, _layout((params, draft, self.state, self.cur_tok,
                                      self.pos, self.done, self.remaining,
                                      self._poison)))

    def block(self, params, draft=None, K=None) -> torch.Tensor:
        """Enqueue one fused block of K (default ``decode_chunk``) steps
        over every slot (speculative with ``draft``) and return its result
        on the device (see :meth:`_eager_block`); reads nothing back.  CUDA:
        a replay of the graph captured at this K and layout (captured first
        if there is none); CPU, or a gloo group: the eager loop."""
        if not self.graphs:
            return self._eager_block(params, draft, K)
        key = self._key(params, draft, K)
        g = self._graphs.get(key)
        if g is None:
            warm, dt = self._capture(
                lambda: self._eager_block(params, draft, K), self._graphs,
                key)
            self.capture_s += dt
            return warm
        return self._replay(g)

    def decode_block(self, params, draft=None, small_chunk=False):
        """One fused block over every slot; with ``draft`` (and
        ``speculate_k`` > 0) the speculative block; with ``small_chunk``
        (ladder rung 2, which comes after speculation is off) one step.
        Returns host copies (tokens (B,C), valid (B,C), done (B,), fault
        (B,) or None without guards), C = K or K·(W+1): one transfer."""
        spec = draft is not None and self.W > 0 and not small_chunk
        out = self.block(params, draft if spec else None,
                         1 if small_chunk else None).cpu().numpy()
        self.host_syncs += 1                    # the ONE sync per block
        f = int(self.detect_faults)
        C = (out.shape[1] - 1 - f) // 2
        toks, valid, done = (out[:, :C], out[:, C:2 * C].astype(bool),
                             out[:, 2 * C].astype(bool))
        fault = out[:, 2 * C + 1].astype(bool) if f else None
        if spec:
            v = valid.reshape(valid.shape[0], -1, self.W + 1)
            live = int(v[:, :, 0].sum())        # a live window emits
            self.spec_windows += live
            self.spec_drafted += live * self.W
            self.spec_accepted += int(np.maximum(v.sum(axis=2) - 1, 0).sum())
        return toks, valid, done, fault
