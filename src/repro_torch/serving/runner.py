"""DeviceRunner — the device half of the engine.

Owns the batched decode state (per-layer slot caches, positions, per-slot
done flags and budgets) and runs:

* a bucketed batched prefill per admission group, stats tap on;
* ``lm.decode_many`` — ``decode_chunk`` fused decode steps with sampling,
  EOS, budget and capacity masking on the device, so the host sees ONE
  transfer per block (tokens, valid flags and done flags in one tensor).

With a paged ``KVCacheConfig`` the slot caches are per-layer block pools
plus a per-slot ``block_table``: admission scatters the prefill's rows
into the slots' physical blocks (a prefix-cache hit prefills only the
prompt's tail, gathering the cached prefix from the pool), and
``release_slots`` points freed slots at the sink block 0, so their
done-lane writes never reach blocks handed to someone else.

On a CUDA device a decode block is a CUDA graph, the port's counterpart of
the reference's ``jax.jit(lm.decode_many)``: the first block at a new
layout (see :func:`_layout`) runs eagerly on a side stream (it warms
cuBLAS and the kernel library), then ``decode_many``'s K steps are
captured; every later block replays the graph, one launch.  A graph reads
the addresses it captured, so everything a block reads keeps its storage:
the decode state, ``cur_tok``/``pos``/``done``/``remaining`` (written in
place; the block ends by copying its carry into them) and the parameter
tree (a requant lands in place, ``quant/api.py:FusedRequantPlan.run``).
A tree at new storage has a new layout and gets its own graph, so a
replay never reads a stale tree.  On the CPU the block is the eager loop,
the plain version.  There is no switch between the two and no fallback: a
capture or replay that fails raises.

``host_syncs`` counts blocking device→host transfers.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.kvquant import dequantize_kv
from repro_torch.core.ttq import QuantizedTensor
from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_paged_kv
from repro_torch.models import lm
from repro_torch.models.common import sample_logits

from .blocks import SINK


def _write_slots(batched, src, idx: torch.Tensor):
    """Write the rows of a batch-``n`` prefill state into slots ``idx`` of
    the batched decode state, in place (stack leaves are (L, B, ...))."""
    for run_b, run_s in zip(batched["stack"], src["stack"]):
        for u in run_b:
            for k, leaf in run_b[u].items():
                leaf[:, idx] = run_s[u][k].to(leaf.dtype)


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


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor               # the packed block result, overwritten
    launches: dict                  # kernel launches per replay


class DeviceRunner:
    def __init__(self, cfg, ecfg, kvcfg, *, kncfg=None, device="cuda",
                 generator=None, num_blocks: int = 0):
        self.cfg, self.ecfg, self.kvcfg, self.kncfg = cfg, ecfg, kvcfg, kncfg
        self.device = torch.device(device)
        self.generator = generator
        self.paged = kvcfg is not None and kvcfg.paged
        B, ML = ecfg.max_slots, ecfg.max_len
        self.K = max(1, ecfg.decode_chunk)
        self.state = lm.init_decode_state(cfg, B, ML, kvcfg=kvcfg,
                                          device=self.device,
                                          num_blocks=num_blocks)
        dev = self.device
        self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.cur_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.done = torch.ones((B,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.host_syncs = 0
        self._graphs: dict = {}         # layout → _Graph (CUDA only)
        self._stream = None             # the side stream of warm + capture
        self.capture_s = 0.0            # wall time of warm blocks + captures

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def admit_group(self, params, group):
        """One bucketed prefill for ``len(group.slots)`` prompts: right-pad to
        ``group.bucket`` (causal masking keeps the real rows clean; decode
        overwrites the pad rows), prefill with the stats tap on, sample each
        row's first token and write each row's cache into its slot.  A paged
        group prefills only the prompt tails past its ``prefix_len``, over
        the prefix gathered from the pool, and scatters the tails' rows into
        each slot's blocks.

        Returns (first tokens (n,), finished (n,)) as host arrays — one sync
        for the group — and the group's statistics."""
        reqs, pfx = group.requests, group.prefix_len
        toks_h = np.zeros((len(reqs), group.bucket), np.int32)
        for i, r in enumerate(reqs):
            tail = r.prompt[pfx:]
            toks_h[i, :len(tail)] = tail
        prefix_kv = None
        if pfx:
            bs = self.kvcfg.block_size
            ptab = self._tensor(np.asarray([r.blocks[:pfx // bs]
                                            for r in reqs], np.int32))
            prefix_kv = _gather_prefix(self.state["stack"], ptab, self.kvcfg)
        logits, sstate, stats = lm.prefill(
            self.cfg, params, {"tokens": self._tensor(toks_h)},
            self.ecfg.max_len, collect_stats=True, full_logits=True,
            kvcfg=self.kvcfg, prefix_kv=prefix_kv, pos0=pfx)
        plens_h = np.asarray([len(r.prompt) for r in reqs], np.int64)
        last = logits[torch.arange(len(reqs), device=self.device),
                      self._tensor(plens_h - pfx - 1)]
        idx = torch.as_tensor(group.slots, dtype=torch.long, device=self.device)
        if self.paged:
            self._write_group_paged(group, sstate)
        else:
            _write_slots(self.state, sstate, idx)
        ecfg = self.ecfg
        first = sample_logits(last, self.generator, ecfg.temperature)
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

    def _write_group_paged(self, group, sstate):
        """Scatter a paged group's tail rows into each slot's blocks (pad
        blocks past the prompt, and logical blocks a request does not own,
        go to the sink) and set the slots' block-table rows."""
        bs, reqs, pfx = self.kvcfg.block_size, group.requests, group.prefix_len
        nbw, pb0 = -(-group.bucket // bs), pfx // bs
        phys = np.full((len(reqs), nbw), SINK, np.int32)
        for i, r in enumerate(reqs):
            for j in range(nbw):
                lb = pb0 + j
                if lb * bs < len(r.prompt) and lb < len(r.blocks):
                    phys[i, j] = r.blocks[lb]
        _write_paged(self.state["stack"], sstate["stack"], self._tensor(phys),
                     bs)
        rows = np.full((len(reqs), self.ecfg.max_len // bs), SINK, np.int32)
        for i, r in enumerate(reqs):
            rows[i, :len(r.blocks)] = r.blocks
        idx = torch.as_tensor(group.slots, dtype=torch.long, device=self.device)
        self.state["block_table"][idx] = self._tensor(rows)

    def release_slots(self, slots):
        """Deactivate freed slots (finished, preempted, cancelled): done
        lane on, budget zeroed, pos pushed to max_len so the lane's held
        writes land in its last row, which the next admission overwrites
        with the whole slab — or, paged, the slot's block-table row pointed
        at the sink, so those writes never reach blocks the allocator has
        handed to someone else.  In place: a decode graph reads these
        tensors where it captured them."""
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
        """Decode graphs held (one per parameter-tree layout: the
        full-precision tree before the first requant, then the quantized
        one); 0 on the CPU.  Prefill runs eagerly and holds none."""
        return len(self._graphs)

    def _eager_block(self, params) -> torch.Tensor:
        """``decode_chunk`` steps of ``lm.decode_many`` from the runner's
        state; the carry is copied back into the same tensors.  Returns
        (B, 2K+1) int32: tokens, valid flags, done flags."""
        ecfg = self.ecfg
        (toks, valid), (_, tok, pos, done, rem, _) = lm.decode_many(
            self.cfg, params, self.state, self.cur_tok, self.pos, self.done,
            self.remaining, self.generator, K=self.K, max_len=ecfg.max_len,
            temperature=ecfg.temperature, eos_token=ecfg.eos_token,
            kvcfg=self.kvcfg, kcfg=self.kncfg)
        for dst, src in ((self.cur_tok, tok), (self.pos, pos),
                         (self.done, done), (self.remaining, rem)):
            dst.copy_(src)
        return torch.cat([toks, valid.to(torch.int32),
                          self.done.to(torch.int32)[:, None]], dim=1)

    def _capture(self, params, key) -> torch.Tensor:
        """Run one block eagerly on the side stream (the warm block: cuBLAS
        handles and workspaces, the kernel library and the split rules'
        caches are set up outside the capture), then capture the next
        block's work as a graph without running it.  Returns the warm
        block's result."""
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            warm = self._eager_block(params)
        cur.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None and self.ecfg.temperature > 0:
            graph.register_generator_state(self.generator)
        before = dict(build.LAUNCHES)
        with torch.cuda.graph(graph, stream=self._stream):
            out = self._eager_block(params)
        launches = {k: build.LAUNCHES[k] - n for k, n in before.items()}
        build.LAUNCHES.update(before)   # captured, not launched
        self._graphs[key] = _Graph(graph, out, launches)
        self.capture_s += time.perf_counter() - t0
        return warm

    def _key(self, params):
        return _layout((params, self.state, self.cur_tok, self.pos,
                        self.done, self.remaining))

    def block(self, params) -> torch.Tensor:
        """Enqueue one fused block of ``decode_chunk`` steps over every slot
        and return its (B, 2K+1) int32 result on the device (tokens, valid
        flags, done flags); reads nothing back.  CUDA: a replay of the
        graph captured at this layout (captured first if there is none);
        CPU: the eager loop."""
        if self.device.type != "cuda":
            return self._eager_block(params)
        key = self._key(params)
        g = self._graphs.get(key)
        if g is None:
            return self._capture(params, key)
        g.graph.replay()
        for k, n in g.launches.items():
            build.LAUNCHES[k] += n
        return g.out

    def decode_block(self, params):
        """One fused block over every slot.  Returns host copies (tokens
        (B,K), valid (B,K), done (B,))."""
        out = self.block(params).cpu().numpy()  # the ONE sync per block
        self.host_syncs += 1
        K = self.K
        return out[:, :K], out[:, K:2 * K].astype(bool), out[:, 2 * K].astype(bool)
