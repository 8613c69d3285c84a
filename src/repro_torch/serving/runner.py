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

``host_syncs`` counts blocking device→host transfers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kvquant import dequantize_kv
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
        handed to someone else."""
        mask_h = np.zeros((self.ecfg.max_slots,), bool)
        mask_h[list(slots)] = True
        mask = torch.from_numpy(mask_h).to(self.device)
        self.done |= mask
        self.remaining = torch.where(mask, torch.zeros_like(self.remaining),
                                     self.remaining)
        self.pos = torch.where(mask, torch.full_like(self.pos,
                                                     self.ecfg.max_len),
                               self.pos)
        if self.paged:
            self.state["block_table"].masked_fill_(mask[:, None], SINK)

    def decode_block(self, params):
        """One fused block of ``decode_chunk`` steps over every slot.
        Returns host copies (tokens (B,K), valid (B,K), done (B,))."""
        ecfg = self.ecfg
        (toks, valid), carry = lm.decode_many(
            self.cfg, params, self.state, self.cur_tok, self.pos, self.done,
            self.remaining, self.generator, K=self.K, max_len=ecfg.max_len,
            temperature=ecfg.temperature, eos_token=ecfg.eos_token,
            kvcfg=self.kvcfg, kcfg=self.kncfg)
        (self.state, self.cur_tok, self.pos, self.done, self.remaining,
         self.generator) = carry
        packed = torch.cat([toks, valid.to(torch.int32),
                            self.done.to(torch.int32)[:, None]], dim=1)
        out = packed.cpu().numpy()             # the ONE sync per block
        self.host_syncs += 1
        K = self.K
        return out[:, :K], out[:, K:2 * K].astype(bool), out[:, 2 * K].astype(bool)
