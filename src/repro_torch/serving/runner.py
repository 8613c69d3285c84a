"""DeviceRunner — the device half of the engine (dense KV slab).

Owns the batched decode state (per-layer slot caches, positions, per-slot
done flags and budgets) and runs:

* a bucketed batched prefill per admission group, stats tap on;
* ``lm.decode_many`` — ``decode_chunk`` fused decode steps with sampling,
  EOS, budget and capacity masking on the device, so the host sees ONE
  transfer per block (tokens, valid flags and done flags in one tensor).

``host_syncs`` counts blocking device→host transfers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.common import sample_logits


def _write_slots(batched, src, idx: torch.Tensor):
    """Write the rows of a batch-``n`` prefill state into slots ``idx`` of
    the batched decode state, in place (stack leaves are (L, B, ...))."""
    for run_b, run_s in zip(batched["stack"], src["stack"]):
        for u in run_b:
            for k, leaf in run_b[u].items():
                leaf[:, idx] = run_s[u][k].to(leaf.dtype)


class DeviceRunner:
    def __init__(self, cfg, ecfg, kvcfg, *, kncfg=None, device="cuda",
                 generator=None):
        self.cfg, self.ecfg, self.kvcfg, self.kncfg = cfg, ecfg, kvcfg, kncfg
        self.device = torch.device(device)
        self.generator = generator
        B, ML = ecfg.max_slots, ecfg.max_len
        self.K = max(1, ecfg.decode_chunk)
        self.state = lm.init_decode_state(cfg, B, ML, kvcfg=kvcfg,
                                          device=self.device)
        dev = self.device
        self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.cur_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.done = torch.ones((B,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.host_syncs = 0

    def admit_group(self, params, group):
        """One bucketed prefill for ``len(group.slots)`` prompts: right-pad to
        ``group.bucket`` (causal masking keeps the real rows clean; decode
        overwrites the pad rows), prefill with the stats tap on, sample each
        row's first token and write each row's cache into its slot.

        Returns (first tokens (n,), finished (n,)) as host arrays — one sync
        for the group — and the group's statistics."""
        reqs = group.requests
        toks_h = np.zeros((len(reqs), group.bucket), np.int32)
        for i, r in enumerate(reqs):
            toks_h[i, :len(r.prompt)] = r.prompt
        batch = {"tokens": torch.from_numpy(toks_h).to(self.device)}
        logits, sstate, stats = lm.prefill(
            self.cfg, params, batch, self.ecfg.max_len, collect_stats=True,
            full_logits=True, kvcfg=self.kvcfg)
        plens_h = np.asarray([len(r.prompt) for r in reqs], np.int64)
        last = logits[torch.arange(len(reqs), device=self.device),
                      torch.from_numpy(plens_h - 1).to(self.device)]
        idx = torch.as_tensor(group.slots, dtype=torch.long, device=self.device)
        _write_slots(self.state, sstate, idx)
        ecfg = self.ecfg
        first = sample_logits(last, self.generator, ecfg.temperature)
        budget_h = np.asarray([r.remaining for r in reqs], np.int32) - 1
        self.pos[idx] = torch.from_numpy(plens_h.astype(np.int32)).to(self.device)
        self.cur_tok[idx] = first[:, None]
        self.remaining[idx] = torch.from_numpy(budget_h).to(self.device)
        first_h = first.cpu().numpy()          # the one sync of the group
        self.host_syncs += 1
        fin_h = ((plens_h >= ecfg.max_len) | (budget_h <= 0)
                 | (first_h == ecfg.eos_token))
        self.done[idx] = torch.from_numpy(fin_h).to(self.device)
        return first_h, fin_h, stats

    def release_slots(self, slots):
        """Deactivate finished slots: done lane on, budget zeroed, pos pushed
        to max_len so the lane's held writes land in its last row, which the
        next admission overwrites with the whole slab."""
        mask_h = np.zeros((self.ecfg.max_slots,), bool)
        mask_h[list(slots)] = True
        mask = torch.from_numpy(mask_h).to(self.device)
        self.done |= mask
        self.remaining = torch.where(mask, torch.zeros_like(self.remaining),
                                     self.remaining)
        self.pos = torch.where(mask, torch.full_like(self.pos,
                                                     self.ecfg.max_len),
                               self.pos)

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
