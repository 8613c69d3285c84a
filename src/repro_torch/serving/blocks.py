"""Block allocator + prefix trie for the paged KV cache (host bookkeeping).

The device side is a per-layer (num_blocks, Hkv, block_size, ·) pool read
through per-slot block tables; this module owns which physical block holds
what:

* **free list**: physical blocks 1..NB-1 (block 0 is the reserved sink for
  done-lane and padding writes; it is never allocated and never read by a
  live slot's masked attention);
* **prefix trie**: full prompt-prefix blocks keyed by a rolling hash chain
  ``h_i = hash(h_{i-1}, tokens[i·bs:(i+1)·bs])``, so a lookup walks the
  longest shared prefix block by block.  Hits share the physical block
  (ref-counted); blocks whose refcount drops to zero stay *cached* (LRU)
  and are reclaimed only under pressure, so prefix reuse outlives the first
  request;
* **accounting**: prefix hit/miss counts, peak utilization, and the leak
  check.

Allocation is **upfront**: a request reserves every block its prompt plus
generation budget can touch (``ceil(min(plen + max_new, max_len) / bs)``),
so decode never allocates and the block table is read-only on the device
between admissions.  When free + cached blocks cannot cover an admission
the scheduler preempts a running slot (frees its blocks, requeues the
request) rather than stalling.

Sharing is safe by construction: only *full* blocks strictly before the
prompt's last token enter the trie, decode writes start at ``pos = plen``,
and the block holding ``plen`` is always privately allocated, so a shared
block is never written after registration (copy-on-write reduces to "the
first divergent block is a fresh allocation").
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

SINK = 0            # physical block 0: write sink, never allocated


def chain_hashes(tokens, block_size: int, n_blocks: int) -> List[int]:
    """Rolling hash chain over the first ``n_blocks`` full blocks."""
    out, h = [], 0
    for i in range(n_blocks):
        blk = tuple(tokens[i * block_size:(i + 1) * block_size])
        h = hash((h, blk))
        out.append(h)
    return out


class BlockAllocator:
    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the sink)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self.free: List[int] = list(range(num_blocks - 1, SINK, -1))  # pop() ↑
        self.ref: Dict[int, int] = {}                # block -> refcount (>0)
        self.trie: Dict[int, int] = {}               # chain hash -> block
        self.block_hash: Dict[int, int] = {}         # block -> its chain hash
        self.cached: "OrderedDict[int, None]" = OrderedDict()  # ref==0, LRU
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.peak_in_use = 0

    # ------------------------------------------------------------- capacity

    @property
    def capacity(self) -> int:
        """Allocatable blocks (sink excluded)."""
        return self.num_blocks - 1

    @property
    def in_use(self) -> int:
        return len(self.ref)

    def available(self) -> int:
        """Blocks obtainable right now: free + reclaimable cached."""
        return len(self.free) + len(self.cached)

    # ------------------------------------------------------------ low level

    def _take(self) -> int:
        if self.free:
            blk = self.free.pop()
        elif self.cached:
            blk, _ = self.cached.popitem(last=False)     # LRU cached block
            h = self.block_hash.pop(blk)
            del self.trie[h]
        else:
            raise MemoryError("KV pool exhausted")
        self.ref[blk] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return blk

    def _retain(self, blk: int):
        if blk in self.cached:                            # revive cached
            del self.cached[blk]
            self.ref[blk] = 1
        else:
            self.ref[blk] += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)

    def _release(self, blk: int):
        self.ref[blk] -= 1
        if self.ref[blk] > 0:
            return
        del self.ref[blk]
        if self.prefix_cache and blk in self.block_hash:
            self.cached[blk] = None                       # keep for reuse
        else:
            self.free.append(blk)

    # ------------------------------------------------------------ admission

    def match_prefix(self, prompt) -> Tuple[List[int], List[int]]:
        """Longest cached prefix of ``prompt``: (physical blocks, hashes).

        Walks full blocks strictly before the last prompt token (the block
        holding position ``plen`` must stay private: decode writes there).
        A pure lookup: hits and misses are counted by a successful
        :meth:`allocate` only, so a preemption retry does not count twice."""
        n = self._shareable_blocks(len(prompt))
        hashes = chain_hashes(prompt, self.block_size, n)
        if not self.prefix_cache:
            return [], hashes
        blocks: List[int] = []
        for h in hashes:
            blk = self.trie.get(h)
            if blk is None:
                break
            blocks.append(blk)
        return blocks, hashes

    def _shareable_blocks(self, plen: int) -> int:
        """Full blocks strictly before the prompt's last token."""
        return max(plen - 1, 0) // self.block_size

    def blocks_needed(self, plen: int, max_new: int, max_len: int) -> int:
        span = min(plen + max_new, max_len)
        return -(-span // self.block_size)

    def allocate(self, prompt, max_new: int,
                 max_len: int) -> Tuple[List[int], int]:
        """Reserve the request's blocks.  Returns (physical blocks in logical
        order, prefix_len in tokens).  Shared prefix blocks are retained,
        the rest freshly taken, and the fresh shareable blocks registered in
        the trie.  Raises MemoryError, leaving
        nothing reserved, when the pool cannot cover the request (the caller
        preempts and retries)."""
        shared, hashes = self.match_prefix(prompt)
        need = self.blocks_needed(len(prompt), max_new, max_len)
        # exact capacity check: reviving a shared block that sits in the
        # cached pool consumes one unit of "available" too
        shared_cached = sum(1 for b in shared if b in self.cached)
        if need - len(shared) > self.available() - shared_cached:
            raise MemoryError("KV pool exhausted")
        self.prefix_hits += len(shared)
        self.prefix_misses += len(hashes) - len(shared)
        blocks = []
        try:
            for blk in shared:
                self._retain(blk)
                blocks.append(blk)
            for i in range(len(shared), need):
                blk = self._take()
                if self.prefix_cache and i < len(hashes):
                    self._hook(hashes[i], blk)
                blocks.append(blk)
        except MemoryError:
            self.free_request(blocks)      # atomic: no partial reservations
            self.prefix_hits -= len(shared)
            self.prefix_misses -= len(hashes) - len(shared)
            raise
        return blocks, len(shared) * self.block_size

    def _hook(self, h: int, blk: int):
        """Enter ``blk`` into the trie under chain hash ``h``.

        An older block may still map to ``h`` although the trie walk broke
        earlier in the chain (its predecessor was evicted): unhook it, or
        its later reclaim would delete THIS block's live trie entry."""
        old = self.trie.get(h)
        if old is not None and old != blk:
            del self.block_hash[old]
            if old in self.cached:                         # demote to free
                del self.cached[old]
                self.free.append(old)
        self.trie[h] = blk
        self.block_hash[blk] = h

    def free_request(self, blocks: List[int]):
        """Release a finished, preempted or cancelled request's blocks."""
        for blk in blocks:
            self._release(blk)

    # ------------------------------------------------------------- metrics

    def prefix_hit_rate(self) -> float:
        tot = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / tot if tot else 0.0

    def assert_quiescent(self):
        """Leak check: with no requests in flight every block is free or
        cached, and refcounts are empty."""
        assert not self.ref, f"leaked blocks with refs: {sorted(self.ref)}"
        assert len(self.free) + len(self.cached) == self.capacity, (
            f"block leak: {len(self.free)} free + {len(self.cached)} cached "
            f"!= {self.capacity}")
