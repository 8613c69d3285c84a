"""Deterministic synthetic multi-domain token pipeline (``repro.data``).

Each domain is a random-parameter Markov chain over the vocabulary with a
sparse transition graph (``branch`` successors per token) and a skewed
start distribution: different domains give different activation
statistics, the domain shift that AWQ's calibration suffers from and TTQ's
does not.  :func:`make_domain` is the reference's numpy code, so a
domain's ``succ``, ``probs`` and ``start`` are bit for bit the reference's.

The tokens are drawn with a ``torch.Generator`` on the host, seeded from
(seed, step, domain_id): deterministic, restart-safe (a checkpoint needs
only the step counter) and host-shardable (host h of H takes batch rows
[h·B/H, (h+1)·B/H)).  The draws cannot equal ``jax.random``'s bits, so the
port's token stream is not the reference's; it has the same law.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 256
    seq_len: int = 128
    batch: int = 8
    branch: int = 8          # out-degree of the transition graph
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """Per-domain transition structure, O(vocab·branch), on the host."""
    succ: torch.Tensor       # (V, branch) int32 allowed successors
    probs: torch.Tensor      # (V, branch) f32 transition probabilities
    start: torch.Tensor      # (V,) f32 start distribution


def make_domain(cfg: DataConfig, domain_id: int) -> DomainSpec:
    rng = np.random.default_rng(cfg.seed * 1000 + domain_id)
    V, B = cfg.vocab, cfg.branch
    succ = rng.integers(0, V, size=(V, B)).astype(np.int32)
    raw = rng.gamma(0.5, size=(V, B)).astype(np.float32) + 1e-3
    probs = raw / raw.sum(1, keepdims=True)
    start = rng.gamma(0.3, size=(V,)).astype(np.float32) + 1e-3
    start = start / start.sum()
    return DomainSpec(torch.from_numpy(succ), torch.from_numpy(probs),
                      torch.from_numpy(start))


def batch_generator(seed: int, step: int, domain_id: int) -> torch.Generator:
    """The host generator of one batch: seeded from (seed, step,
    domain_id) through numpy's SeedSequence, so no two triples share a
    stream."""
    s = np.random.SeedSequence([seed, step, domain_id]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s) & ((1 << 63) - 1))


def sample_batch(spec: DomainSpec, generator: torch.Generator, batch: int,
                 seq_len: int) -> torch.Tensor:
    """(batch, seq_len) int32 token matrix from the domain's Markov chain,
    on the host: the first token from ``start``, then each successor by
    inverse-CDF sampling of its row of ``probs`` (one uniform per token)."""
    t0 = torch.multinomial(spec.start, batch, replacement=True,
                           generator=generator)
    u = torch.rand((seq_len - 1, batch, 1), generator=generator)
    cdf = spec.probs.cumsum(-1)
    last = spec.probs.shape[1] - 1
    succ = spec.succ.long()
    out = torch.empty((batch, seq_len), dtype=torch.long)
    out[:, 0] = tok = t0
    for t in range(seq_len - 1):
        pick = (cdf[tok] < u[t]).sum(-1).clamp_(max=last)
        tok = succ[tok, pick]
        out[:, t + 1] = tok
    return out.to(torch.int32)


def token_stream(cfg: DataConfig, domain_id: int, start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1, device="cuda",
                 frames=None):
    """Infinite deterministic iterator of {'tokens': (B/H, S) int32}
    batches on ``device`` (the card unless ``device="cpu"``), from step
    ``start_step`` on; host ``host_id`` of ``n_hosts`` gets its rows of
    each step's batch.  ``frames`` (n_frames, d_model), for the
    encoder-decoder family, adds 'frames' (B/H, n_frames, d_model) f32:
    the stub front end's frame embeddings, standard normal, drawn from
    the step's generator after its tokens (the reference's stream has
    none, so its launcher cannot train that family)."""
    dev = resolve_device(device)
    spec = make_domain(cfg, domain_id)
    b_local = cfg.batch // n_hosts
    step = start_step
    while True:
        gen = batch_generator(cfg.seed, step, domain_id)
        full = sample_batch(spec, gen, cfg.batch, cfg.seq_len)
        mine = slice(host_id * b_local, (host_id + 1) * b_local)
        out = {"tokens": full[mine].to(dev, non_blocking=True)}
        if frames is not None:
            f = torch.randn((cfg.batch, *frames), generator=gen)
            out["frames"] = f[mine].to(dev, non_blocking=True)
        yield out
        step += 1
