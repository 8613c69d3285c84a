"""Language model entry points — embed → stack → norm → tied vocab head.

    init_params(cfg, generator, device)            → params tree
    init_decode_state(cfg, batch, max_len, kvcfg, num_blocks=)
                                                   → decode state
    prefill(cfg, params, batch, max_len, ...)      → (logits, state, stats)
    decode_step(cfg, params, state, token, pos)    → (logits, state)
    decode_many(cfg, params, state, token, pos, done, remaining, gen,
                poison=None, K=..., detect_faults=False)
                                                   → ((tokens, valid[, fault]),
                                                      carry)
    verify_window(cfg, params, state, tokens, pos) → (logits, state)
    speculate_many(cfg, draft_params, params, state, token, pos, done,
                   remaining, gen, poison=None, K=..., W=...,
                   detect_faults=False)      → ((tokens, valid[, fault]),
                                                carry)

``batch`` is a dict {'tokens': (B,S) int}.  Decode updates the KV caches of
``state`` in place; a paged state's ``block_table`` addresses its pools.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device

from . import stack as S
from .common import linear, norm, sample_logits
from .config import ModelConfig


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Seeded random init at the config's shapes (bf16 weights, f32 norms).
    Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    S.stack_spec(cfg)                       # rejects families not ported
    if not cfg.tie_embeddings or cfg.pos != "rope":
        raise NotImplementedError("untied heads / learned positions: later slice")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    D = cfg.d_model
    embed = torch.empty((cfg.vocab, D), dtype=torch.bfloat16, device=dev)
    rows = max(1, (1 << 26) // D)           # draw ≤ 256 MB of f32 at a time
    for r0 in range(0, cfg.vocab, rows):
        n = min(rows, cfg.vocab - r0)
        embed[r0:r0 + n] = (torch.randn((n, D), generator=generator,
                                        device=dev) * D ** -0.5).to(embed.dtype)
    return {"embed": embed,
            "stack": S.init_stack(generator, cfg, S.stack_spec(cfg), dev),
            "final_norm": {"gamma": torch.zeros((D,), dtype=torch.float32,
                                                device=dev)}}


def _head(cfg, params, x, kcfg=None):
    return linear(x, params["embed"], kcfg=kcfg).float()


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, kvcfg=None,
                      device="cuda", num_blocks: int = 0):
    """``kvcfg`` selects the cache layout: bf16 slabs, or int8/int4 codes +
    f32 scales.  With ``kvcfg.paged`` the caches are shared pools of
    ``num_blocks`` blocks and the state carries ``block_table`` (B,
    max_len/block_size) int32, each row a slot's logical → physical block
    map; 0 is the sink block for unallocated entries and done-lane
    writes."""
    dev = resolve_device(device)
    paged = kvcfg is not None and kvcfg.paged
    if paged:
        if max_len % kvcfg.block_size:
            raise ValueError(f"max_len={max_len} must divide by "
                             f"block_size={kvcfg.block_size}")
        if num_blocks < 2:
            raise ValueError("paged cache needs num_blocks >= 2 "
                             "(block 0 is the reserved sink)")
    st = {"stack": S.init_stack_state(cfg, S.stack_spec(cfg), batch,
                                      max_len, kvcfg, dev, num_blocks)}
    if paged:
        st["block_table"] = torch.zeros(
            (batch, max_len // kvcfg.block_size), dtype=torch.int32,
            device=dev)
    return st


def prefill(cfg: ModelConfig, params, batch, max_len: int, *,
            collect_stats=True, full_logits=False, kvcfg=None,
            prefix_kv=None, pos0: int = 0, compact_state: bool = False):
    """Run the prompt in full precision: decode state + TTQ statistics.

    Returns (logits, state, stats): logits (B, V) for the last position, or
    (B, S, V) with ``full_logits``; stats {'stack': [per-run dict of (L, d)
    Σx² leaves]} keyed by parameter path.  ``prefix_kv``/``pos0`` (paged
    prefix-cache hits): the tokens are the prompt's tail, attending to the
    cached prefix k/v (per run, (k, v) with a leading layer dim, post-RoPE)
    at offset ``pos0``.  A paged state holds this call's rows only, at the
    storage dtype; ``compact_state`` gives a dense cache that layout too
    (chunked prefill: the runner writes the rows)."""
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    x, run_stats, states = S.apply_stack_seq(
        cfg, params["stack"], S.stack_spec(cfg), x, stats_on=collect_stats,
        want_state=True, max_len=max_len, kvcfg=kvcfg, pos0=pos0,
        prefix_kv=prefix_kv, compact_state=compact_state)
    x = norm(x, params["final_norm"])
    logits = _head(cfg, params, x if full_logits else x[:, -1:])
    if not full_logits:
        logits = logits[:, 0]
    stats = {"stack": run_stats} if collect_stats else None
    return logits, {"stack": states}, stats


def decode_step(cfg: ModelConfig, params, state, token, pos, *, kvcfg=None,
                kcfg=None):
    """token (B,1) int; pos (B,) int32 per-slot positions → (logits (B,V)
    f32, state).  The state's caches are written in place."""
    pos = pos.to(torch.int32).expand(token.shape[0])
    x = params["embed"][token.long()]
    x, _ = S.apply_stack_decode(cfg, params["stack"], S.stack_spec(cfg),
                                state["stack"], x, pos, kvcfg=kvcfg,
                                kcfg=kcfg,
                                block_table=state.get("block_table"))
    x = norm(x, params["final_norm"])
    return _head(cfg, params, x, kcfg)[:, 0], state


def decode_many(cfg: ModelConfig, params, state, token, pos, done, remaining,
                generator=None, poison=None, *, K: int, max_len: int,
                temperature: float = 0.0, eos_token: int = -1,
                detect_faults: bool = False, kvcfg=None, kcfg=None):
    """K fused decode steps with sampling, EOS, per-slot done masking, budget
    accounting and position advance on the device: nothing inside reads a
    value back to the host, so a K-token block costs one host transfer.

    token (B,1) int32; pos (B,) int32; done (B,) bool (True = inactive
    lane: it computes but emits nothing, pos/token held); remaining (B,)
    int32.  A live slot finishes on ``eos_token``, an exhausted budget, or a
    full cache.  Returns ((tokens (B,K) int32, valid (B,K) bool),
    (state, token, pos, done, remaining, generator)).

    Fault isolation: with ``detect_faults`` each step's logits are checked
    for finiteness on the device; a lane whose logits are not finite emits
    nothing from that step on (its done flag trips, token and position
    hold), and the outputs gain ``fault`` (B,) bool.  ``poison`` ((B,) bool
    or None), the injection site, forces the flagged lanes' logits to NaN.
    With both off the steps are exactly the unguarded ones."""
    toks, valids, flts = [], [], []
    tok, p, dn, rem = token, pos, done, remaining
    for _ in range(K):
        p_in = torch.clamp(p, max=max_len - 1)   # done lanes: in-bounds writes
        logits, state = decode_step(cfg, params, state, tok, p_in,
                                    kvcfg=kvcfg, kcfg=kcfg)
        if poison is not None:
            logits = torch.where(poison[:, None], float("nan"), logits)
        live = ~dn
        if detect_faults:
            flt = live & ~torch.isfinite(logits).all(dim=-1)
            live = live & ~flt              # faulted lane: emits nothing,
            dn = dn | flt                   # holds token/pos, trips done
            flts.append(flt)
        nxt = sample_logits(logits, generator, temperature)
        nxt = torch.where(live, nxt, tok[:, 0])
        rem = rem - live.to(torch.int32)
        p = p + live.to(torch.int32)
        stop = (nxt == eos_token) | (p >= max_len) | (rem <= 0)
        dn = dn | (live & stop)
        tok = nxt[:, None]
        toks.append(nxt)
        valids.append(live)
    ys = (torch.stack(toks, dim=1), torch.stack(valids, dim=1))
    if detect_faults:
        ys += (torch.stack(flts).any(dim=0),)
    return ys, (state, tok, p, dn, rem, generator)


def verify_window(cfg: ModelConfig, params, state, tokens, pos, *, kvcfg=None,
                  kcfg=None):
    """Score a drafted window in one pass: tokens (B,S) int — per slot the
    current token and S-1 drafts — at positions pos[b]..pos[b]+S-1.  The
    window's KV rows are written with this tree's k/v (over the draft
    pass's), then read, so the logits (B,S,V) f32 are those of S sequential
    :func:`decode_step` calls (bit for bit on the CPU).  The state's caches
    are written in place."""
    pos = pos.to(torch.int32).expand(tokens.shape[0])
    x = params["embed"][tokens.long()]
    x, _ = S.apply_stack_verify(cfg, params["stack"], S.stack_spec(cfg),
                                state["stack"], x, pos, kvcfg=kvcfg,
                                kcfg=kcfg,
                                block_table=state.get("block_table"))
    x = norm(x, params["final_norm"])
    return _head(cfg, params, x, kcfg), state


def speculate_many(cfg: ModelConfig, draft_params, params, state, token, pos,
                   done, remaining, generator=None, poison=None, *, K: int,
                   W: int, max_len: int, eos_token: int = -1,
                   detect_faults: bool = False, kvcfg=None, kcfg=None):
    """Self-speculative fused decode: K draft/verify windows, greedy only.

    Each window drafts W tokens with ``draft_params`` (W :func:`decode_step`
    calls), then scores the current token and the W drafts with ``params``
    in one :func:`verify_window`.  Greedy acceptance on the device keeps the
    longest agreeing draft prefix plus the verifier's next token, so a live
    lane emits 1 to W+1 tokens per window.  KV rollback is positional: the
    verify pass rewrites the window's rows at verify quality, and rejected
    rows lie at or past the new frontier, where the next window writes
    before any query reads them.  Nothing reads a value back to the host.

    The carry protocol of :func:`decode_many`; returns ((tokens (B,
    K·(W+1)) int32, valid (B, K·(W+1)) bool), (state, token, pos, done,
    remaining, generator)), window-major per slot.

    ``poison``/``detect_faults`` as in :func:`decode_many`, on the verify
    logits (the verify tree decides every emitted token): a lane whose
    verify window is not finite emits nothing from that window on, and the
    outputs gain ``fault`` (B,) bool."""
    toks, valids, flts = [], [], []
    tok, p, dn, rem = token, pos, done, remaining
    for _ in range(K):
        tk, pp, drafts = tok, p, []
        for _ in range(W):
            logits, state = decode_step(cfg, draft_params, state, tk,
                                        torch.clamp(pp, max=max_len - 1),
                                        kvcfg=kvcfg, kcfg=kcfg)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(nxt)
            tk, pp = nxt[:, None], pp + 1
        drafts = torch.stack(drafts, dim=1)                      # (B, W)
        logits, state = verify_window(cfg, params, state,
                                      torch.cat([tok, drafts], dim=1), p,
                                      kvcfg=kvcfg, kcfg=kcfg)
        if poison is not None:
            logits = torch.where(poison[:, None, None], float("nan"), logits)
        if detect_faults:
            flt = ~dn & ~torch.isfinite(logits).all(dim=-1).all(dim=-1)
            dn = dn | flt                   # faulted lane: window out
            flts.append(flt)
        v = torch.argmax(logits, dim=-1).to(torch.int32)         # (B, W+1)
        # candidate i is the verifier's token after window token i; it is
        # emitted iff the first i drafts all agree
        a = torch.cumprod((drafts == v[:, :W]).to(torch.int32), dim=1).sum(1)
        for i in range(W + 1):
            use = ~dn & (i <= a)
            nxt = torch.where(use, v[:, i], tok[:, 0])
            rem = rem - use.to(torch.int32)
            p = p + use.to(torch.int32)
            stop = (nxt == eos_token) | (p >= max_len) | (rem <= 0)
            dn = dn | (use & stop)
            tok = nxt[:, None]
            toks.append(nxt)
            valids.append(use)
    ys = (torch.stack(toks, dim=1), torch.stack(valids, dim=1))
    if detect_faults:
        ys += (torch.stack(flts).any(dim=0),)
    return ys, (state, tok, p, dn, rem, generator)
