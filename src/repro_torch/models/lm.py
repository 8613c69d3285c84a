"""Language model entry points — embed → stack → norm → vocab head (the
embedding, tied, or ``lm_head`` where ``cfg.tie_embeddings`` is False).

    init_params(cfg, generator, device)            → params tree
    forward(cfg, params, batch, collect_stats=)    → (logits, stats, states)
    loss_fn(cfg, params, batch, pctx=, remat=)     → (loss, aux)
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

``pctx`` (a :class:`~repro_torch.parallel.ParallelCtx`) runs every entry
point on this rank's slice of the parameters and state
(``parallel/rules.py:shard_params``): attention and MLP blocks under
Megatron-style tensor parallelism where the layout splits them (plain
and latent attention on heads, the RG-LRU on channels, SSD on heads, the
MLPs on their hidden width), MoE experts expert-parallel (``moe_impl``:
each rank's experts over every token, or the all-to-all token dispatch),
the embedding and the vocab head vocab-parallel (a masked lookup then an
all-reduce; the rank's logits then an all-gather before any argmax).
Each entry point binds the layout (``rules.bind``) and runs the stack on
the rank's config (``rules.local_cfg``).

``batch`` is a dict {'tokens': (B,S) int} and, for the encoder-decoder
family, 'frames' (B, n_frames, d_model): the stub front end's frame
embeddings, which the encoder stack reads.  Decode updates ``state`` in
place (the KV caches, MLA's latent and rope-key caches, and the recurrent
h and conv histories of a hybrid or SSM stack); a paged state's
``block_table`` addresses its pools.  The stack is a list of runs of
units (``models/stack.py``): one run of ``attn`` layers for the dense, vlm
and llama4-style MoE families, of ``mla`` layers for deepseek's, of
``ssd`` layers for mamba2's, of ``xdec`` layers (beside an ``enc_stack``
of ``enc`` layers) for whisper's, runs of (rec, rec, lattn) for the
hybrid.  A config with learned positions adds ``pos_embed`` (max_seq, D)
at each token's position.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device

from repro_torch.parallel import comm
from repro_torch.parallel.rules import (bind, block_ctx, local_cfg,
                                        state_sharding)

from . import stack as S
from .common import init_norm, linear, norm, sample_logits, sinusoidal_pos
from .config import ModelConfig


def draw_table(n: int, D: int, sd: float, generator: torch.Generator,
               device) -> torch.Tensor:
    """An (n, D) bf16 table ~ N(0, sd²) from ``generator``, drawn at most
    256 MB of f32 at a time (a full-width vocabulary's f32 draw would be
    several GB)."""
    t = torch.empty((n, D), dtype=torch.bfloat16, device=device)
    rows = max(1, (1 << 26) // D)
    for r0 in range(0, n, rows):
        k = min(rows, n - r0)
        t[r0:r0 + k] = (torch.randn((k, D), generator=generator,
                                    device=device) * sd).to(t.dtype)
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Seeded random init at the config's shapes (bf16 weights, f32 norms):
    the reference's tree, with ``pos_embed`` (max_seq, D) ~ N(0, 0.02²)
    for learned positions, the encoder's ``enc_stack`` and ``enc_norm``
    for the encoder-decoder family, and an untied head ``lm_head`` (V, D)
    ~ N(0, 1/D), the embedding's scale, where ``cfg.tie_embeddings`` is
    False.  ``lm_head`` is drawn last, so every other leaf is the tied
    config's on the same generator.  Runs on the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    D = cfg.d_model
    nk = "rms" if cfg.norm == "rms" else "layer"
    p = {"embed": draw_table(cfg.vocab, D, D ** -0.5, generator, dev),
         "stack": S.init_stack(generator, cfg, S.stack_spec(cfg), dev),
         "final_norm": init_norm(D, nk, device=dev)}
    if cfg.pos == "learned":
        p["pos_embed"] = draw_table(cfg.max_seq, D, 0.02, generator, dev)
    if cfg.family == "encdec":
        p["enc_stack"] = S.init_stack(generator, cfg, S.enc_spec(cfg), dev)
        p["enc_norm"] = init_norm(D, nk, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = draw_table(cfg.vocab, D, D ** -0.5, generator, dev)
    return p


def _lookup(params, tokens, pctx=None):
    """Token embeddings.  Vocab-parallel under ``pctx``: the rank holds
    rows [r·V/n, (r+1)·V/n); a token outside them looks up zeros, and the
    all-reduce over the model axis puts every row in place (a sum of one
    row and zeros: exact)."""
    E = params["embed"]
    vctx = block_ctx(pctx, "vocab")
    if vctx is None:
        return E[tokens.long()]
    t = tokens.long() - vctx.rank * E.shape[0]
    inside = (t >= 0) & (t < E.shape[0])
    x = E[torch.clamp(t, 0, E.shape[0] - 1)]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return comm.all_reduce(x, vctx)


def _embed(cfg, params, tokens, pos0: int = 0, pctx=None):
    """Token embeddings (B,S,D), plus learned positions pos0.. ."""
    x = _lookup(params, tokens, pctx)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][pos0:pos0 + tokens.shape[1]][None]
    return x


def _encode(cfg, params, frames, stats_on=False, pctx=None):
    """The encoder: frames (B,F,D) in bf16 plus sinusoidal positions
    through ``enc_stack`` and ``enc_norm`` → (enc_out (B,F,D), its
    per-run statistics or None).  Under ``pctx`` (``cfg`` the rank's) its
    attention and MLP split as the decoder's; ``enc_out`` is whole on
    every rank."""
    x = frames.to(torch.bfloat16) + sinusoidal_pos(
        frames.shape[1], cfg.d_model, frames.device)[None]
    x, stats, _ = S.apply_stack_seq(cfg, params["enc_stack"], S.enc_spec(cfg),
                                    x, stats_on=stats_on, pctx=pctx)
    return norm(x, params["enc_norm"]), stats


def _head(cfg, params, x, kcfg=None, pctx=None):
    """f32 logits over the whole vocab through the embedding (tied) or
    ``lm_head``; vocab-parallel under ``pctx`` (the rank's rows of the
    head, then an all-gather of the logits, in their own dtype: widened
    after it, the same values for half the bytes)."""
    vctx = block_ctx(pctx, "vocab")
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = linear(x, w, kcfg=kcfg, pctx=vctx, tp="row")
    if vctx is not None:
        logits = comm.all_gather(logits, vctx, dim=-1)
    return logits.float()


def forward(cfg: ModelConfig, params, batch, *, collect_stats=False,
            want_state=False, max_len=0, remat=False, kcfg=None, pctx=None):
    """Full-sequence forward: logits (B, S, V) f32 for every position.
    Returns (logits, stats, states): stats {'stack': [per-run dict of (L, d)
    Σx² leaves]} (and 'enc_stack', the encoder's) keyed by parameter path
    when ``collect_stats``, else None; states the per-run decode states
    when ``want_state`` (a ``max_len`` slab), else empty.  ``remat``
    checkpoints each decoder layer's mixer and MLP (training)."""
    pctx = bind(pctx, cfg)
    lcfg = local_cfg(cfg, pctx)
    stats, enc_out = {}, None
    if cfg.family == "encdec":
        enc_out, enc_stats = _encode(lcfg, params, batch["frames"],
                                     collect_stats, pctx)
        if collect_stats:
            stats["enc_stack"] = enc_stats
    x = _embed(cfg, params, batch["tokens"], pctx=pctx)
    x, run_stats, states = S.apply_stack_seq(
        lcfg, params["stack"], S.stack_spec(cfg), x, stats_on=collect_stats,
        want_state=want_state, max_len=max_len, kcfg=kcfg, enc_out=enc_out,
        remat=remat, pctx=pctx)
    stats["stack"] = run_stats
    x = norm(x, params["final_norm"])
    logits = _head(cfg, params, x, kcfg, pctx)
    return logits, (stats if collect_stats else None), states


def loss_fn(cfg: ModelConfig, params, batch, *, pctx=None, remat=False):
    """Next-token cross-entropy over :func:`forward`'s f32 logits, through
    a logsumexp and a gather.  ``batch['mask']`` (optional, f32, (B,S) or
    (B,S-1)) weights each target.  Returns (loss, {'loss', 'tokens'}),
    'tokens' the mask's sum (at least 1).  Under ``pctx`` ``params`` are
    the rank's slices and ``batch`` the rank's rows of the global batch;
    the loss is the global batch's: the weighted NLL and the mask summed
    over the data axis, then divided (an all-reduce whose backward is the
    identity, so each rank's gradient is its rows' share of the global
    mean's, and the trainer sums the gradients over the data axis).  The
    vocab-parallel head gathers the f32 logits whole, so the cross-entropy
    is the same on every model rank."""
    logits, _, _ = forward(cfg, params, batch, remat=remat, pctx=pctx)
    targets = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    elif mask.shape[1] == batch["tokens"].shape[1]:
        mask = mask[:, 1:]
    nll = (lse - gold) * mask
    num, denom = nll.sum(), mask.sum()
    if pctx is not None and pctx.mesh is not None and pctx.dp_world > 1:
        num = comm.all_reduce(num, pctx, axis="data")
        denom = comm.all_reduce(denom, pctx, axis="data")
    denom = torch.clamp(denom, min=1.0)
    loss = num / denom
    return loss, {"loss": loss, "tokens": denom}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, kvcfg=None,
                      device="cuda", num_blocks: int = 0, pctx=None):
    """``kvcfg`` selects the cache layout: bf16 slabs, or int8/int4 codes +
    f32 scales.  With ``kvcfg.paged`` the caches are shared pools of
    ``num_blocks`` blocks and the state carries ``block_table`` (B,
    max_len/block_size) int32, each row a slot's logical → physical block
    map; 0 is the sink block for unallocated entries and done-lane
    writes.  The encoder-decoder family's state also holds ``enc_out``
    (B, n_frames, D) bf16.  Under ``pctx`` each leaf is the rank's slice of
    the whole state per ``parallel/rules.py:state_sharding`` (KV heads,
    recurrent channels, SSD heads), allocated at that size: the whole
    state's shapes are laid out on the meta device first."""
    dev = resolve_device(device)
    pctx = bind(pctx, cfg)
    paged = kvcfg is not None and kvcfg.paged
    if pctx is not None and pctx.world > 1:
        whole = init_decode_state(cfg, batch, max_len, kvcfg, "meta",
                                  num_blocks)
        specs = state_sharding(whole, pctx, paged=paged)

        def local(t, spec):
            if isinstance(t, dict):
                return {k: local(v, spec[k]) for k, v in t.items()}
            if isinstance(t, list):
                return [local(v, sp) for v, sp in zip(t, spec)]
            shape = [d // pctx.world if ax == pctx.model_axis else d
                     for d, ax in zip(t.shape, spec)]
            return torch.zeros(shape, dtype=t.dtype, device=dev)
        return local(whole, specs)
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
    if cfg.family == "encdec":
        st["enc_out"] = torch.zeros((batch, cfg.encdec.n_frames, cfg.d_model),
                                    dtype=torch.bfloat16, device=dev)
    return st


def prefill(cfg: ModelConfig, params, batch, max_len: int, *,
            collect_stats=True, full_logits=False, kvcfg=None,
            prefix_kv=None, pos0: int = 0, compact_state: bool = False,
            pctx=None):
    """Run the prompt in full precision: decode state + TTQ statistics.

    Returns (logits, state, stats): logits (B, V) for the last position, or
    (B, S, V) with ``full_logits``; stats {'stack': [per-run dict of (L, d)
    Σx² leaves]} keyed by parameter path.  ``prefix_kv``/``pos0`` (paged
    prefix-cache hits): the tokens are the prompt's tail, attending to the
    cached prefix k/v (per run, (k, v) with a leading layer dim, post-RoPE)
    at offset ``pos0``.  A paged state holds this call's rows only, at the
    storage dtype; ``compact_state`` gives a dense cache that layout too
    (chunked prefill: the runner writes the rows).  The encoder-decoder
    family first encodes ``batch['frames']``: its state adds ``enc_out``
    and each ``xdec`` layer's cross k/v, its stats ``enc_stack``."""
    pctx = bind(pctx, cfg)
    lcfg = local_cfg(cfg, pctx)
    stats, enc_out = {}, None
    if cfg.family == "encdec":
        enc_out, enc_stats = _encode(lcfg, params, batch["frames"],
                                     collect_stats, pctx)
        if collect_stats:
            stats["enc_stack"] = enc_stats
    x = _embed(cfg, params, batch["tokens"], pos0, pctx)
    x, run_stats, states = S.apply_stack_seq(
        lcfg, params["stack"], S.stack_spec(cfg), x, stats_on=collect_stats,
        want_state=True, max_len=max_len, kvcfg=kvcfg, pos0=pos0,
        prefix_kv=prefix_kv, compact_state=compact_state, enc_out=enc_out,
        pctx=pctx)
    stats["stack"] = run_stats
    x = norm(x, params["final_norm"])
    logits = _head(cfg, params, x if full_logits else x[:, -1:], pctx=pctx)
    if not full_logits:
        logits = logits[:, 0]
    state = {"stack": states}
    if enc_out is not None:
        state["enc_out"] = enc_out
    return logits, state, (stats if collect_stats else None)


def decode_step(cfg: ModelConfig, params, state, token, pos, *, kvcfg=None,
                kcfg=None, pctx=None):
    """token (B,1) int; pos (B,) int32 per-slot positions → (logits (B,V)
    f32, state).  The state's caches are written in place."""
    pctx = bind(pctx, cfg)
    pos = pos.to(torch.int32).expand(token.shape[0])
    x = _lookup(params, token, pctx)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][pos.long()][:, None]
    x, _ = S.apply_stack_decode(local_cfg(cfg, pctx), params["stack"],
                                S.stack_spec(cfg), state["stack"], x, pos,
                                kvcfg=kvcfg, kcfg=kcfg,
                                block_table=state.get("block_table"),
                                pctx=pctx)
    x = norm(x, params["final_norm"])
    return _head(cfg, params, x, kcfg, pctx)[:, 0], state


def decode_many(cfg: ModelConfig, params, state, token, pos, done, remaining,
                generator=None, poison=None, *, K: int, max_len: int,
                temperature: float = 0.0, eos_token: int = -1,
                detect_faults: bool = False, kvcfg=None, kcfg=None,
                pctx=None):
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
    With both off the steps are exactly the unguarded ones.  Every rank
    of ``pctx`` samples the same tokens from the gathered logits."""
    pctx = bind(pctx, cfg)
    toks, valids, flts = [], [], []
    tok, p, dn, rem = token, pos, done, remaining
    for _ in range(K):
        p_in = torch.clamp(p, max=max_len - 1)   # done lanes: in-bounds writes
        logits, state = decode_step(cfg, params, state, tok, p_in,
                                    kvcfg=kvcfg, kcfg=kcfg, pctx=pctx)
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
                  kcfg=None, pctx=None):
    """Score a drafted window in one pass: tokens (B,S) int — per slot the
    current token and S-1 drafts — at positions pos[b]..pos[b]+S-1.  The
    window's KV rows are written with this tree's k/v (over the draft
    pass's), then read, so the logits (B,S,V) f32 are those of S sequential
    :func:`decode_step` calls (bit for bit on the CPU).  The state's caches
    are written in place."""
    pctx = bind(pctx, cfg)
    pos = pos.to(torch.int32).expand(tokens.shape[0])
    x = _lookup(params, tokens, pctx)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][pos.long()[:, None] + torch.arange(
            tokens.shape[1], device=pos.device)]
    x, _ = S.apply_stack_verify(local_cfg(cfg, pctx), params["stack"],
                                S.stack_spec(cfg), state["stack"], x, pos,
                                kvcfg=kvcfg, kcfg=kcfg,
                                block_table=state.get("block_table"),
                                pctx=pctx)
    x = norm(x, params["final_norm"])
    return _head(cfg, params, x, kcfg, pctx), state


def speculate_many(cfg: ModelConfig, draft_params, params, state, token, pos,
                   done, remaining, generator=None, poison=None, *, K: int,
                   W: int, max_len: int, eos_token: int = -1,
                   detect_faults: bool = False, kvcfg=None, kcfg=None,
                   pctx=None):
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
    pctx = bind(pctx, cfg)
    toks, valids, flts = [], [], []
    tok, p, dn, rem = token, pos, done, remaining
    for _ in range(K):
        tk, pp, drafts = tok, p, []
        for _ in range(W):
            logits, state = decode_step(cfg, draft_params, state, tk,
                                        torch.clamp(pp, max=max_len - 1),
                                        kvcfg=kvcfg, kcfg=kcfg, pctx=pctx)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(nxt)
            tk, pp = nxt[:, None], pp + 1
        drafts = torch.stack(drafts, dim=1)                      # (B, W)
        logits, state = verify_window(cfg, params, state,
                                      torch.cat([tok, drafts], dim=1), p,
                                      kvcfg=kvcfg, kcfg=kcfg, pctx=pctx)
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
