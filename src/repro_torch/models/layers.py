"""Mixer layers — attention (the ``attn`` and windowed ``lattn`` kinds, the
encoder's and the cross-attention of ``enc``/``xdec``), DeepSeek's latent
attention (``mla``), the RG-LRU recurrent block (``rec``) and Mamba2's SSD
(``ssd``): init, sequence mode, decode; and the MoE MLP.

  init_attn(gen, cfg, n, device)             → stacked param dict (n layers)
  attn_apply(cfg, p, x, stats, prefix, ...)  → prefill output [, (k, v)]
  attn_decode(cfg, p, x, state, pos, ...)    → (y, state) single token
  attn_decode_rolling(cfg, p, x, state, ...) → (y, state) windowed, O(W)
  attn_verify(cfg, p, x, state, pos, ...)    → (y, state) a drafted window
  attn_init_state / build_kv_state           → one layer's decode cache
  build_kv_compact                           → prefill rows for the pool
  init_rec / rec_apply / rec_decode / rec_init_state
                                             → the RG-LRU block
  init_ssd / ssd_apply / ssd_decode / ssd_init_state
                                             → Mamba2's SSD block
  init_mla / mla_apply / mla_decode / mla_init_state
                                             → latent attention (MLA)
  init_moe / moe_apply_dense                 → the MoE MLP (every expert
                                               computes every token)
  moe_apply_a2a / moe_a2a                    → the expert-parallel MoE MLP
                                               (tokens dispatched with
                                               all-to-alls and capacity)

Stats taps use parameter-path names (``prefix + "wq"``) so the quantizer
joins statistics to weights by path.  Decode writes the new token's k/v
into the cache in place (a scatter per slot, or per pool row when the
cache is paged): the cache is the largest decode state, and the
reference's functional update would copy it.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvquant import dequantize_kv, quantize_kv

from .common import (ACT, apply_rope, attention, cache_update_batched,
                     decode_attention, enter, init_norm, linear, rmsnorm,
                     rope_decode, rope_window, seq_update_batched,
                     suffix_attention)
from .config import ModelConfig

DTYPE = torch.bfloat16


def init_linear(gen, n: int, d_out: int, d_in: int, device,
                dtype=DTYPE) -> torch.Tensor:
    """n stacked (d_out, d_in) weights ~ N(0, 1/d_in), drawn layer by layer
    so a full-width init never holds an f32 copy of a whole stack."""
    w = torch.empty((n, d_out, d_in), dtype=dtype, device=device)
    for i in range(n):
        w[i] = (torch.randn((d_out, d_in), generator=gen, device=device)
                * d_in ** -0.5).to(dtype)
    return w


def init_attn(gen, cfg: ModelConfig, n: int, device):
    """Stacked wq/wk/wv/wo; a qk-norm family also gets per-head RMSNorm
    gammas ``qnorm`` and ``knorm`` (hd,) (``*norm*`` leaves: never
    quantized)."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": init_linear(gen, n, H * hd, D, device),
         "wk": init_linear(gen, n, Hkv * hd, D, device),
         "wv": init_linear(gen, n, Hkv * hd, D, device),
         "wo": init_linear(gen, n, D, H * hd, device)}
    if cfg.qk_norm:
        p["qnorm"] = init_norm(hd, "rms", n, device)
        p["knorm"] = init_norm(hd, "rms", n, device)
    return p


def _qkv(cfg: ModelConfig, p, x, stats, prefix: str, kcfg=None, xkv=None,
         pctx=None):
    """q, k, v (B, heads, S, hd): q from x, k and v from ``xkv`` (the
    encoder output of cross-attention; default x).  qk-norm (RMSNorm per
    head, before RoPE) here, so prefill, decode, verify and chunked prefill
    all take it.  Under ``pctx`` wq/wk/wv are the rank's row slices and
    ``cfg`` counts its heads (``parallel/rules.py:local_cfg``); ``x``
    enters the block once for q, k and v, and a cross-attention's
    ``xkv`` once for k and v (in training each sums its cotangent over
    the model axis: every rank reads the whole encoder output for its own
    heads only)."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = enter(x, pctx)
    xkv = x if xkv is None else enter(xkv, pctx)
    q = linear(x, p["wq"], stats, prefix + "wq", kcfg, pctx=pctx,
               tp="row").reshape(B, -1, H, hd)
    k = linear(xkv, p["wk"], None, kcfg=kcfg, pctx=pctx,
               tp="row").reshape(B, -1, Hkv, hd)
    v = linear(xkv, p["wv"], None, kcfg=kcfg, pctx=pctx,
               tp="row").reshape(B, -1, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qnorm"]["gamma"])
        k = rmsnorm(k, p["knorm"]["gamma"])
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attn_apply(cfg: ModelConfig, p, x, stats, prefix: str, *,
               causal: bool = True, window: int = 0, pos0: int = 0,
               x_cross=None, return_kv: bool = False, kv_prefix=None,
               kvcfg=None, kcfg=None, pctx=None):
    """Sequence-mode attention, x (B,S,D) at absolute positions pos0.. ;
    a ``window`` W > 0 is local attention over the last W positions.
    RoPE only where the config's positions are ``rope``.  ``x_cross``
    (B,F,D): cross-attention over it, non-causal, without RoPE or KV
    quantization (``return_kv`` gives its k/v, the decode's bf16 cross
    cache).
    With a quantized ``kvcfg`` the attention reads the quantize→dequantize
    of k/v: exactly the values the cache will hold and every later decode
    step will read (so a re-prefill after preemption resumes on the same
    numbers).  ``kv_prefix`` = (k, v) each (B, Hkv, P, Dh): cached context
    (post-RoPE, e.g. a shared prompt prefix gathered from the paged pool)
    in front of this call's keys; the queries then start at ``pos0 == P``.
    ``return_kv`` returns only this call's k/v.  ``pctx``: head-parallel
    (the rank's heads; wo column-split and all-reduced)."""
    q, k, v = _qkv(cfg, p, x, stats, prefix, kcfg, xkv=x_cross, pctx=pctx)
    S = x.shape[1]
    cross = x_cross is not None
    if cfg.pos == "rope" and not cross:
        pos = torch.arange(S, device=x.device) + pos0
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    kf, vf = k, v
    if kvcfg is not None and kvcfg.quantized and not cross:
        kf, vf = (dequantize_kv(*quantize_kv(t, bits=kvcfg.bits,
                                             group_size=kvcfg.group_size),
                                torch.float32, bits=kvcfg.bits,
                                group_size=kvcfg.group_size) for t in (k, v))
    q_off = 0
    if kv_prefix is not None:
        pk, pv = kv_prefix
        kf = torch.cat([pk.to(kf.dtype), kf], dim=2)
        vf = torch.cat([pv.to(vf.dtype), vf], dim=2)
        q_off = pk.shape[2]
    o = attention(q, kf, vf, causal=causal and not cross, window=window,
                  soft_cap=cfg.attn_soft_cap, q_offset=q_off)
    y = linear(o.transpose(1, 2).reshape(x.shape[0], S, -1), p["wo"], stats,
               prefix + "wo", kcfg, pctx=pctx, tp="col")
    if return_kv:
        return y, (k, v)
    return y


def attn_init_state(cfg: ModelConfig, batch: int, max_len: int, kvcfg=None,
                    device="cuda", num_blocks: int = 0):
    """One layer's decode cache: bf16 {'k','v'} (B,Hkv,Smax,Dh), or
    {'k_q','k_s','v_q','v_s'} int8 / packed-int4 codes + f32 scales.  A
    paged ``kvcfg`` makes the same leaves one shared pool (num_blocks, Hkv,
    block_size, ·); the per-slot block tables live at the top of the decode
    state."""
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    if kvcfg is not None and kvcfg.paged:
        lead = (num_blocks, Hkv, kvcfg.block_size)
    else:
        lead = (batch, Hkv, max_len)
    if kvcfg is None or not kvcfg.quantized:
        return {"k": torch.zeros((*lead, hd), dtype=DTYPE, device=device),
                "v": torch.zeros((*lead, hd), dtype=DTYPE, device=device)}
    cz = (*lead, kvcfg.code_shape(hd))
    sz = (*lead, kvcfg.groups(hd))
    return {"k_q": torch.zeros(cz, dtype=kvcfg.code_dtype, device=device),
            "k_s": torch.zeros(sz, dtype=torch.float32, device=device),
            "v_q": torch.zeros(cz, dtype=kvcfg.code_dtype, device=device),
            "v_s": torch.zeros(sz, dtype=torch.float32, device=device)}


def build_kv_state(cfg: ModelConfig, batch: int, max_len: int, k, v,
                   kvcfg=None):
    """Prefill write point: the decode cache from sequence-mode k/v
    (B,Hkv,S,Dh), quantized at the cache's storage dtype."""
    z = attn_init_state(cfg, batch, max_len, kvcfg, device=k.device)
    S = k.shape[2]
    if kvcfg is None or not kvcfg.quantized:
        z["k"][:, :, :S] = k.to(DTYPE)
        z["v"][:, :, :S] = v.to(DTYPE)
        return z
    for name, t in (("k", k), ("v", v)):
        codes, scales = quantize_kv(t, bits=kvcfg.bits,
                                    group_size=kvcfg.group_size)
        z[name + "_q"][:, :, :S] = codes
        z[name + "_s"][:, :, :S] = scales
    return z


def _kv_append(state, k, v, pos, kvcfg):
    """Quantize one token's k/v and write codes and scales at ``pos``."""
    for name, t in (("k", k), ("v", v)):
        codes, scales = quantize_kv(t, bits=kvcfg.bits,
                                    group_size=kvcfg.group_size)
        cache_update_batched(state[name + "_q"], codes, pos)
        cache_update_batched(state[name + "_s"], scales, pos)
    return state


def build_kv_compact(k, v, kvcfg):
    """Paged prefill write point: this call's k/v (B,Hkv,S,Dh) at the
    cache's storage dtype, with no max_len slab; the runner scatters the
    rows into the slot's pool blocks."""
    if kvcfg is None or not kvcfg.quantized:
        return {"k": k.to(DTYPE), "v": v.to(DTYPE)}
    out = {}
    for name, t in (("k", k), ("v", v)):
        out[name + "_q"], out[name + "_s"] = quantize_kv(
            t, bits=kvcfg.bits, group_size=kvcfg.group_size)
    return out


def _pool_row_write(pool, row, idx):
    """pool (NB,Hkv,bs,D·) ← row (B,Hkv,S,D·) at the pool rows ``idx``
    (B·Hkv·S,), in place: a scatter, no host sync.  Live slots own distinct
    blocks, so the only duplicate index is the sink block 0 of done and
    empty lanes (and a window's rows past capacity), where any write order
    will do."""
    D = pool.shape[-1]
    pool.view(-1, D).scatter_(0, idx[:, None].expand(-1, D),
                              row.reshape(-1, D).to(pool.dtype))


def paged_rows(pos, block_table, Hkv: int, block_size: int) -> torch.Tensor:
    """The pool row of each (slot, kv head) that one decode append writes,
    (B·Hkv,) in the (NB·Hkv·bs) row view of a (NB, Hkv, bs, ·) pool: block
    ``block_table[b, pos // block_size]`` at offset ``pos % block_size``.
    Every layer writes the same rows, so a decode step computes them once
    (:func:`repro_torch.models.stack.apply_stack_decode`)."""
    bs = block_size
    blk = torch.clamp(pos // bs, 0, block_table.shape[1] - 1)
    phys = block_table.gather(1, blk.long()[:, None])
    h = torch.arange(Hkv, device=pos.device)
    return ((phys * Hkv + h) * bs + (pos % bs).long()[:, None]).reshape(-1)


def paged_window_rows(pos, block_table, Hkv: int, block_size: int,
                      S: int) -> torch.Tensor:
    """The pool rows a window of S tokens per slot at positions
    pos[b]..pos[b]+S-1 writes, (B·Hkv·S,) in (slot, head, token) order, as
    :func:`paged_rows`; a row at or past the slot's capacity (nblk·bs) goes
    to the sink block 0 instead of a clamped block, like a dense window's
    row past the slab (:func:`_kv_write_rows`)."""
    bs, nblk = block_size, block_table.shape[1]
    rows = pos.long()[:, None] + torch.arange(S, device=pos.device)  # (B,S)
    blk = torch.clamp(rows // bs, 0, nblk - 1)
    phys = block_table.gather(1, blk).long()
    phys = torch.where(rows < nblk * bs, phys, torch.zeros_like(phys))
    h = torch.arange(Hkv, device=pos.device)
    return ((phys[:, None, :] * Hkv + h[None, :, None]) * bs
            + (rows % bs)[:, None, :]).reshape(-1)


def _kv_append_paged(state, k, v, rows, kvcfg):
    """Paged append: the k/v rows (one token's, or a window's) land in the
    pool rows ``rows`` (:func:`paged_rows`, :func:`paged_window_rows`),
    shared by the four leaves."""
    if not kvcfg.quantized:
        _pool_row_write(state["k"], k, rows)
        _pool_row_write(state["v"], v, rows)
        return state
    for name, t in (("k", k), ("v", v)):
        codes, scales = quantize_kv(t, bits=kvcfg.bits,
                                    group_size=kvcfg.group_size)
        _pool_row_write(state[name + "_q"], codes, rows)
        _pool_row_write(state[name + "_s"], scales, rows)
    return state


def _kv_write_rows(cache, new, pos):
    """cache (B,Hkv,Smax,D·) ← new (B,Hkv,S,D·) at rows pos[b]..pos[b]+S-1,
    in place.  A row at or past Smax is dropped, as the reference's
    ``mode="drop"``: a scatter has no drop mode, a mask over the rows would
    sync the host, and clamping would let a row past the slab overwrite row
    Smax-1, which a query at the capacity boundary still reads.  So a row
    past the slab is sent to row Smax-1 carrying the bytes that row ends up
    with (the window's own row there, else the cache's current one): every
    write to a repeated index carries the same bytes."""
    B, Hkv, S, Dc = new.shape
    last = cache.shape[2] - 1
    new = new.to(cache.dtype)
    p = pos.long()
    rows = p[:, None] + torch.arange(S, device=pos.device)          # (B,S)
    j = torch.clamp(last - p, 0, S - 1).view(B, 1, 1, 1)
    hit = ((p <= last) & (p + S > last)).view(B, 1, 1, 1)
    at_last = torch.where(hit, new.gather(2, j.expand(B, Hkv, 1, Dc)),
                          cache[:, :, last:])
    src = torch.where((rows <= last).view(B, 1, S, 1), new, at_last)
    idx = torch.clamp(rows, max=last).view(B, 1, S, 1).expand(B, Hkv, S, Dc)
    cache.scatter_(2, idx, src)
    return cache


def _kv_append_rows(state, k, v, pos, kvcfg):
    """Quantized-slab window append: the window's codes and scale rows at
    positions pos..pos+S-1 (each row quantized as :func:`_kv_append`
    quantizes one token)."""
    for name, t in (("k", k), ("v", v)):
        codes, scales = quantize_kv(t, bits=kvcfg.bits,
                                    group_size=kvcfg.group_size)
        _kv_write_rows(state[name + "_q"], codes, pos)
        _kv_write_rows(state[name + "_s"], scales, pos)
    return state


def _kv_attention_paged(q, state, block_table, cur, kvcfg, *,
                        soft_cap: float = 0.0, pctx=None):
    """The read over the paged pool: quantized pools go through the
    ``ttq_paged_decode_attention`` kernel (on the rank's heads under
    ``pctx``); the bf16 pool gathers its block-table view and reuses the
    dense ``decode_attention``."""
    if kvcfg.quantized:
        from repro_torch.kernels import ops as kops
        return kops.kv_paged_decode_attention_tp(
            q, state["k_q"], state["k_s"], state["v_q"], state["v_s"],
            block_table, cur, bits=kvcfg.bits, group_size=kvcfg.group_size,
            soft_cap=soft_cap, use_pallas=kvcfg.use_pallas, pctx=pctx)
    from repro_torch.kernels.ref import gather_paged_kv
    return decode_attention(q, gather_paged_kv(state["k"], block_table),
                            gather_paged_kv(state["v"], block_table), cur,
                            soft_cap=soft_cap)


def _kv_attention(q, state, cur, kvcfg, *, soft_cap: float = 0.0,
                  pctx=None):
    """The quantized-cache read: the ``ttq_decode_attention`` kernel (on the
    rank's heads under ``pctx``)."""
    from repro_torch.kernels import ops as kops
    return kops.kv_decode_attention_tp(
        q, state["k_q"], state["k_s"], state["v_q"], state["v_s"], cur,
        bits=kvcfg.bits, group_size=kvcfg.group_size, soft_cap=soft_cap,
        use_pallas=kvcfg.use_pallas, pctx=pctx)


def attn_decode(cfg: ModelConfig, p, x, state, pos, *, kvcfg=None,
                kcfg=None, block_table=None, rows=None, cross_kv=None,
                pctx=None):
    """x (B,1,D); state bf16 {'k','v'} or quantized caches (``kvcfg``
    selects), updated in place; pos (B,) int32 per-slot positions.
    ``block_table`` (B, nblk) addresses the paged pool layout, and
    ``rows`` (:func:`paged_rows`) are the pool rows this token writes.
    ``cross_kv`` (k, v), each (B,Hkv,F,hd) bf16: cross-attention, one query
    over all F encoder rows through plain :func:`attention` (the reference
    reads them outside any kernel); ``state`` is returned untouched.
    ``pctx``: head-parallel, as :func:`attn_apply`."""
    if cross_kv is not None:
        B, (k, v) = x.shape[0], cross_kv
        q = linear(x, p["wq"], kcfg=kcfg, pctx=pctx, tp="row").reshape(
            B, 1, cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["qnorm"]["gamma"])
        o = attention(q.transpose(1, 2), k, v, causal=False,
                      soft_cap=cfg.attn_soft_cap)
        y = linear(o.transpose(1, 2).reshape(B, 1, -1), p["wo"], kcfg=kcfg,
                   pctx=pctx, tp="col")
        return y, state
    q, k, v = _qkv(cfg, p, x, None, "", kcfg, pctx=pctx)
    if cfg.pos == "rope":
        q = rope_decode(q, pos, cfg.rope_theta)
        k = rope_decode(k, pos, cfg.rope_theta)
    if kvcfg is not None and kvcfg.paged:
        st = _kv_append_paged(state, k, v, rows, kvcfg)
        o = _kv_attention_paged(q, st, block_table, pos, kvcfg,
                                soft_cap=cfg.attn_soft_cap, pctx=pctx)
    elif kvcfg is not None and kvcfg.quantized:
        st = _kv_append(state, k, v, pos, kvcfg)
        o = _kv_attention(q, st, pos, kvcfg, soft_cap=cfg.attn_soft_cap,
                          pctx=pctx)
    else:
        cache_update_batched(state["k"], k, pos)
        cache_update_batched(state["v"], v, pos)
        st = state
        o = decode_attention(q, st["k"], st["v"], pos,
                             soft_cap=cfg.attn_soft_cap)
    y = linear(o.reshape(x.shape[0], 1, -1), p["wo"], kcfg=kcfg, pctx=pctx,
               tp="col")
    return y, st


def attn_decode_rolling(cfg: ModelConfig, p, x, state, pos, window: int, *,
                        kvcfg=None, kcfg=None, pctx=None):
    """Windowed decode over a rolling (B,Hkv,W,·) cache, O(W) per step:
    position p lives in row p % W, written in place; the read covers rows
    0..min(pos, W-1) (the cache fills left to right before it wraps, and a
    softmax needs no order), so the slab itself is the window and no
    window mask enters the dense attention kernel.  ``pctx``:
    head-parallel, as :func:`attn_apply`."""
    q, k, v = _qkv(cfg, p, x, None, "", kcfg, pctx=pctx)
    if cfg.pos == "rope":
        q = rope_decode(q, pos, cfg.rope_theta)
        k = rope_decode(k, pos, cfg.rope_theta)
    wpos = torch.remainder(pos, window)
    cur = torch.clamp(pos, max=window - 1)
    if kvcfg is not None and kvcfg.quantized:
        _kv_append(state, k, v, wpos, kvcfg)
        o = _kv_attention(q, state, cur, kvcfg, soft_cap=cfg.attn_soft_cap,
                          pctx=pctx)
    else:
        cache_update_batched(state["k"], k, wpos)
        cache_update_batched(state["v"], v, wpos)
        o = decode_attention(q, state["k"], state["v"], cur,
                             soft_cap=cfg.attn_soft_cap)
    y = linear(o.reshape(x.shape[0], 1, -1), p["wo"], kcfg=kcfg, pctx=pctx,
               tp="col")
    return y, state


def attn_verify(cfg: ModelConfig, p, x, state, pos, *, kvcfg=None, kcfg=None,
                block_table=None, rows=None, pctx=None):
    """Score a drafted window at once: x (B,S,D) are the window's tokens at
    positions pos[b]..pos[b]+S-1 (pos (B,)).  The window's k/v rows are
    written first, at the cache's storage dtype, over whatever the draft
    pass stored there; then the suffix read runs over the updated cache.
    Write then read keeps the key axis of sequential decode, so rejected
    drafts roll back by rewinding positions.  ``rows``
    (:func:`paged_window_rows`) are the pool rows of a paged cache.
    Returns (y (B,S,D), state).  ``pctx``: head-parallel, as
    :func:`attn_apply`."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, None, "", kcfg, pctx=pctx)
    if cfg.pos == "rope":
        q = rope_window(q, pos, cfg.rope_theta)
        k = rope_window(k, pos, cfg.rope_theta)
    cap = cfg.attn_soft_cap
    if kvcfg is not None and kvcfg.paged:
        st = _kv_append_paged(state, k, v, rows, kvcfg)
        if kvcfg.quantized:
            from repro_torch.kernels import ops as kops
            o = kops.kv_paged_suffix_attention_tp(
                q, st["k_q"], st["k_s"], st["v_q"], st["v_s"], block_table,
                pos, bits=kvcfg.bits, group_size=kvcfg.group_size,
                soft_cap=cap, use_pallas=kvcfg.use_pallas, pctx=pctx)
        else:
            from repro_torch.kernels.ref import gather_paged_kv
            o = suffix_attention(q, gather_paged_kv(st["k"], block_table),
                                 gather_paged_kv(st["v"], block_table), pos,
                                 soft_cap=cap)
    elif kvcfg is not None and kvcfg.quantized:
        from repro_torch.kernels import ops as kops
        st = _kv_append_rows(state, k, v, pos, kvcfg)
        o = kops.kv_suffix_attention_tp(
            q, st["k_q"], st["k_s"], st["v_q"], st["v_s"], pos,
            bits=kvcfg.bits, group_size=kvcfg.group_size, soft_cap=cap,
            use_pallas=kvcfg.use_pallas, pctx=pctx)
    else:
        _kv_write_rows(state["k"], k, pos)
        _kv_write_rows(state["v"], v, pos)
        st = state
        o = suffix_attention(q, st["k"], st["v"], pos, soft_cap=cap)
    y = linear(o.transpose(1, 2).reshape(B, S, -1), p["wo"], kcfg=kcfg,
               pctx=pctx, tp="col")
    return y, st


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

RG_BLOCKS = 16      # block-diagonal gates (Griffin §2.4)
RG_C = 8.0


def init_rec(gen, cfg: ModelConfig, n: int, device):
    """``n`` stacked RG-LRU blocks: the gelu branch ``w_branch`` and the
    recurrent branch ``w_in`` (dr, D), ``w_out`` (D, dr), the depthwise
    causal conv ``conv_w`` (W, dr), the block-diagonal gates ``w_gate_a``
    and ``w_gate_x`` (16, dr/16, dr/16) and ``log_lambda`` (dr,) f32, the
    softplus⁻¹ of a decay drawn from U(0.9, 0.999)."""
    h = cfg.hybrid
    D, dr = cfg.d_model, (h.d_rnn or cfg.d_model)
    nb, bw = RG_BLOCKS, dr // RG_BLOCKS

    def draw(shape, sd):
        return (torch.randn((n, *shape), generator=gen, device=device)
                * sd).to(DTYPE)
    u = torch.rand((n, dr), generator=gen, device=device) * 0.099 + 0.9
    return {"w_branch": init_linear(gen, n, dr, D, device),
            "w_in": init_linear(gen, n, dr, D, device),
            "conv_w": draw((h.conv_width, dr), 0.1),
            "w_gate_a": draw((nb, bw, bw), bw ** -0.5),
            "w_gate_x": draw((nb, bw, bw), bw ** -0.5),
            "log_lambda": torch.log(torch.expm1(-torch.log(u))),
            "w_out": init_linear(gen, n, D, dr, device)}


def _block_diag(u, w):
    """u (B,S,dr) through the block-diagonal w (nb, o, i) → (B,S,dr)."""
    nb = w.shape[0]
    ub = u.reshape(*u.shape[:-1], nb, u.shape[-1] // nb)
    return torch.einsum("bsgi,goi->bsgo", ub, w.to(u.dtype)).reshape(u.shape)


def _rglru_coeffs(p, u):
    """u (B,S,dr), the conv output → the f32 (a, b) of h_t = a·h_{t-1} +
    b: a = exp(-c·softplus(Λ)·σ(gate_a)), b = sqrt(1 - a²)·σ(gate_x)·u."""
    rf = torch.sigmoid(_block_diag(u, p["w_gate_a"]).float())
    inp = torch.sigmoid(_block_diag(u, p["w_gate_x"]).float())
    log_a = -RG_C * torch.nn.functional.softplus(
        p["log_lambda"].float()) * rf
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (inp * u.float())
    return a, b


def _causal_conv(u, w, state=None):
    """Depthwise causal conv of u (B,S,dr) with w (W,dr) over the history
    ``state`` (B,W-1,dr) (zeros if None) → (out (B,S,dr), new history)."""
    W = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], W - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = ext[:, 0:S] * w[0].to(u.dtype)
    for i in range(1, W):
        out = out + ext[:, i:i + S] * w[i].to(u.dtype)
    return out, ext[:, -(W - 1):]


def _linear_scan(a, b):
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = 0 along dim 1, f32: a doubling
    (Hillis–Steele) scan of ⌈log₂ S⌉ elementwise steps, the port of the
    reference's ``associative_scan`` with its combine (a, b)∘(a', b') =
    (a'·a, a'·b + b'), so a prefill graph stays small at long S.  ``a``
    broadcasts against ``b`` (the SSD's per-head chunk decays over its
    (P, N) chunk states)."""
    S, d = a.shape[1], 1
    while d < S:
        a_hi, b_hi = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], a_hi * b[:, :-d] + b_hi], dim=1)
        a = torch.cat([a[:, :d], a_hi * a[:, :-d]], dim=1)
        d *= 2
    return b


def rec_apply(cfg: ModelConfig, p, x, stats, prefix: str, *,
              return_state: bool = False, kcfg=None, pctx=None):
    """Sequence-mode RG-LRU block from a zero state, x (B,S,D) → y (B,S,D)
    [, state]: gelu branch × recurrence over the causally convolved
    ``w_in`` branch.  ``return_state`` adds the decode state {'h' (B,dr)
    f32, 'conv' (B,W-1,dr)}.  ``pctx``: the rank's channels of the width
    (w_branch/w_in row slices, its gate blocks, conv and decay channels;
    every step of the recurrence is per channel), ``w_out`` column-split
    and all-reduced."""
    br = ACT["gelu"](linear(x, p["w_branch"], stats, prefix + "w_branch",
                            kcfg, pctx=pctx, tp="row").float())
    u = linear(x, p["w_in"], None, kcfg=kcfg, pctx=pctx, tp="row")
    u, conv_state = _causal_conv(u, p["conv_w"])
    h = _linear_scan(*_rglru_coeffs(p, u))
    y = linear((br * h).to(x.dtype), p["w_out"], stats, prefix + "w_out",
               kcfg, pctx=pctx, tp="col")
    if return_state:
        return y, {"h": h[:, -1], "conv": conv_state}
    return y


def rec_init_state(cfg: ModelConfig, batch: int, device="cuda"):
    h = cfg.hybrid
    dr = h.d_rnn or cfg.d_model
    return {"h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, h.conv_width - 1, dr), dtype=DTYPE,
                                device=device)}


def rec_decode(cfg: ModelConfig, p, x, state, *, kcfg=None, pctx=None):
    """One token x (B,1,D) through the block.  The new ``h`` and conv
    history are copied into ``state``'s tensors in place (the reference
    returns fresh ones): a decode graph reads the state at fixed addresses,
    and the stack keeps no returned state.  ``pctx``: as
    :func:`rec_apply`, on the rank's channels of the state."""
    br = ACT["gelu"](linear(x, p["w_branch"], kcfg=kcfg, pctx=pctx,
                            tp="row").float())
    u = linear(x, p["w_in"], kcfg=kcfg, pctx=pctx, tp="row")
    u, conv_state = _causal_conv(u, p["conv_w"], state["conv"])
    a, b = _rglru_coeffs(p, u)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = linear((br[:, 0] * h)[:, None].to(x.dtype), p["w_out"], kcfg=kcfg,
               pctx=pctx, tp="col")
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return y, state


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality, chunked)
# ---------------------------------------------------------------------------

def init_ssd(gen, cfg: ModelConfig, n: int, device):
    """``n`` stacked SSD blocks with the projections split: ``w_z``,
    ``w_x`` (di, D), ``w_B``, ``w_C`` (G·N, D), ``w_dt`` (nh, D) and
    ``w_out`` (D, di); the depthwise causal convs ``conv_x`` (W, di),
    ``conv_B`` and ``conv_C`` (W, G·N) in bf16; f32 ``A_log`` = log U(1, 16),
    ``Dskip`` ones and ``dt_bias`` = softplus⁻¹ U(1e-3, 0.1), each (nh,);
    the gated RMSNorm ``norm`` (di,)."""
    s, D = cfg.ssm, cfg.d_model
    di = s.expand * D
    nh, gn = di // s.head_dim, s.n_groups * s.d_state

    def conv(width):
        return (torch.randn((n, s.conv_width, width), generator=gen,
                            device=device) * 0.1).to(DTYPE)

    def uniform(lo, hi):
        return torch.rand((n, nh), generator=gen, device=device) \
            * (hi - lo) + lo
    return {"w_z": init_linear(gen, n, di, D, device),
            "w_x": init_linear(gen, n, di, D, device),
            "w_B": init_linear(gen, n, gn, D, device),
            "w_C": init_linear(gen, n, gn, D, device),
            "w_dt": init_linear(gen, n, nh, D, device),
            "conv_x": conv(di), "conv_B": conv(gn), "conv_C": conv(gn),
            "A_log": torch.log(uniform(1.0, 16.0)),
            "Dskip": torch.ones((n, nh), dtype=torch.float32, device=device),
            "dt_bias": torch.log(torch.expm1(uniform(1e-3, 0.1))),
            "norm": init_norm(di, "rms", n, device),
            "w_out": init_linear(gen, n, D, di, device)}


def _ssd_heads(cfg: ModelConfig, p, pctx):
    """(the rank's heads, their groups or None): the local head count is
    read from the rank's ``A_log`` (no config field holds it,
    ``parallel/rules.py:local_cfg``); local head j of rank r is global head
    r·nh/n + j, of group (r·nh/n + j) // (nh/G).  None where the rank holds
    every head (the scan repeats the G groups itself)."""
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    nl = p["A_log"].shape[-1]
    if nl == nh:
        return nl, None
    r = pctx.rank
    heads = torch.arange(r * nl, (r + 1) * nl, device=p["A_log"].device)
    return nl, heads // (nh // s.n_groups)


def _ssd_split(p, x, stats, prefix: str, kcfg=None, pctx=None):
    """The five input projections z, x, B, C, dt of x (B,S,D); statistics
    are tapped once, on ``w_x`` (the other four share its input and its
    statistics, ``quant/api.py:STAT_ALIAS``).  ``pctx``: z and x are the
    rank's heads (row slices); B, C and dt are whole on every rank, and dt
    is cut to the rank's heads.  So every rank reads B, C and dt for its
    own heads only: ``x`` enters the block once, before all five (in
    training its cotangent is summed over the model axis there), and the
    gradients of ``w_B``, ``w_C``, ``w_dt`` and of the B and C convs are
    partial sums (``parallel/rules.py:partial_grad``)."""
    x = enter(x, pctx)
    z = linear(x, p["w_z"], None, kcfg=kcfg, pctx=pctx, tp="row")
    xr = linear(x, p["w_x"], stats, prefix + "w_x", kcfg, pctx=pctx,
                tp="row")
    Br = linear(x, p["w_B"], None, kcfg=kcfg)
    Cr = linear(x, p["w_C"], None, kcfg=kcfg)
    dt = linear(x, p["w_dt"], None, kcfg=kcfg)
    nl = p["A_log"].shape[-1]
    if dt.shape[-1] != nl:
        dt = dt[..., pctx.rank * nl:(pctx.rank + 1) * nl]
    return z, xr, Br, Cr, dt


def _segsum(a):
    """a (..., Q) log decays → (..., Q, Q): entry (i, j) the sum of
    a[j+1..i] for i ≥ j, −inf above the diagonal."""
    Q = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    ii = torch.arange(Q, device=a.device)
    return torch.where(ii[:, None] >= ii[None, :], diff,
                       torch.full_like(diff, float("-inf")))


def ssd_scan(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD (Mamba2's algorithm 1) in f32.  xh (B,S,H,P), dt
    (B,S,H), A (H,), Bm/Cm (B,S,G,N), S a multiple of min(chunk, S); h0
    (B,H,P,N) the state carried in, or None (zeros) → y (B,S,H,P), the last
    state (B,H,P,N).  Within a chunk the quadratic (attention-like) form;
    across chunks the recurrence over chunk states, the reference's
    ``associative_scan`` with its combine as a doubling scan
    (:func:`_linear_scan`), so a prefill graph has no loop that depends on
    data."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nc, rep = S // Q, H // G
    xc = (xh.float() * dt[..., None]).reshape(Bsz, nc, Q, H, P)
    lc = (-A[None, None] * dt).reshape(Bsz, nc, Q, H)      # log decays
    Bc = Bm.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Cc = Cm.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(lc, dim=2)                           # (B,nc,Q,H)
    L = torch.exp(_segsum(lc.transpose(2, 3)))              # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xc)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn", Bc * decay_states[..., None],
                          xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    if h0 is not None:
        states = torch.cat([states[:, :1] + chunk_decay[:, :1, :, None, None]
                            * h0[:, None], states[:, 1:]], dim=1)
    run = _linear_scan(chunk_decay[..., None, None], states)
    h_last = run[:, -1]                                     # (B,H,P,N)
    first = torch.zeros_like(run[:, :1]) if h0 is None else h0[:, None]
    prev = torch.cat([first, run[:, :-1]], dim=1)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Cc * torch.exp(cum)[..., None],
                         prev)
    return (y_diag + y_off).reshape(Bsz, S, H, P), h_last


def _ssd_gate(p, y, z, x_dtype, pctx=None):
    """The gated RMSNorm and its input: rmsnorm(y) · silu(z).  The norm
    spans the whole inner width di; under ``pctx`` a rank holds di/n of y,
    so the mean square of its channels is all-reduced over the model axis
    and divided by n (one small collective per SSD layer; exact at one
    rank).  Every rank's channels read that whole mean square, so it
    enters the split block there (in training its cotangent is summed
    over the model axis, where the all-reduce's own backward is the
    identity)."""
    gate = ACT["silu"](z.float()).to(x_dtype)
    y = y.to(x_dtype)
    ms = None
    if pctx is not None and pctx.mesh is not None:
        from repro_torch.parallel import comm
        yf = y.float()
        ms = enter(comm.all_reduce((yf * yf).mean(dim=-1, keepdim=True),
                                   pctx), pctx) / pctx.world
    return rmsnorm(y, p["norm"]["gamma"], ms=ms) * gate


def ssd_apply(cfg: ModelConfig, p, x, stats, prefix: str, *, state=None,
              return_state: bool = False, kcfg=None, pctx=None):
    """Sequence-mode SSD block, x (B,S,D) → y (B,S,D) [, state]: the five
    projections, the three causal convs (over ``state``'s conv histories,
    zeros without one), SiLU, :func:`ssd_scan` from ``state['h']`` (zeros
    without one), the D skip, the gated norm and ``w_out``.  A length past
    one chunk that is no multiple of it is padded with dt = 0 steps (decay
    1, contribution 0: the state passes through them).  ``return_state``
    adds {'h' (B,nh,P,N) f32, 'conv_x', 'conv_B', 'conv_C' (B,W-1,·)}.
    ``pctx``: the rank's heads (:func:`_ssd_split`, :func:`_ssd_heads`),
    the gated norm's Σy² all-reduced (:func:`_ssd_gate`), ``w_out``
    column-split and all-reduced."""
    s = cfg.ssm
    B, Sq = x.shape[:2]
    nh, groups = _ssd_heads(cfg, p, pctx)
    z, xr, Br, Cr, dt = _ssd_split(p, x, stats, prefix, kcfg, pctx)
    st = state or {}
    xc, cs_x = _causal_conv(xr, p["conv_x"], st.get("conv_x"))
    Bc, cs_B = _causal_conv(Br, p["conv_B"], st.get("conv_B"))
    Cc, cs_C = _causal_conv(Cr, p["conv_C"], st.get("conv_C"))
    silu = ACT["silu"]
    xi = silu(xc.float()).reshape(B, Sq, nh, s.head_dim)
    Bm = silu(Bc.float()).reshape(B, Sq, s.n_groups, s.d_state)
    Cm = silu(Cc.float()).reshape(B, Sq, s.n_groups, s.d_state)
    if groups is not None:                  # one group row per local head
        Bm, Cm = Bm[:, :, groups], Cm[:, :, groups]
    dtv = torch.nn.functional.softplus(dt.float() + p["dt_bias"].float())
    A = torch.exp(p["A_log"].float())
    padn = (-Sq) % min(s.chunk, max(Sq, 1))
    pad = lambda t: torch.nn.functional.pad(  # noqa: E731
        t, (0, 0) * (t.dim() - 2) + (0, padn))
    y, h_last = ssd_scan(pad(xi), pad(dtv), A, pad(Bm), pad(Cm), s.chunk,
                         st.get("h"))
    y = y[:, :Sq] + p["Dskip"].float()[None, None, :, None] * xi
    y = _ssd_gate(p, y.reshape(B, Sq, -1), z, x.dtype, pctx)
    out = linear(y, p["w_out"], stats, prefix + "w_out", kcfg, pctx=pctx,
                 tp="col")
    if return_state:
        return out, {"h": h_last, "conv_x": cs_x, "conv_B": cs_B,
                     "conv_C": cs_C}
    return out


def ssd_init_state(cfg: ModelConfig, batch: int, device="cuda"):
    """One SSD layer's decode state: 'h' (B,nh,P,N) f32 and the conv
    histories 'conv_x' (B,W-1,di), 'conv_B', 'conv_C' (B,W-1,G·N) bf16."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh, gn, w = di // s.head_dim, s.n_groups * s.d_state, s.conv_width - 1
    z = lambda *shape, dt=DTYPE: torch.zeros(  # noqa: E731
        (batch, *shape), dtype=dt, device=device)
    return {"h": z(nh, s.head_dim, s.d_state, dt=torch.float32),
            "conv_x": z(w, di), "conv_B": z(w, gn), "conv_C": z(w, gn)}


def ssd_decode(cfg: ModelConfig, p, x, state, *, kcfg=None, pctx=None):
    """One token x (B,1,D) through the block: h ← e^{−A·dt}·h + dt·B⊗x,
    y = C·h + D·x.  The new h and the three conv histories are copied
    into ``state``'s tensors in place, as :func:`rec_decode` does (a
    decode graph reads the state at fixed addresses).  ``pctx``: as
    :func:`ssd_apply`, on the rank's heads of ``h`` and ``conv_x``."""
    s = cfg.ssm
    B = x.shape[0]
    nh, groups = _ssd_heads(cfg, p, pctx)
    z, xr, Br, Cr, dt = _ssd_split(p, x, None, "", kcfg, pctx)
    xc, cs_x = _causal_conv(xr, p["conv_x"], state["conv_x"])
    Bc, cs_B = _causal_conv(Br, p["conv_B"], state["conv_B"])
    Cc, cs_C = _causal_conv(Cr, p["conv_C"], state["conv_C"])
    silu = ACT["silu"]
    xi = silu(xc.float())[:, 0].reshape(B, nh, s.head_dim)
    Bm = silu(Bc.float())[:, 0].reshape(B, s.n_groups, s.d_state)
    Cm = silu(Cc.float())[:, 0].reshape(B, s.n_groups, s.d_state)
    if groups is None:                                      # (B,H,N)
        rep = nh // s.n_groups
        Bm, Cm = (t.repeat_interleave(rep, dim=1) for t in (Bm, Cm))
    else:
        Bm, Cm = Bm[:, groups], Cm[:, groups]
    dtv = torch.nn.functional.softplus(dt.float()[:, 0]
                                       + p["dt_bias"].float())   # (B,H)
    decay = torch.exp(-torch.exp(p["A_log"].float()) * dtv)
    h = state["h"] * decay[..., None, None] \
        + torch.einsum("bh,bhp,bhn->bhpn", dtv, xi, Bm)
    y = torch.einsum("bhpn,bhn->bhp", h, Cm) \
        + p["Dskip"].float()[None, :, None] * xi
    y = _ssd_gate(p, y.reshape(B, 1, -1), z, x.dtype, pctx)
    out = linear(y, p["w_out"], kcfg=kcfg, pctx=pctx, tp="col")
    for k, v in (("h", h), ("conv_x", cs_x), ("conv_B", cs_B),
                 ("conv_C", cs_C)):
        state[k].copy_(v)
    return out, state


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention (compressed KV cache)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, n: int, device):
    """``n`` stacked MLA blocks: ``wq`` (H·(nope+rope), D), ``wkv_a``
    (r+rope, D) — the latent and the shared rope key —, its RMSNorm
    ``kv_norm`` (r,), ``wkv_b`` (H·(nope+v), r) and ``wo`` (D, H·v)."""
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {"wq": init_linear(gen, n, H * qd, D, device),
            "wkv_a": init_linear(gen, n, m.kv_lora_rank + m.qk_rope_dim, D,
                                 device),
            "kv_norm": init_norm(m.kv_lora_rank, "rms", n, device),
            "wkv_b": init_linear(gen, n, H * (m.qk_nope_dim + m.v_head_dim),
                                 m.kv_lora_rank, device),
            "wo": init_linear(gen, n, D, H * m.v_head_dim, device)}


def _mla_expand(cfg: ModelConfig, p, latent, stats=None, prefix: str = "",
                kcfg=None, pctx=None):
    """latent (B,S,r) → k_nope (B,H,S,nope), v (B,H,S,vd) through
    ``wkv_b``; under ``pctx`` the rank's H/n heads (its rows of
    ``wkv_b``), so each rank expands only its heads."""
    m, H = cfg.mla, cfg.n_heads
    kv = linear(latent, p["wkv_b"], stats, prefix + "wkv_b", kcfg,
                pctx=pctx, tp="row")
    B, S = kv.shape[0], kv.shape[1]
    kv = kv.reshape(B, S, H, m.qk_nope_dim + m.v_head_dim).transpose(1, 2)
    return kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]


def _mla_q(cfg: ModelConfig, p, x, stats, prefix, kcfg, pctx=None):
    """q (B,H,S,nope+rope) split into its nope and rope parts, and
    ``wkv_a``'s output (B,S,r+rope) (it shares x with ``wq``: one tap).
    ``pctx``: the rank's q heads; ``wkv_a`` is whole on every rank (the
    latent and the rope key are shared by every head; :func:`_mla_kv`)."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    qd = m.qk_nope_dim + m.qk_rope_dim
    q = linear(x, p["wq"], stats, prefix + "wq", kcfg, pctx=pctx,
               tp="row").reshape(
        B, -1, H, qd).transpose(1, 2)
    a = linear(x, p["wkv_a"], None, kcfg=kcfg)
    return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:], a


def _mla_kv(cfg: ModelConfig, p, a, pctx=None):
    """``wkv_a``'s output (B,S,r+rope) → the normed latent (B,S,r) and the
    rope key (B,S,rope), before RoPE.  Under ``pctx`` the rank's heads read
    the whole rope key, so it enters the split block here (in training
    its cotangent is summed over the model axis).  The latent needs no
    entry of its own: it enters through ``wkv_b``'s row linear, so its
    cotangent is already whole on every rank (an entry on all of ``a``
    would sum it n times)."""
    r = cfg.mla.kv_lora_rank
    return (rmsnorm(a[..., :r], p["kv_norm"]["gamma"]),
            enter(a[..., r:], pctx))


def mla_apply(cfg: ModelConfig, p, x, stats, prefix: str, *, pos0: int = 0,
              return_cache: bool = False, kcfg=None, pctx=None):
    """Sequence-mode MLA, x (B,S,D) at positions pos0..: the latent is
    expanded to per-head k_nope and v, the rope key is shared by every
    head, and attention scales by (nope+rope)^-1/2.  ``return_cache`` adds
    {'latent' (B,S,r), 'k_rope' (B,S,rope)}, whole on every rank.
    ``pctx``: head-parallel (``cfg`` counts the rank's heads; ``wo``
    column-split and all-reduced)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q_nope, q_rope, a = _mla_q(cfg, p, x, stats, prefix, kcfg, pctx)
    latent, k_rope = _mla_kv(cfg, p, a, pctx)
    k_rope = k_rope[:, None]                           # (B,1,S,rope)
    pos = torch.arange(S, device=x.device) + pos0
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope, pos, cfg.rope_theta)
    k_nope, v = _mla_expand(cfg, p, latent, stats, prefix, kcfg, pctx)
    k = torch.cat([k_nope, k_rope.expand(B, H, S, m.qk_rope_dim)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    o = attention(qf, k, v, causal=True,
                  scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5)
    y = linear(o.transpose(1, 2).reshape(B, S, -1), p["wo"], stats,
               prefix + "wo", kcfg, pctx=pctx, tp="col")
    if return_cache:
        return y, {"latent": latent, "k_rope": k_rope[:, 0]}
    return y


def mla_init_state(cfg: ModelConfig, batch: int, max_len: int,
                   device="cuda"):
    """The compressed cache: 'latent' (B, max_len, r) and 'k_rope' (B,
    max_len, rope), bf16, no head axis."""
    m = cfg.mla
    return {"latent": torch.zeros((batch, max_len, m.kv_lora_rank),
                                  dtype=DTYPE, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim),
                                  dtype=DTYPE, device=device)}


def mla_decode(cfg: ModelConfig, p, x, state, pos, *, kcfg=None, pctx=None):
    """One token x (B,1,D) at per-slot positions pos (B,): its latent and
    rope key are written into the caches in place, then the whole latent
    cache is expanded through ``wkv_b`` (the reference's math: B·max_len
    rows every step) and read by plain decode attention.  ``pctx``: as
    :func:`mla_apply`; every rank writes the whole caches and expands
    them to its heads only."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    q_nope, q_rope, a = _mla_q(cfg, p, x, None, "", kcfg, pctx)
    latent_t, k_rope_t = _mla_kv(cfg, p, a, pctx)
    q_rope = rope_decode(q_rope, pos, cfg.rope_theta)
    k_rope_t = rope_decode(k_rope_t[:, None], pos, cfg.rope_theta)[:, 0]
    latent = seq_update_batched(state["latent"], latent_t, pos)
    k_rope = seq_update_batched(state["k_rope"], k_rope_t, pos)
    k_nope, v = _mla_expand(cfg, p, latent, kcfg=kcfg, pctx=pctx)
    k = torch.cat([k_nope, k_rope[:, None].expand(B, H, k_rope.shape[1],
                                                  m.qk_rope_dim)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    o = decode_attention(qf, k, v, pos,
                         scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5)
    y = linear(o.reshape(B, 1, -1), p["wo"], kcfg=kcfg, pctx=pctx, tp="col")
    return y, state


# ---------------------------------------------------------------------------
# MoE MLP — dense compute: every expert computes every token
# ---------------------------------------------------------------------------

def init_moe(gen, cfg: ModelConfig, n: int, device):
    """``n`` stacked MoE MLPs: the f32 ``router`` (E, D), the ``experts``'
    GLU stacks wg/wu (n, E, F, D) and wd (n, E, D, F), and a ``shared``
    GLU expert of hidden F·n_shared where the config has one."""
    e, D = cfg.moe, cfg.d_model
    E, F = e.n_experts, e.d_ff_expert

    def stack(d_out, d_in):
        return init_linear(gen, n * E, d_out, d_in, device).reshape(
            n, E, d_out, d_in)
    p = {"router": init_linear(gen, n, E, D, device, dtype=torch.float32),
         "experts": {"wg": stack(F, D), "wu": stack(F, D),
                     "wd": stack(D, F)}}
    if e.n_shared:
        Fs = F * e.n_shared
        p["shared"] = {"wg": init_linear(gen, n, Fs, D, device),
                       "wu": init_linear(gen, n, Fs, D, device),
                       "wd": init_linear(gen, n, D, Fs, device)}
    return p


def _router(cfg: ModelConfig, p, x2, stats, prefix: str):
    """f32 router logits → softmax → top-k, the k weights renormalised to
    sum 1.  (T, k) weights and expert indices, on the device."""
    logits = linear(x2.float(), p["router"], stats, prefix + "router")
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i


def _expert_mm(h, w, kcfg=None):
    """Per-expert product h (E,C,D) — or (C,D), the same tokens for every
    expert — × w (E,F,D) → (E,C,F).  A quantized stack goes through
    ``ttq_matmul`` with its expert axis (one batched ``ttq_gemm`` launch on
    the kernel path); a full-precision one is a bf16 batched product."""
    from repro_torch.core.ttq import QuantizedTensor, ttq_matmul
    if isinstance(w, QuantizedTensor):
        return ttq_matmul(h, w, kcfg=kcfg).to(h.dtype)
    return torch.matmul(h, w.to(h.dtype).transpose(-1, -2))


def _expert_glu(w, h, act, stats=None, prefix: str = "", wts=None,
                kcfg=None):
    """The experts' GLU over the tokens h: (C,D) shared by every expert, or
    (E,C,D), each expert its own.  The stats taps ``experts.wg`` (E,D) and
    ``experts.wd`` (E,F) weight each token by ``wts`` (E,C), its routing
    mass, so tokens an expert does not take leave its diagonal alone;
    without ``wts`` every token counts once (the all-to-all path's
    count)."""
    g = _expert_mm(h, w["wg"], kcfg)
    u = _expert_mm(h, w["wu"], kcfg)
    a = ACT[act](g.float()).to(h.dtype) * u
    if stats is not None:
        hf, af = h.float(), a.float()
        wt = (torch.ones(a.shape[:2], dtype=torch.float32, device=h.device)
              if wts is None else wts)
        sg = wt @ (hf * hf) if h.dim() == 2 else \
            torch.einsum("ec,ecd->ed", wt, hf * hf)
        sd = torch.einsum("ec,ecf->ef", wt, af * af)
        for k, v in (("experts.wg", sg), ("experts.wd", sd)):
            stats[prefix + k] = stats[prefix + k] + v \
                if prefix + k in stats else v
    return _expert_mm(a, w["wd"], kcfg)


def _n_experts(w) -> int:
    """The experts an expert stack holds (the rank's, under expert
    parallelism: no config field holds it)."""
    from repro_torch.core.ttq import QuantizedTensor
    return (w.scale if isinstance(w, QuantizedTensor) else w).shape[0]


def moe_apply_dense(cfg: ModelConfig, p, x, stats, prefix: str, kcfg=None,
                    pctx=None):
    """Exact MoE, x (B,S,D): every expert computes every token and the
    gates (a (T, E) scatter of the top-k weights) combine them.  The
    tokens reach the experts as one (T, D) operand, never an (E, T, D)
    copy; top-k and the scatter stay on the device, so a decode block is
    one graph replay.  The shared expert is added by the caller.
    ``pctx`` (``moe_impl="dense"``): the router is whole on every rank,
    each rank runs its E/n experts over every token with its experts' gate
    columns, and the f32 partial sums are all-reduced, then rounded once;
    the statistics stay gate-weighted, each rank holding its experts'
    rows.  Every rank reads the whole tokens and the whole router for its
    experts' share only: the tokens enter the split block before both (in
    training their cotangent is summed over the model axis), and the
    router's gradient is a partial sum (``parallel/rules.py:
    partial_grad``)."""
    e = cfg.moe
    B, S, D = x.shape
    x2 = enter(x.reshape(-1, D), pctx)
    top_p, top_i = _router(cfg, p, x2, stats, prefix)
    gate = torch.zeros((x2.shape[0], e.n_experts), dtype=torch.float32,
                       device=x.device).scatter_add_(1, top_i, top_p)
    if pctx is not None and pctx.mesh is not None:
        El = _n_experts(p["experts"]["wg"])
        gate = gate[:, pctx.rank * El:(pctx.rank + 1) * El]
    y_all = _expert_glu(p["experts"], x2, cfg.act, stats, prefix,
                        wts=gate.T, kcfg=kcfg)
    y = torch.einsum("etd,te->td", y_all.float(), gate)
    if pctx is not None and pctx.mesh is not None:
        from repro_torch.parallel import comm
        y = comm.all_reduce(y, pctx)
    return y.to(x.dtype).reshape(B, S, D)


def moe_capacity(cfg: ModelConfig, tokens: int, world: int) -> tuple:
    """(Tc, C) of :func:`moe_apply_a2a`: each rank's chunk of the
    ``tokens`` and the slots per (rank, expert), max(1, ⌊Tc·k/E·cf⌋)
    (the reference's ``layers.py:925``): static, from the shapes."""
    e = cfg.moe
    Tc = -(-tokens // world)
    return Tc, max(1, int(Tc * e.top_k / e.n_experts * e.capacity_factor))


def a2a_slots(top_i, n_experts: int, C: int) -> tuple:
    """(slot, valid) of each of a chunk's (T·k,) assignments: its place
    among its expert's assignments in token order (the reference's
    one-hot cumsum), and whether it fits the expert's C slots."""
    flat_e = top_i.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(
        n_experts, device=flat_e.device)).long()   # no range check: no sync
    slot = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    return slot, slot < C


def moe_apply_a2a(cfg: ModelConfig, p, x, stats, prefix: str, *, pctx,
                  kcfg=None):
    """Expert-parallel MoE with token dispatch (``moe_impl="a2a"``, the
    reference's ``moe_apply_a2a``), x (B,S,D) whole on every rank, the
    rank's E/n experts.  The T tokens (padded to n·Tc) are cut into n
    chunks of Tc; rank r routes chunk r, writes each assignment into slot
    ``slot`` of its expert's C slots (the assignment's place among that
    expert's in the chunk, in order; one past C is dropped and adds
    nothing), and an all-to-all carries each expert's slots to the rank
    that owns it.  The rank runs its experts over the (E/n, n·C) slots it
    received (one ``ttq_gemm_experts`` launch per projection), a second
    all-to-all returns the results, each assignment's result is weighted
    by its renormalised gate, and an all-gather of the chunks rebuilds
    (T, D).  Everything is on the device at shapes fixed by (T, k, E,
    cf), so a decode block stays one graph replay.  Statistics count each
    slot once (unweighted, as the reference's); the rank keeps its
    experts' rows, where the reference all-gathers them to every rank.
    A rank routes its own chunk only, so the tokens enter the split block
    before they are cut (in training their cotangent, non-zero in the
    rank's chunk, is summed over the model axis), and the router's
    gradient is a partial sum (``parallel/rules.py:partial_grad``)."""
    e = cfg.moe
    from repro_torch.parallel import comm
    n, r = pctx.world, pctx.rank
    B, S, D = x.shape
    x2 = enter(x.reshape(-1, D), pctx)
    T = x2.shape[0]
    Tc, C = moe_capacity(cfg, T, n)
    if Tc * n != T:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, Tc * n - T))
    xm = x2[r * Tc:(r + 1) * Tc]
    top_p, top_i = _router(cfg, p, xm, None, prefix)          # (Tc, k)
    k, E = e.top_k, e.n_experts
    El = E // n
    flat_e = top_i.reshape(-1)                                 # (Tc·k,)
    slot, valid = a2a_slots(top_i, E, C)
    dump = n * El * C                  # a dropped assignment's row
    idx = torch.where(valid, flat_e * C + slot, torch.full_like(slot, dump))
    send = torch.zeros((dump + 1, D), dtype=x2.dtype, device=x.device)
    send.index_copy_(0, idx, xm.repeat_interleave(k, dim=0))
    recv = comm.all_to_all(send[:dump].reshape(n, El, C, D), pctx)
    h = recv.transpose(0, 1).reshape(El, n * C, D)
    y_exp = _expert_glu(p["experts"], h, cfg.act, stats, prefix, kcfg=kcfg)
    back = y_exp.reshape(El, n, C, D).transpose(0, 1)
    y_flat = comm.all_to_all(back, pctx).reshape(dump, D)
    wt = torch.where(valid, top_p.reshape(-1),
                     torch.zeros_like(top_p.reshape(-1)))
    contrib = y_flat[idx.clamp(max=dump - 1)] * wt[:, None].to(x2.dtype)
    # each token's k results summed in f32 in a fixed order (no atomics:
    # a replay is bit for bit its eager run), then rounded once
    y_m = contrib.reshape(Tc, k, D).float().sum(dim=1).to(x2.dtype)
    y = comm.all_gather(y_m, pctx, dim=0)[:T]
    return y.reshape(B, S, D).to(x.dtype)


def moe_a2a(cfg: ModelConfig, p, x, stats_on: bool, prefix: str, pctx,
            kcfg=None):
    """The reference's entry to the all-to-all MoE (its ``shard_map``
    wrapper): :func:`moe_apply_a2a` on the rank's experts, returning (y,
    statistics) with the statistics whole on every rank, as the
    reference's are (each rank's experts' rows all-gathered; empty
    without ``stats_on``).  The layer stack calls :func:`moe_apply_a2a`
    itself and keeps the rank's rows."""
    st = {} if stats_on else None
    y = moe_apply_a2a(cfg, p, x, st, prefix, pctx=pctx, kcfg=kcfg)
    if not stats_on:
        return y, {}
    from repro_torch.parallel import comm
    return y, {k: comm.all_gather(v, pctx, dim=0) for k, v in st.items()}
