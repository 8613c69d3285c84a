"""Attention layer (the ``attn`` kind) — init, sequence mode, decode.

  init_attn(gen, cfg, n, device)             → stacked param dict (n layers)
  attn_apply(cfg, p, x, stats, prefix, ...)  → prefill output [, (k, v)]
  attn_decode(cfg, p, x, state, pos, ...)    → (y, state) single token
  attn_verify(cfg, p, x, state, pos, ...)    → (y, state) a drafted window
  attn_init_state / build_kv_state           → one layer's decode cache
  build_kv_compact                           → prefill rows for the pool

Stats taps use parameter-path names (``prefix + "wq"``) so the quantizer
joins statistics to weights by path.  Decode writes the new token's k/v
into the cache in place (a scatter per slot, or per pool row when the
cache is paged): the cache is the largest decode state, and the
reference's functional update would copy it.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvquant import dequantize_kv, quantize_kv

from .common import (apply_rope, attention, cache_update_batched,
                     decode_attention, linear, rope_decode, rope_window,
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
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm families come in a later slice")
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": init_linear(gen, n, H * hd, D, device),
            "wk": init_linear(gen, n, Hkv * hd, D, device),
            "wv": init_linear(gen, n, Hkv * hd, D, device),
            "wo": init_linear(gen, n, D, H * hd, device)}


def _qkv(cfg: ModelConfig, p, x, stats, prefix: str, kcfg=None):
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(x, p["wq"], stats, prefix + "wq", kcfg).reshape(B, -1, H, hd)
    k = linear(x, p["wk"], None, kcfg=kcfg).reshape(B, -1, Hkv, hd)
    v = linear(x, p["wv"], None, kcfg=kcfg).reshape(B, -1, Hkv, hd)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attn_apply(cfg: ModelConfig, p, x, stats, prefix: str, *,
               causal: bool = True, pos0: int = 0, return_kv: bool = False,
               kv_prefix=None, kvcfg=None, kcfg=None):
    """Sequence-mode attention, x (B,S,D) at absolute positions pos0.. .
    With a quantized ``kvcfg`` the attention reads the quantize→dequantize
    of k/v: exactly the values the cache will hold and every later decode
    step will read (so a re-prefill after preemption resumes on the same
    numbers).  ``kv_prefix`` = (k, v) each (B, Hkv, P, Dh): cached context
    (post-RoPE, e.g. a shared prompt prefix gathered from the paged pool)
    in front of this call's keys; the queries then start at ``pos0 == P``.
    ``return_kv`` returns only this call's k/v."""
    q, k, v = _qkv(cfg, p, x, stats, prefix, kcfg)
    S = x.shape[1]
    if cfg.pos != "rope":
        raise NotImplementedError("non-RoPE families come in a later slice")
    pos = torch.arange(S, device=x.device) + pos0
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    kf, vf = k, v
    if kvcfg is not None and kvcfg.quantized:
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
    o = attention(q, kf, vf, causal=causal, soft_cap=cfg.attn_soft_cap,
                  q_offset=q_off)
    y = linear(o.transpose(1, 2).reshape(x.shape[0], S, -1), p["wo"], stats,
               prefix + "wo", kcfg)
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
                        soft_cap: float = 0.0):
    """The read over the paged pool: quantized pools go through the
    ``ttq_paged_decode_attention`` kernel; the bf16 pool gathers its
    block-table view and reuses the dense ``decode_attention``."""
    if kvcfg.quantized:
        from repro_torch.kernels import ops as kops
        return kops.kv_paged_decode_attention(
            q, state["k_q"], state["k_s"], state["v_q"], state["v_s"],
            block_table, cur, bits=kvcfg.bits, group_size=kvcfg.group_size,
            soft_cap=soft_cap, use_pallas=kvcfg.use_pallas)
    from repro_torch.kernels.ref import gather_paged_kv
    return decode_attention(q, gather_paged_kv(state["k"], block_table),
                            gather_paged_kv(state["v"], block_table), cur,
                            soft_cap=soft_cap)


def _kv_attention(q, state, cur, kvcfg, *, soft_cap: float = 0.0):
    """The quantized-cache read: the ``ttq_decode_attention`` kernel."""
    from repro_torch.kernels import ops as kops
    return kops.kv_decode_attention(
        q, state["k_q"], state["k_s"], state["v_q"], state["v_s"], cur,
        bits=kvcfg.bits, group_size=kvcfg.group_size, soft_cap=soft_cap,
        use_pallas=kvcfg.use_pallas)


def attn_decode(cfg: ModelConfig, p, x, state, pos, *, kvcfg=None,
                kcfg=None, block_table=None, rows=None):
    """x (B,1,D); state bf16 {'k','v'} or quantized caches (``kvcfg``
    selects), updated in place; pos (B,) int32 per-slot positions.
    ``block_table`` (B, nblk) addresses the paged pool layout, and
    ``rows`` (:func:`paged_rows`) are the pool rows this token writes."""
    q, k, v = _qkv(cfg, p, x, None, "", kcfg)
    q = rope_decode(q, pos, cfg.rope_theta)
    k = rope_decode(k, pos, cfg.rope_theta)
    if kvcfg is not None and kvcfg.paged:
        st = _kv_append_paged(state, k, v, rows, kvcfg)
        o = _kv_attention_paged(q, st, block_table, pos, kvcfg,
                                soft_cap=cfg.attn_soft_cap)
    elif kvcfg is not None and kvcfg.quantized:
        st = _kv_append(state, k, v, pos, kvcfg)
        o = _kv_attention(q, st, pos, kvcfg, soft_cap=cfg.attn_soft_cap)
    else:
        cache_update_batched(state["k"], k, pos)
        cache_update_batched(state["v"], v, pos)
        st = state
        o = decode_attention(q, st["k"], st["v"], pos,
                             soft_cap=cfg.attn_soft_cap)
    y = linear(o.reshape(x.shape[0], 1, -1), p["wo"], kcfg=kcfg)
    return y, st


def attn_verify(cfg: ModelConfig, p, x, state, pos, *, kvcfg=None, kcfg=None,
                block_table=None, rows=None):
    """Score a drafted window at once: x (B,S,D) are the window's tokens at
    positions pos[b]..pos[b]+S-1 (pos (B,)).  The window's k/v rows are
    written first, at the cache's storage dtype, over whatever the draft
    pass stored there; then the suffix read runs over the updated cache.
    Write then read keeps the key axis of sequential decode, so rejected
    drafts roll back by rewinding positions.  ``rows``
    (:func:`paged_window_rows`) are the pool rows of a paged cache.
    Returns (y (B,S,D), state)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, None, "", kcfg)
    q = rope_window(q, pos, cfg.rope_theta)
    k = rope_window(k, pos, cfg.rope_theta)
    cap = cfg.attn_soft_cap
    if kvcfg is not None and kvcfg.paged:
        st = _kv_append_paged(state, k, v, rows, kvcfg)
        if kvcfg.quantized:
            from repro_torch.kernels import ops as kops
            o = kops.kv_paged_suffix_attention(
                q, st["k_q"], st["k_s"], st["v_q"], st["v_s"], block_table,
                pos, bits=kvcfg.bits, group_size=kvcfg.group_size,
                soft_cap=cap, use_pallas=kvcfg.use_pallas)
        else:
            from repro_torch.kernels.ref import gather_paged_kv
            o = suffix_attention(q, gather_paged_kv(st["k"], block_table),
                                 gather_paged_kv(st["v"], block_table), pos,
                                 soft_cap=cap)
    elif kvcfg is not None and kvcfg.quantized:
        from repro_torch.kernels import ops as kops
        st = _kv_append_rows(state, k, v, pos, kvcfg)
        o = kops.kv_suffix_attention(
            q, st["k_q"], st["k_s"], st["v_q"], st["v_s"], pos,
            bits=kvcfg.bits, group_size=kvcfg.group_size, soft_cap=cap,
            use_pallas=kvcfg.use_pallas)
    else:
        _kv_write_rows(state["k"], k, pos)
        _kv_write_rows(state["v"], v, pos)
        st = state
        o = suffix_attention(q, st["k"], st["v"], pos, soft_cap=cap)
    y = linear(o.transpose(1, 2).reshape(B, S, -1), p["wo"], kcfg=kcfg)
    return y, st
