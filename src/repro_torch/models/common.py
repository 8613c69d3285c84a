"""Shared model blocks — linear with the stats tap, norms, RoPE, attention,
the GLU and plain MLPs, sampling.  Plain PyTorch; the reference's layouts
and dtypes.

* Linear weights are (out_features, in_features); :func:`linear` dispatches
  on plain tensors vs ``QuantizedTensor`` and optionally taps the TTQ
  statistic Σ_t x_t² per input feature.
* Activations are bf16; norms, softmax and RoPE run in f32.
* ``stats`` is a flat dict {projection_name: (d_in,) f32}.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.ttq import QuantizedTensor, ttq_matmul

NEG_INF = -1e30

ACT = {"silu": F.silu,
       "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
       "relu": F.relu}


def linear(x: torch.Tensor, w, stats: Optional[dict] = None, name: str = "",
           kcfg=None, pctx=None, tp=None) -> torch.Tensor:
    """y = x @ wᵀ (w: (out,in) tensor or QuantizedTensor); taps Σx² into
    ``stats[name]`` when a stats dict is given.  ``kcfg`` selects the
    ``ttq_gemm`` kernel for packed QuantizedTensors.  ``pctx``/``tp``
    ('row'|'col'): w is the rank's slice under tensor parallelism; a
    'col' slice reads the rank's slice of the input (so the Σx² tap sees
    the features its weight slice needs) and its partial sums are
    all-reduced over the model axis; a 'row' slice reads the whole ``x``,
    which enters the split block there (``comm.enter``: in training, its
    cotangent is all-reduced over the model axis)."""
    if tp == "row":
        x = enter(x, pctx)
    if stats is not None:
        xf = x.float()
        s = (xf * xf).sum(dim=tuple(range(x.dim() - 1)))
        stats[name] = stats[name] + s if name in stats else s
    if isinstance(w, QuantizedTensor):
        return ttq_matmul(x, w, kcfg=kcfg, pctx=pctx, tp=tp).to(x.dtype)
    if tp != "col" or pctx is None or pctx.mesh is None:
        return x @ w.to(x.dtype).T
    from repro_torch.parallel import comm
    if pctx.world == 1:                 # the identity, on the same bits
        return comm.all_reduce(x @ w.to(x.dtype).T, pctx)
    # f32 partial sums, summed, then rounded once, as world 1 rounds once
    return comm.all_reduce(x.float() @ w.float().T, pctx).to(x.dtype)


def enter(x: torch.Tensor, pctx) -> torch.Tensor:
    """``x`` entering a block split over ``pctx``'s model axis
    (``parallel.comm.enter``: in training its cotangent is all-reduced
    there); ``x`` itself without a mesh."""
    if pctx is None or pctx.mesh is None:
        return x
    from repro_torch.parallel import comm
    return comm.enter(x, pctx)


def init_linear(gen, d_out: int, d_in: int, dtype=torch.bfloat16,
                scale: float | None = None, device="cpu") -> torch.Tensor:
    """One (d_out, d_in) weight ~ N(0, scale²), scale 1/√d_in by default
    (the stacked init of a layer stack is ``layers.init_linear``)."""
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn((d_out, d_in), generator=gen, device=device)
            * scale).to(dtype)


def init_glu_mlp(gen, d: int, d_ff: int, dtype=torch.bfloat16,
                 device="cpu") -> dict:
    return {"wg": init_linear(gen, d_ff, d, dtype, device=device),
            "wu": init_linear(gen, d_ff, d, dtype, device=device),
            "wd": init_linear(gen, d, d_ff, dtype, device=device)}


def init_plain_mlp(gen, d: int, d_ff: int, dtype=torch.bfloat16,
                   device="cpu") -> dict:
    return {"w1": init_linear(gen, d_ff, d, dtype, device=device),
            "w2": init_linear(gen, d, d_ff, dtype, device=device)}


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
            ms: torch.Tensor | None = None):
    """RMSNorm in the (1 + gamma) form, f32 inside; ``ms``, the f32 mean
    square over the last axis, where the caller has it (a norm whose
    width is split over ranks)."""
    xf = x.float()
    if ms is None:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
    nx = xf * torch.rsqrt(ms + eps)
    return (nx * (1.0 + gamma.float())).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5):
    """LayerNorm (gamma·x̂ + beta), f32 inside."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    nx = (xf - mu) * torch.rsqrt(var + eps)
    return (nx * gamma.float() + beta.float()).to(x.dtype)


def norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """LayerNorm where the parameters hold ``beta``, else RMSNorm."""
    if "beta" in p:
        return layernorm(x, p["gamma"], p["beta"])
    return rmsnorm(x, p["gamma"])


def init_norm(d: int, kind: str, n: int | None = None, device="cpu") -> dict:
    """Norm parameters (``n`` stacked layers, or one): RMSNorm gamma zeros
    (the 1 + gamma form); LayerNorm gamma ones and beta zeros."""
    shape = (d,) if n is None else (n, d)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    if kind == "rms":
        return {"gamma": z()}
    return {"gamma": torch.ones(shape, dtype=torch.float32, device=device),
            "beta": z()}


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    dh = x.shape[-1]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., : dh // 2], xf[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0):
    """x (..., S, Dh); pos (S,) absolute positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, pos[..., :, None].float() * freqs)


def rope_decode(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0):
    """Single-token RoPE with per-batch positions. x (B,H,1,Dh), pos (B,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, pos.float()[:, None, None, None] * freqs)


def rope_window(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0):
    """RoPE for a window of S tokens per slot, x (B,H,S,Dh) at positions
    pos[b]..pos[b]+S-1 (pos (B,)): :func:`rope_decode` per position, so
    each angle table has decode's shape and the CPU computes each cos/sin
    the way decode does (its vector loop and scalar tail can round an
    element differently)."""
    return torch.cat([rope_decode(x[:, :, s:s + 1], pos + s, theta)
                      for s in range(x.shape[2])], dim=2)


def cache_update_batched(cache: torch.Tensor, new: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """cache (B,Hkv,Smax,D·) ← new (B,Hkv,1,D·) at per-batch row pos (B,).
    Updates ``cache`` in place (a scatter: no host sync) and returns it."""
    B, Hkv, _, Dc = new.shape
    idx = pos.long().view(B, 1, 1, 1).expand(B, Hkv, 1, Dc)
    return cache.scatter_(2, idx, new.to(cache.dtype))


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """cache (B, Hkv, Smax, Dh) ← new (B, Hkv, 1, Dh) at one sequence
    position for every row, in place; returns the cache (the decode path
    writes per-slot positions, :func:`cache_update_batched`)."""
    cache[:, :, pos:pos + 1] = new.to(cache.dtype)
    return cache


def seq_update_batched(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """cache (B,Smax,D) ← new (B,1,D) at per-batch row pos (B,), in place
    (a scatter: no host sync; a decode graph reads the cache at a fixed
    address) — MLA's latent and rope-key caches."""
    B, _, D = new.shape
    idx = pos.long().view(B, 1, 1).expand(B, 1, D)
    return cache.scatter_(1, idx, new.to(cache.dtype))


def sinusoidal_pos(n: int, d: int, device="cpu") -> torch.Tensor:
    """(n, d) bf16 sinusoidal positions, [sin | cos] of pos · 10000^(-2i/d):
    the encoder's positions over the stub front end's frames."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=device) / d))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(
        torch.bfloat16)


def _attn_mask(qi, ki, causal: bool, window: int):
    """(S, Sk) bool: key ki visible to query qi (causal: ki ≤ qi; a window
    W > 0: qi − ki < W)."""
    mask = torch.ones((qi.shape[0], ki.shape[0]), dtype=torch.bool,
                      device=qi.device)
    if causal:
        mask &= qi[:, None] >= ki[None, :]
    if window > 0:
        mask &= qi[:, None] - ki[None, :] < window
    return mask


def full_attention(q, k, v, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0, scale: float | None = None,
                   soft_cap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention.  q (B,H,S,Dh), k (B,Hkv,Sk,Dh), v
    (B,Hkv,Sk,Dv) → (B,H,S,Dv).  q is scaled (default Dh^-1/2) in f32 and
    cast to k's dtype; both products accumulate in f32 (the reference's
    preferred_element_type).  The queries sit at positions ``q_offset + i``
    of the key axis; a ``window`` W > 0 also hides keys W or more positions
    back."""
    B, H, S, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else Dh ** -0.5
    mask = _attn_mask(torch.arange(S, device=q.device) + q_offset,
                      torch.arange(Sk, device=q.device), causal, window)
    qg = (q.float() * scale).to(k.dtype).reshape(B, Hkv, G, S, Dh)
    s = torch.einsum("bhgsd,bhkd->bhgsk", qg.float(), k.float())
    if soft_cap > 0:
        s = soft_cap * torch.tanh(s / soft_cap)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgsk,bhkd->bhgsd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, S, -1).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      kv_chunk: int = 1024, scale: float | None = None,
                      soft_cap: float = 0.0) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``kv_chunk`` keys: a
    running max, denominator and f32 accumulator per query, so the live
    scores are (B,Hkv,G,S,kv_chunk) instead of (…,S,Sk).  The queries sit
    at positions 0..S-1 (prefill from the start).  :func:`full_attention`
    up to f32 rounding; the reference's scan is a loop over the chunks."""
    B, H, S, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Sk % kv_chunk:
        raise ValueError(f"Sk={Sk} must divide by kv_chunk={kv_chunk}")
    G = H // Hkv
    scale = scale if scale is not None else Dh ** -0.5
    qg = (q.float() * scale).to(k.dtype).reshape(B, Hkv, G, S, Dh).float()
    qi = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    den = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, S, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Sk, kv_chunk):
        kc = k[:, :, c0:c0 + kv_chunk]
        vc = v[:, :, c0:c0 + kv_chunk]
        mask = _attn_mask(qi, torch.arange(c0, c0 + kv_chunk,
                                           device=q.device), causal, window)
        s = torch.einsum("bhgsd,bhkd->bhgsk", qg, kc.float())
        if soft_cap > 0:
            s = soft_cap * torch.tanh(s / soft_cap)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgsk,bhkd->bhgsd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    o = acc / torch.clamp(den[..., None], min=1e-30)
    return o.reshape(B, H, S, -1).to(q.dtype)


def attention(q, k, v, *, causal=True, window: int = 0, scale=None,
              soft_cap=0.0, q_offset: int = 0, chunk_threshold: int = 8192,
              kv_chunk: int = 1024):
    """Prefill attention, plain PyTorch math (the reference leaves it to
    XLA), dispatched as the reference does: :func:`chunked_attention` when
    the queries start at 0 and there are more than ``chunk_threshold``
    keys in whole chunks of ``kv_chunk``, else :func:`full_attention`.  A
    nonzero ``q_offset`` is tail prefill over a cached prefix: the queries
    start at that position of the keys."""
    Sk = k.shape[2]
    if q_offset == 0 and Sk > chunk_threshold and Sk % kv_chunk == 0:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 kv_chunk=kv_chunk, scale=scale,
                                 soft_cap=soft_cap)
    return full_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, scale=scale, soft_cap=soft_cap)


def decode_attention(q, k_cache, v_cache, cur_pos, *, scale=None,
                     soft_cap: float = 0.0):
    """Single-token attention over a bf16 (B,Hkv,Smax,Dh) cache (values
    (B,Hkv,Smax,Dv)); rows past ``cur_pos`` masked; q scaled by ``scale``
    (default Dh^-1/2).  q (B,H,1,Dh) → (B,H,1,Dv)."""
    B, H, _, Dh = q.shape
    Hkv, Smax = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else Dh ** -0.5
    ki = torch.arange(Smax, device=q.device)
    mask = ki[None, :] <= cur_pos[:, None]
    qg = (q[:, :, 0].float() * scale).to(k_cache.dtype).reshape(B, Hkv, G, Dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float())
    if soft_cap > 0:
        s = soft_cap * torch.tanh(s / soft_cap)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, -1)[:, :, None].to(q.dtype)


def suffix_attention(q, k_cache, v_cache, pos, *, soft_cap: float = 0.0):
    """Attention for a speculated window over a bf16 (B,Hkv,Smax,Dh) cache
    whose window rows were just written (write, then read): q (B,H,S,Dh)
    holds S queries per slot at positions ``pos[b]..pos[b]+S-1``, and query
    s attends rows ≤ pos[b]+s.  Each query runs :func:`decode_attention`
    itself (same key axis, mask and dtype order), so a verify pass
    reproduces sequential decode bit for bit on the CPU.  → (B,H,S,Dh)."""
    return torch.cat([decode_attention(q[:, :, s:s + 1].contiguous(),
                                       k_cache, v_cache, pos + s,
                                       soft_cap=soft_cap)
                      for s in range(q.shape[2])], dim=2)


def glu_mlp(x, p, stats=None, prefix="mlp", act="silu", kcfg=None,
            pctx=None):
    """Gated MLP (SwiGLU/GeGLU): (act(x@Wg) * (x@Wu)) @ Wd; under ``pctx``
    wg/wu row-split and wd column-split over the hidden width (one
    block entry for both)."""
    x = enter(x, pctx)
    g = linear(x, p["wg"], stats, f"{prefix}.wg", kcfg, pctx=pctx, tp="row")
    u = linear(x, p["wu"], None, kcfg=kcfg, pctx=pctx,
               tp="row")                      # same input as wg — tap once
    h = ACT[act](g.float()).to(x.dtype) * u
    return linear(h, p["wd"], stats, f"{prefix}.wd", kcfg, pctx=pctx, tp="col")


def plain_mlp(x, p, stats=None, prefix="mlp", act="gelu", kcfg=None,
              pctx=None):
    """Plain MLP: act(x@W1) @ W2; under ``pctx`` w1 row-split, w2
    column-split."""
    h = linear(x, p["w1"], stats, f"{prefix}.w1", kcfg, pctx=pctx, tp="row")
    h = ACT[act](h.float()).to(x.dtype)
    return linear(h, p["w2"], stats, f"{prefix}.w2", kcfg, pctx=pctx, tp="col")


def vocab_logits(x: torch.Tensor, w_head, stats=None) -> torch.Tensor:
    """LM head, f32 logits (w: (V, D)); taps ``stats['lm_head']``."""
    return linear(x, w_head, stats, "lm_head").float()


def sample_logits(logits: torch.Tensor, generator=None,
                  temperature: float = 0.0) -> torch.Tensor:
    """logits (B, V) → (B,) int32; temperature 0 → greedy.  Sampling uses
    the Gumbel-max trick (a categorical draw with no host sync)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=1e-20, max=1.0 - 1e-7)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)
