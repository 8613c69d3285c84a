"""Plain PyTorch versions of the kernels on the serving path (the four
Pallas kernels' and the expert-batched GEMM's).

Each repeats its kernel's arithmetic in f32 with PyTorch ops.  The kernel
wrappers use them for CPU tensors; the tests and ``chip_smoke.py`` hold
the kernels against them.  The verify read of a speculated window
(:func:`kv_suffix_attn_ref`, :func:`kv_paged_suffix_attn_ref`) has no
kernel, in the reference as here: it is plain on every device.

On the CPU a row of an f32 product must not depend on the rows beside it,
so that a verify window (slots·(W+1) rows) reproduces sequential decode
(slots rows) bit for bit, as in the reference: :func:`row_matmul` takes
the rows one at a time there, and the suffix reads run each query through
the single-query math of :func:`kv_attn_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvquant import dequantize_kv
from repro_torch.core.qdq import pack_bits, unpack_bits

NEG_INF = -1e30


def row_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N).  On the CPU one row at a time: its f32 GEMM
    picks its method by M, which changes the order of each row's sums."""
    if a.device.type != "cpu" or a.shape[0] <= 1:
        return a @ b
    return torch.cat([a[i:i + 1] @ b for i in range(a.shape[0])])


def ttq_gemm_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, *, bits: int, group_size: int,
                 dinv: torch.Tensor | None = None) -> torch.Tensor:
    """y (T, d') f32 = x (T, d) [∘dinv] @ deq(packed (d', d·bits/32), S, Z)ᵀ."""
    d = x.shape[-1]
    wint = unpack_bits(packed, d, bits).float()
    g = group_size
    s = torch.repeat_interleave(scale.float(), g, dim=1)
    z = torch.repeat_interleave(zero.float(), g, dim=1)
    W = wint * s + z
    xf = x.float()
    if dinv is not None:
        xf = xf * dinv[None, :].float()
    return row_matmul(xf, W.T)


def ttq_gemm_experts_ref(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, zero: torch.Tensor, *,
                         bits: int, group_size: int,
                         dinv: torch.Tensor | None = None) -> torch.Tensor:
    """y (E, T, d') f32: :func:`ttq_gemm_ref` on each expert e, x (E, T, d)
    or (T, d) shared by every expert, packed (E, d', ·), S, Z (E, d', d/g),
    dinv (E, d) or None.  A loop over the experts, so expert e's rows are a
    2-D call on expert e bit for bit."""
    return torch.stack([
        ttq_gemm_ref(x if x.dim() == 2 else x[e], packed[e], scale[e],
                     zero[e], bits=bits, group_size=group_size,
                     dinv=None if dinv is None else dinv[e])
        for e in range(packed.shape[0])])


def _attend(q, k, v, cur_pos, sc, soft_cap, window):
    """One query per slot over dequantized f32 k/v (B,Hkv,S,Dh): q
    (B,H,1,Dh), rows past ``cur_pos`` (B,) masked, f32 softmax."""
    B, H, _, Dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = (q[:, :, 0].float() * sc).reshape(B, Hkv, G, Dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k)
    if soft_cap > 0:
        s = soft_cap * torch.tanh(s / soft_cap)
    ki = torch.arange(S, device=q.device)
    mask = ki[None, :] <= cur_pos[:, None]
    if window > 0:
        mask &= ki[None, :] > cur_pos[:, None] - window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v)
    return o.reshape(B, H, 1, Dh).to(q.dtype)


def kv_attn_ref(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                vq: torch.Tensor, vs: torch.Tensor, cur_pos: torch.Tensor, *,
                bits: int = 8, group_size: int = 0,
                scale: float | None = None, soft_cap: float = 0.0,
                window: int = 0) -> torch.Tensor:
    """Decode attention over a quantized cache: dequantize, then grouped-query
    attention with an f32 softmax.  q (B,H,1,Dh); kq/vq (B,Hkv,S,Dc); ks/vs
    (B,Hkv,S,Dh//g); cur_pos (B,) → (B,H,1,Dh) in q's dtype."""
    Dh = q.shape[-1]
    sc = scale if scale is not None else Dh ** -0.5
    k = dequantize_kv(kq, ks, torch.float32, bits=bits, group_size=group_size)
    v = dequantize_kv(vq, vs, torch.float32, bits=bits, group_size=group_size)
    return _attend(q, k, v, cur_pos, sc, soft_cap, window)


def kv_suffix_attn_ref(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor, pos: torch.Tensor,
                       *, bits: int = 8, group_size: int = 0,
                       scale: float | None = None,
                       soft_cap: float = 0.0) -> torch.Tensor:
    """Speculative-window attention over a quantized cache whose window rows
    were just written: q (B,H,S,Dh) holds S queries per slot at positions
    ``pos[b]..pos[b]+S-1``; query s attends rows ≤ pos[b]+s.  The cache is
    dequantized once; each query then runs :func:`kv_attn_ref`'s math, so
    the verify logits are sequential decode's bit for bit on the CPU.
    Returns (B,H,S,Dh) in q's dtype."""
    Dh = q.shape[-1]
    sc = scale if scale is not None else Dh ** -0.5
    k = dequantize_kv(kq, ks, torch.float32, bits=bits, group_size=group_size)
    v = dequantize_kv(vq, vs, torch.float32, bits=bits, group_size=group_size)
    return torch.cat([_attend(q[:, :, s:s + 1].contiguous(), k, v, pos + s,
                              sc, soft_cap, 0)
                      for s in range(q.shape[2])], dim=2)


def kv_paged_suffix_attn_ref(q: torch.Tensor, kq: torch.Tensor,
                             ks: torch.Tensor, vq: torch.Tensor,
                             vs: torch.Tensor, block_table: torch.Tensor,
                             pos: torch.Tensor, *, bits: int = 8,
                             group_size: int = 0, scale: float | None = None,
                             soft_cap: float = 0.0) -> torch.Tensor:
    """Paged speculative-window attention: the block table's view of each
    pool gathered into the contiguous layout, then exactly
    :func:`kv_suffix_attn_ref`."""
    g = [gather_paged_kv(t, block_table) for t in (kq, ks, vq, vs)]
    return kv_suffix_attn_ref(q, *g, pos, bits=bits, group_size=group_size,
                              scale=scale, soft_cap=soft_cap)


def gather_paged_kv(pool: torch.Tensor,
                    block_table: torch.Tensor) -> torch.Tensor:
    """A per-slot contiguous view of a paged pool: pool (NB, Hkv, bs, D·)
    indexed by block_table (B, nblk) → (B, Hkv, nblk·bs, D·).  Unallocated
    entries point at the sink block 0; its rows land past ``cur_pos`` and
    the attention read masks them."""
    g = pool[block_table.long()]                       # (B, nblk, Hkv, bs, D)
    B, nblk, Hkv, bs, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nblk * bs, D)


def kv_paged_attn_ref(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                      vq: torch.Tensor, vs: torch.Tensor,
                      block_table: torch.Tensor, cur_pos: torch.Tensor, *,
                      bits: int = 8, group_size: int = 0,
                      scale: float | None = None,
                      soft_cap: float = 0.0) -> torch.Tensor:
    """Paged decode attention: gather the block table's view of each
    (NB, Hkv, bs, ·) pool into the contiguous layout, then exactly
    :func:`kv_attn_ref`."""
    g = [gather_paged_kv(t, block_table) for t in (kq, ks, vq, vs)]
    return kv_attn_ref(q, *g, cur_pos, bits=bits, group_size=group_size,
                       scale=scale, soft_cap=soft_cap)


def ttq_quantize_ref(W: torch.Tensor, D: torch.Tensor, *, bits: int,
                     group_size: int):
    """W (..., d', d) ∘ D (..., d) → packed (..., d', d·bits/32) int32,
    S (..., d', d/g) f32, Z (..., d', d/g) f32.  Leading dims batch (the
    fused requant passes a layer stack)."""
    qmax = (1 << bits) - 1
    g = group_size
    dp, d = W.shape[-2:]
    lead = W.shape[:-2]
    Ws = W.float() * D.float().unsqueeze(-2)
    Wg = Ws.reshape(*lead, dp, d // g, g)
    wmax = Wg.amax(dim=-1)
    wmin = Wg.amin(dim=-1)
    S = torch.clamp((wmax - wmin) / qmax, min=1e-12)
    Z = wmin
    wint = torch.clamp(torch.round((Wg - Z[..., None]) / S[..., None]), 0, qmax)
    wint = wint.reshape(*lead, dp, d).to(torch.int32)
    return pack_bits(wint, bits), S, Z
