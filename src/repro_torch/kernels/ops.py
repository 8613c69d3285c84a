"""Dispatch for the kernels on the serving path.

``use_pallas=False`` (the reference's escape hatch, same name), an
unsupported bit-width, or a windowed mask routes to the plain PyTorch
version; otherwise the kernel wrapper runs, which launches the CUDA kernel
for CUDA tensors and uses the plain version for CPU tensors.  The
speculative verify reads (``kv_suffix_attention``,
``kv_paged_suffix_attention``) have no kernel and are plain everywhere.
"""
from __future__ import annotations

from . import ref as _ref
from .ttq_attn import ttq_decode_attention as _attn_kernel
from .ttq_attn import ttq_paged_decode_attention as _paged_attn_kernel
from .ttq_gemm import ttq_gemm as _gemm_kernel
from .ttq_gemm import ttq_gemm_experts as _gemm_experts_kernel
from .ttq_quantize import ttq_quantize as _quantize_kernel

_PACKABLE = (2, 4, 8)
_KV_BITS = (4, 8)


def ttq_gemm(x, packed, scale, zero, dinv=None, *, bits=4, group_size=32,
             use_pallas=True):
    if use_pallas and bits in _PACKABLE:
        return _gemm_kernel(x, packed, scale, zero, dinv, bits=bits,
                            group_size=group_size)
    lead = x.shape[:-1]
    y = _ref.ttq_gemm_ref(x.reshape(-1, x.shape[-1]), packed, scale, zero,
                          bits=bits, group_size=group_size, dinv=dinv)
    return y.reshape(*lead, -1).to(x.dtype)


def ttq_gemm_experts(x, packed, scale, zero, dinv=None, *, bits=4,
                     group_size=32, use_pallas=True):
    """E expert weights in one launch (the reference's vmapped ``ttq_gemm``):
    x (E, T, d) or (T, d) shared → (E, T, d')."""
    if use_pallas and bits in _PACKABLE:
        return _gemm_experts_kernel(x, packed, scale, zero, dinv, bits=bits,
                                    group_size=group_size)
    return _ref.ttq_gemm_experts_ref(x, packed, scale, zero, bits=bits,
                                     group_size=group_size,
                                     dinv=dinv).to(x.dtype)


def kv_decode_attention(q, kq, ks, vq, vs, cur_pos, *, bits=8, group_size=0,
                        scale=None, soft_cap=0.0, window=0, use_pallas=True):
    if use_pallas and bits in _KV_BITS and window == 0:
        return _attn_kernel(q, kq, ks, vq, vs, cur_pos, bits=bits,
                            group_size=group_size, scale=scale,
                            soft_cap=soft_cap)
    return _ref.kv_attn_ref(q, kq, ks, vq, vs, cur_pos, bits=bits,
                            group_size=group_size, scale=scale,
                            soft_cap=soft_cap, window=window)


def kv_paged_decode_attention(q, kq, ks, vq, vs, block_table, cur_pos, *,
                              bits=8, group_size=0, scale=None, soft_cap=0.0,
                              use_pallas=True):
    """Decode attention over the (NB, Hkv, block_size, ·) pools through the
    (B, nblk) block table."""
    if use_pallas and bits in _KV_BITS:
        return _paged_attn_kernel(q, kq, ks, vq, vs, block_table, cur_pos,
                                  bits=bits, group_size=group_size,
                                  scale=scale, soft_cap=soft_cap)
    return _ref.kv_paged_attn_ref(q, kq, ks, vq, vs, block_table, cur_pos,
                                  bits=bits, group_size=group_size,
                                  scale=scale, soft_cap=soft_cap)


def kv_suffix_attention(q, kq, ks, vq, vs, pos, *, bits=8, group_size=0,
                        scale=None, soft_cap=0.0, use_pallas=True):
    """Speculative-verify attention over an int8/int4 cache whose window
    rows were just written.  No kernel, in the reference as here: every
    device runs the plain version (``use_pallas`` kept for the reference's
    signature)."""
    del use_pallas
    return _ref.kv_suffix_attn_ref(q, kq, ks, vq, vs, pos, bits=bits,
                                   group_size=group_size, scale=scale,
                                   soft_cap=soft_cap)


def kv_paged_suffix_attention(q, kq, ks, vq, vs, block_table, pos, *, bits=8,
                              group_size=0, scale=None, soft_cap=0.0,
                              use_pallas=True):
    """The same over the (NB, Hkv, block_size, ·) pools through the (B,
    nblk) block table; plain on every device."""
    del use_pallas
    return _ref.kv_paged_suffix_attn_ref(q, kq, ks, vq, vs, block_table, pos,
                                         bits=bits, group_size=group_size,
                                         scale=scale, soft_cap=soft_cap)


def ttq_quantize(W, D, *, bits=4, group_size=32, use_pallas=True, out=None):
    """``out`` = (packed, S, Z): write the results there (see the kernel
    wrapper)."""
    if use_pallas and bits in _PACKABLE:
        return _quantize_kernel(W, D, bits=bits, group_size=group_size,
                                out=out)
    res = _ref.ttq_quantize_ref(W, D, bits=bits, group_size=group_size)
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)
