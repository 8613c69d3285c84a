"""Dispatch for the kernels on the serving path.

``use_pallas=False`` (the reference's escape hatch, same name), an
unsupported bit-width, or a windowed mask routes to the plain PyTorch
version; otherwise the kernel wrapper runs, which launches the CUDA kernel
for CUDA tensors and uses the plain version for CPU tensors.  The
speculative verify reads (``kv_suffix_attention``,
``kv_paged_suffix_attention``) have no kernel and are plain everywhere.

The ``*_tp`` wrappers are the reference's tensor-parallel entries
(``repro/kernels/ops.py:147-262``).  Each rank holds its slice of the
weights and caches (``parallel/rules.py:shard_params``), so a wrapper runs
the same kernel on the rank's shard and runs the collective itself:
``ttq_gemm_tp(tp="row")`` multiplies the (d'/n, d) shard with no
collective, ``tp="col"`` the (d', d/n) slice of its input slice and then
all-reduces; the attention wrappers read the rank's q and KV heads.
Without a context (or for a block the layout replicates, which the model
code runs with ``pctx=None``) they are the unwrapped calls.
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


# ---------------------------------------------------------------- TP wrappers

def _tp_gemm_ok(pctx, tp, x, packed, scale, bits, group_size):
    """Whether the call takes the tensor-parallel path: a context with a
    mesh and a role.  A column slice must keep whole groups and code words
    (the placement's ``align``): a misaligned one means the placement and
    the weights disagree, and raises."""
    if tp not in ("row", "col") or pctx is None or pctx.mesh is None:
        return False
    if tp == "col":
        d = x.shape[-1]
        per = 32 // bits
        g = group_size or d
        if d % g or d % per or packed.shape[-1] * per != d \
                or scale.shape[-1] * g != d:
            raise ValueError(
                f"ttq_gemm_tp(tp='col'): input slice of {d} features does "
                f"not match its weight slice (packed {tuple(packed.shape)}, "
                f"scale {tuple(scale.shape)}, g={g}, bits={bits})")
    return True


def ttq_gemm_tp(x, packed, scale, zero, dinv=None, *, bits=4, group_size=32,
                pctx=None, tp=None):
    """``ttq_gemm`` under Megatron-style tensor parallelism.  ``tp='row'``:
    the rank's (d'/n, d) shard, output features sharded, no collective.
    ``tp='col'``: the rank's input slice x (…, d/n) against its (d', d/n)
    slice, then an all-reduce over the model axis rebuilds the full
    output.  The split rules (``kernels/ttq_gemm.py:gemm_splits``) see the
    shard's shape."""
    col = _tp_gemm_ok(pctx, tp, x, packed, scale, bits, group_size) \
        and tp == "col"
    if col and pctx.world > 1:
        # partial sums in f32, summed, then rounded once, as world 1
        # rounds its f32 accumulator once
        from repro_torch.parallel import comm
        y = ttq_gemm(x.float(), packed, scale, zero, dinv, bits=bits,
                     group_size=group_size)
        return comm.all_reduce(y, pctx).to(x.dtype)
    y = ttq_gemm(x, packed, scale, zero, dinv, bits=bits,
                 group_size=group_size)
    if col:                               # one rank: the identity
        from repro_torch.parallel import comm
        y = comm.all_reduce(y, pctx)
    return y


def _tp_attn_ok(pctx, q, kq, batched_cache):
    """Whether the read runs on a rank's heads: a context with a mesh,
    and q heads a whole GQA multiple of the rank's KV heads (q and KV
    heads shard the model axis together; the q→kv map is
    block-contiguous)."""
    if pctx is None or pctx.mesh is None:
        return False
    if q.shape[1] % kq.shape[1]:
        raise ValueError(f"rank's q heads {q.shape[1]} not a multiple of "
                         f"its KV heads {kq.shape[1]}")
    return True


def kv_decode_attention_tp(q, kq, ks, vq, vs, cur_pos, *, pctx=None, **kw):
    """Head-parallel :func:`kv_decode_attention`: the rank's q heads over
    its KV heads; no collective (``wo`` reduces after it)."""
    _tp_attn_ok(pctx, q, kq, True)
    return kv_decode_attention(q, kq, ks, vq, vs, cur_pos, **kw)


def kv_suffix_attention_tp(q, kq, ks, vq, vs, pos, *, pctx=None, **kw):
    """Head-parallel :func:`kv_suffix_attention` (the verify read)."""
    _tp_attn_ok(pctx, q, kq, True)
    return kv_suffix_attention(q, kq, ks, vq, vs, pos, **kw)


def kv_paged_decode_attention_tp(q, kq, ks, vq, vs, block_table, cur_pos, *,
                                 pctx=None, **kw):
    """Head-parallel paged decode read: the pools are sharded over KV heads
    (never over the physical blocks, whose ids are global); the block table
    and positions are replicated."""
    _tp_attn_ok(pctx, q, kq, False)
    return kv_paged_decode_attention(q, kq, ks, vq, vs, block_table, cur_pos,
                                     **kw)


def kv_paged_suffix_attention_tp(q, kq, ks, vq, vs, block_table, pos, *,
                                 pctx=None, **kw):
    """Head-parallel paged verify read (as
    :func:`kv_paged_decode_attention_tp`)."""
    _tp_attn_ok(pctx, q, kq, False)
    return kv_paged_suffix_attention(q, kq, ks, vq, vs, block_table, pos,
                                     **kw)
