"""Wrapper of the ``ttq_gemm`` CUDA kernel (``csrc/ttq_gemm.cu``).

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
ttq_gemm_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools

import torch

from . import build, ref
from ._checks import aligned, dtype_in, on_cuda, sm_count

NAME = "ttq_gemm"
ROW_TILE = 32           # output rows per block (csrc/ttq_gemm.cu: kRows)
TOKEN_TILE = 8          # tokens per block at most (the kernel's largest TT)
SPLITS = (1, 2, 4, 8)   # blocks per cluster; 8 is the portable cluster limit
MIN_SLICE = 512         # fewest K elements a split block takes
BLOCKS_PER_SM = 1       # blocks to aim for on each SM


@functools.lru_cache(maxsize=None)      # called per decode linear: host time
def gemm_splits(dp: int, d: int, T: int, bits: int, g: int, n_sm: int) -> int:
    """The kernel's K split S: how many blocks of one cluster share a row tile.

    Allowed: S in SPLITS whose slice d/S is a whole number of groups (g) and
    of uint4 code words (4·32/bits elements) and, for S > 1, at least
    MIN_SLICE long.  Taken: the smallest allowed S that gives the grid
    (row tiles × token tiles × S blocks) at least BLOCKS_PER_SM × n_sm
    blocks, else the largest allowed.  BLOCKS_PER_SM = 1 was tuned on an
    H100 (132 SMs) from ``chip_smoke.py``'s timings of the kernel at every
    split: past one block per SM, more splits only add blocks whose staging
    and cluster reduction cost more than they bring.  At gemma-7b
    int4 g32, T = 4, 132 SMs: wq/wk/wv (4096 × 3072) 2, wo (3072 × 4096) 2,
    wg/wu (24576 × 3072) 1, wd (3072 × 24576) 2."""
    epv = 4 * (32 // bits)
    allowed = [s for s in SPLITS
               if d % s == 0 and (d // s) % g == 0 and (d // s) % epv == 0
               and (s == 1 or d // s >= MIN_SLICE)]
    blocks = -(-dp // ROW_TILE) * -(-T // TOKEN_TILE)
    for s in allowed:
        if blocks * s >= BLOCKS_PER_SM * n_sm:
            return s
    return allowed[-1]


def ttq_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
             zero: torch.Tensor, dinv: torch.Tensor | None = None, *,
             bits: int = 4, group_size: int = 32) -> torch.Tensor:
    """x (..., d) → (..., d') in x's dtype.  packed (d', d·bits/32) int32;
    scale, zero (d', d/g) f32; dinv (d,) f32 or None.  On the card the group
    size is a power of two (as ``ttq_quantize`` makes it)."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if x.device.type == "cpu":
        y = ref.ttq_gemm_ref(x2, packed, scale, zero, bits=bits,
                             group_size=group_size, dinv=dinv)
        return y.reshape(*lead, -1).to(x.dtype)
    extra = () if dinv is None else (dinv,)
    on_cuda(NAME, x, packed, scale, zero, *extra)
    dtype_in(NAME, "x", x, (torch.bfloat16, torch.float32))
    dtype_in(NAME, "packed", packed, (torch.int32,))
    for nm, t in zip(("scale", "zero", "dinv"), (scale, zero, *extra)):
        dtype_in(NAME, nm, t, (torch.float32,))
    if bits not in (2, 4, 8):
        raise ValueError(f"{NAME}: bits={bits} not in (2, 4, 8)")
    per, g = 32 // bits, group_size
    dp = packed.shape[0]
    if (packed.shape != (dp, d // per) or scale.shape != (dp, d // g)
            or zero.shape != scale.shape
            or (dinv is not None and dinv.shape != (d,))):
        raise ValueError(
            f"{NAME}: shapes x {tuple(x.shape)}, packed {tuple(packed.shape)},"
            f" scale {tuple(scale.shape)}, zero {tuple(zero.shape)} disagree")
    if d % (4 * per) or d % g or g < per or g & (g - 1):
        raise ValueError(f"{NAME}: d={d} must divide by {4 * per} and by "
                         f"group_size={g}, a power of two >= {per}")
    T = x2.shape[0]
    split = gemm_splits(dp, d, T, bits, g, sm_count(x.device))
    x2, packed, scale, zero = map(aligned, (x2, packed, scale, zero))
    dinv = None if dinv is None else aligned(dinv)
    y = torch.empty((T, dp), dtype=x.dtype, device=x.device)
    err = build.lib().ttq_gemm_launch(
        x2.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
        scale.data_ptr(), zero.data_ptr(),
        None if dinv is None else dinv.data_ptr(), y.data_ptr(),
        T, dp, d, bits, g, split,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return y.reshape(*lead, dp)
