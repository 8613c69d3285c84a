"""Wrappers of the ``ttq_gemm`` CUDA kernels: one 2-D weight
(:func:`ttq_gemm`: the split tile of ``csrc/ttq_gemm.cu``, or at large T the
tensor-core tile of ``csrc/ttq_gemm_wide.cu`` where :func:`gemm_tile` says
so), or E expert weights of one shape in one launch
(:func:`ttq_gemm_experts`, the reference's ``ttq_gemm`` under
``jax.vmap`` in ``_expert_mm``): the tensor-core tile of
``csrc/ttq_gemm_experts.cu`` where :func:`experts_tile` says so, else the
2-D kernel's tile batched over the experts.

CPU tensors take the plain versions (:func:`repro_torch.kernels.ref.
ttq_gemm_ref`, :func:`~repro_torch.kernels.ref.ttq_gemm_experts_ref`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools

import torch

from . import build, ref
from ._checks import aligned, dtype_in, on_cuda, sm_count

NAME = "ttq_gemm"
NAME_EXPERTS = "ttq_gemm_experts"
ROW_TILE = 32           # output rows per block (csrc/ttq_gemm.cu: kRows)
TOKEN_TILE = 8          # tokens per block at most (the kernel's largest TT)
SPLITS = (1, 2, 4, 8)   # blocks per cluster; 8 is the portable cluster limit
MIN_SLICE = 512         # fewest K elements a split block takes
BLOCKS_PER_SM = 1       # blocks to aim for on each SM
WIDE_MIN_T = 64         # fewest tokens gemm_tile sends to the wide tile
WIDE_MAX_D = 1024       # widest input gemm_tile sends to the wide tile
WIDE_ROWS, WIDE_TOKENS = 256, 64    # the wide tile (csrc/ttq_gemm_wide.cu)
WIDE_MIN_TILES = 8      # fewest wide tiles gemm_tile launches


def fast_shape(d: int, g: int, bits: int) -> bool:
    """Whether the kernel's fast tile takes (d, g, bits): g a power of two of
    at least one code word (32/bits) and rows of whole uint4 words of codes.
    Every other shape of whole words and groups runs its generic tile, at
    split 1 (``csrc/ttq_gemm.cu``, "Other group sizes")."""
    per = 32 // bits
    return g >= per and not g & (g - 1) and d % (4 * per) == 0


def int4_tensor_core_shape(d: int, g: int, bits: int,
                           dtype: torch.dtype) -> bool:
    """Whether both tensor-core tiles (``csrc/ttq_gemm_experts.cu``,
    ``csrc/ttq_gemm_wide.cu``) can take (d, g, bits, x's dtype): bf16 x,
    int4 codes (their nibbles are dequantized in registers) and g a power of
    two of at least 32 (one 32-k unit) dividing d."""
    return (bits == 4 and dtype == torch.bfloat16 and g >= 32
            and not g & (g - 1) and d % g == 0)


def experts_tile(d: int, g: int, bits: int, dtype: torch.dtype) -> str:
    """The tile :func:`ttq_gemm_experts` launches: ``"mma"`` (tensor cores,
    ``csrc/ttq_gemm_experts.cu``) where :func:`int4_tensor_core_shape`
    holds (both MoE configs' expert shapes at any T, E and d');
    ``"batched"`` (the 2-D kernel's tile over the experts,
    ``csrc/ttq_gemm.cu``) for every other shape: bits 2 and 8, other g, f32
    x.  Chosen by shape, never by failure."""
    return "mma" if int4_tensor_core_shape(d, g, bits, dtype) else "batched"


def gemm_tile(T: int, dp: int, d: int, g: int, bits: int,
              dtype: torch.dtype) -> str:
    """The tile :func:`ttq_gemm` launches at T tokens, d' = dp rows and d
    inputs: ``"wide"`` (tensor cores, WIDE_ROWS × WIDE_TOKENS a block over
    the whole K, ``csrc/ttq_gemm_wide.cu``) where
    :func:`int4_tensor_core_shape` holds, T >= WIDE_MIN_T, d <= WIDE_MAX_D
    and the grid has WIDE_MIN_TILES tiles (MLA's latent expansion through
    ``wkv_b``: T = slots × max_len, d = kv_lora_rank, and a row-split
    rank's share of its rows); ``"split"`` (the decode tile of
    ``csrc/ttq_gemm.cu``) for every other shape: every decode step (T =
    slots) and speculative verify (T = slots × (W + 1)), bits 2 and 8,
    other g, f32 x (a column-split linear at world > 1), wider inputs and
    small grids.  Chosen by shape, never by failure.  The bounds come from
    ``tools/wide_probe.py`` on an H100 (PERF.md §6): the wide tile walks all
    of K in each block, so it loses at T = 64 from d = 2,048 on (the split
    tile shares K among a cluster's blocks) and on 4 tiles (d' = 1,024),
    and wins at d <= 1,024 on 8 tiles or more."""
    tiles = -(-dp // WIDE_ROWS) * -(-T // WIDE_TOKENS)
    if (T >= WIDE_MIN_T and d <= WIDE_MAX_D and tiles >= WIDE_MIN_TILES
            and int4_tensor_core_shape(d, g, bits, dtype)):
        return "wide"
    return "split"


@functools.lru_cache(maxsize=None)      # called per decode linear: host time
def gemm_splits(dp: int, d: int, T: int, bits: int, g: int, n_sm: int,
                E: int = 1) -> int:
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
    wg/wu (24576 × 3072) 1, wd (3072 × 24576) 2.  A batched launch counts
    its E experts' blocks: at deepseek-v2-lite's experts (E = 64, wg/wu
    1408 × 2048, wd 2048 × 1408) and llama4-scout's (E = 16, 8192 × 5120
    and 5120 × 8192) every split is 1.  A shape off the fast tile
    (:func:`fast_shape`) takes 1."""
    if not fast_shape(d, g, bits):
        return 1
    epv = 4 * (32 // bits)
    allowed = [s for s in SPLITS
               if d % s == 0 and (d // s) % g == 0 and (d // s) % epv == 0
               and (s == 1 or d // s >= MIN_SLICE)]
    blocks = E * -(-dp // ROW_TILE) * -(-T // TOKEN_TILE)
    for s in allowed:
        if blocks * s >= BLOCKS_PER_SM * n_sm:
            return s
    return allowed[-1]


def ttq_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
             zero: torch.Tensor, dinv: torch.Tensor | None = None, *,
             bits: int = 4, group_size: int = 32) -> torch.Tensor:
    """x (..., d) → (..., d') in x's dtype.  packed (d', d·bits/32) int32;
    scale, zero (d', d/g) f32; dinv (d,) f32 or None.  g and 32/bits must
    divide d.  The tile is :func:`gemm_tile`'s, counted in
    ``build.GEMM_TILES``."""
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
    _check_dg(NAME, d, g, per)
    tile = gemm_tile(x2.shape[0], dp, d, g, bits, x.dtype)
    return _launch(x2, packed, scale, zero, dinv, bits, g,
                   tile).reshape(*lead, dp)


def _launch(x2, packed, scale, zero, dinv, bits, g, tile):
    """One launch of ``tile`` ("split" or "wide") on checked arguments, x2
    (T, d).  :func:`ttq_gemm` always passes :func:`gemm_tile`'s choice; a
    measurement may force the other at the same shape."""
    T, d = x2.shape
    dp = packed.shape[0]
    if tile == "wide" and not (d <= WIDE_MAX_D and int4_tensor_core_shape(
            d, g, bits, x2.dtype)):
        raise ValueError(f"{NAME}: the wide tile takes bf16 x, int4, g a "
                         f"power of two >= 32 dividing d and d <= "
                         f"{WIDE_MAX_D}, not {x2.dtype}, bits={bits}, g={g}, "
                         f"d={d}")
    x2, packed, scale, zero = map(aligned, (x2, packed, scale, zero))
    dinv = None if dinv is None else aligned(dinv)   # alive past the launch
    dinv_ptr = None if dinv is None else dinv.data_ptr()
    y = torch.empty((T, dp), dtype=x2.dtype, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    if tile == "wide":
        err = build.lib().ttq_gemm_wide_launch(
            x2.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            zero.data_ptr(), dinv_ptr, y.data_ptr(), T, dp, d, bits, g,
            stream)
    else:
        err = build.lib().ttq_gemm_launch(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), packed.data_ptr(),
            scale.data_ptr(), zero.data_ptr(), dinv_ptr, y.data_ptr(),
            T, dp, d, bits, g, gemm_splits(dp, d, T, bits, g,
                                           sm_count(x2.device)), stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    build.GEMM_TILES[tile] += 1
    return y


def _check_dg(name, d, g, per):
    if g <= 0 or d % per or d % g:
        raise ValueError(f"{name}: d={d} must divide by {per} (codes per "
                         f"word) and by group_size={g}")


def ttq_gemm_experts(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor,
                     dinv: torch.Tensor | None = None, *, bits: int = 4,
                     group_size: int = 32) -> torch.Tensor:
    """E experts in one launch: x (E, T, d), or (T, d) shared by every
    expert; packed (E, d', d·bits/32) int32; scale, zero (E, d', d/g) f32;
    dinv (E, d) f32 or None → y (E, T, d') in x's dtype.  The tile is
    :func:`experts_tile`'s, counted in ``build.EXPERTS_TILES``.  On the mma
    tile expert e's rows are bit for bit the same whatever E and whichever
    experts share the launch; on the batched tile they equal
    :func:`ttq_gemm` on expert e bit for bit (the same split)."""
    E, dp = packed.shape[:2]
    d = x.shape[-1]
    if x.device.type == "cpu":
        return ref.ttq_gemm_experts_ref(
            x, packed, scale, zero, bits=bits, group_size=group_size,
            dinv=dinv).to(x.dtype)
    extra = () if dinv is None else (dinv,)
    on_cuda(NAME_EXPERTS, x, packed, scale, zero, *extra)
    dtype_in(NAME_EXPERTS, "x", x, (torch.bfloat16, torch.float32))
    dtype_in(NAME_EXPERTS, "packed", packed, (torch.int32,))
    for nm, t in zip(("scale", "zero", "dinv"), (scale, zero, *extra)):
        dtype_in(NAME_EXPERTS, nm, t, (torch.float32,))
    if bits not in (2, 4, 8):
        raise ValueError(f"{NAME_EXPERTS}: bits={bits} not in (2, 4, 8)")
    per, g = 32 // bits, group_size
    shared = x.dim() == 2
    T = x.shape[-2]
    if (x.dim() not in (2, 3) or (not shared and x.shape[0] != E)
            or packed.shape != (E, dp, d // per)
            or scale.shape != (E, dp, d // g) or zero.shape != scale.shape
            or (dinv is not None and dinv.shape != (E, d))):
        raise ValueError(
            f"{NAME_EXPERTS}: shapes x {tuple(x.shape)}, packed "
            f"{tuple(packed.shape)}, scale {tuple(scale.shape)}, zero "
            f"{tuple(zero.shape)}"
            + ("" if dinv is None else f", dinv {tuple(dinv.shape)}")
            + " disagree")
    _check_dg(NAME_EXPERTS, d, g, per)
    tile = experts_tile(d, g, bits, x.dtype)
    n_sm = sm_count(x.device)
    x, packed, scale, zero = map(aligned, (x, packed, scale, zero))
    dinv = None if dinv is None else aligned(dinv)
    y = torch.empty((E, T, dp), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dinv_ptr = None if dinv is None else dinv.data_ptr()
    if tile == "mma":
        err = build.lib().ttq_gemm_experts_mma_launch(
            x.data_ptr(), int(shared), packed.data_ptr(), scale.data_ptr(),
            zero.data_ptr(), dinv_ptr, y.data_ptr(), E, T, dp, d, g, n_sm,
            stream)
    else:
        err = build.lib().ttq_gemm_experts_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), int(shared),
            packed.data_ptr(), scale.data_ptr(), zero.data_ptr(), dinv_ptr,
            y.data_ptr(), E, T, dp, d, bits, g,
            gemm_splits(dp, d, T, bits, g, n_sm, E), stream)
    build.check(err, NAME_EXPERTS)
    build.LAUNCHES[NAME_EXPERTS] += 1
    build.EXPERTS_TILES[tile] += 1
    return y
