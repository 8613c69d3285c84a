"""Wrappers of the ``ttq_decode_attention`` and
``ttq_paged_decode_attention`` CUDA kernels (``csrc/ttq_attn.cu``).

CPU tensors take the plain versions (:func:`repro_torch.kernels.ref.
kv_attn_ref`, :func:`~repro_torch.kernels.ref.kv_paged_attn_ref`); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools

import torch

from . import build, ref
from ._checks import aligned, dtype_in, on_cuda, sm_count

NAME = "ttq_decode_attention"
PAGED_NAME = "ttq_paged_decode_attention"
SPLITS = (1, 2, 4, 8)   # blocks per cluster; 8 is the portable cluster limit
MIN_ROWS = 128          # fewest cache rows of capacity a rank is given
BLOCKS_PER_SM = 2       # blocks to aim for on each SM


@functools.lru_cache(maxsize=None)      # called per decode layer: host time
def attn_splits(B: int, Hkv: int, capacity_rows: int, n_sm: int) -> int:
    """The kernels' split C: how many blocks of one cluster share the rows
    of one (slot, kv head, head tile).  From static shapes only (the rows
    in use, ``cur_pos``, live on the device); ``Hkv`` counts kv heads times
    their head tiles (:func:`head_tile`).

    Allowed: C in SPLITS with, for C > 1, at least MIN_ROWS rows of the
    capacity (S, or nblk·bs) per rank: two batches of 8 rows for each of a
    block's 8 warps.  Taken: the smallest allowed C that gives the grid
    (B·Hkv·C blocks) at least BLOCKS_PER_SM × n_sm blocks, else the largest
    allowed.  Tuned on an H100 (132 SMs, two blocks resident per SM) from
    ``chip_smoke.py``'s timings at every C: larger clusters cost a few µs
    of launch and merge each, which only a long slot pays back.  At
    gemma-7b (16 kv heads), 4 slots: capacity 256 → 2, 8192 → 8."""
    allowed = [c for c in SPLITS if c == 1 or capacity_rows // c >= MIN_ROWS]
    for c in allowed:
        if B * Hkv * c >= BLOCKS_PER_SM * n_sm:
            return c
    return allowed[-1]


def head_tile(G: int, Dh: int) -> tuple[int, int]:
    """(Gt, T): the kernels take the G query heads of a kv head in T =
    ceil(G / Gt) tiles of Gt heads, one tile per cluster; Gt is the power of
    two in {1, 2, 4} nearest above G, at most 4 / NCH (NCH = ceil(Dh / 256)
    head-dim chunks per lane), so the tile's q and accumulators stay in
    registers.  The last tile's heads past G are masked (G = 3: one tile
    of 4; G = 12: three of 4; G = 48 at Dh 512: 24 of 2)."""
    gmax = 4 // -(-Dh // 256)
    gt = min(gmax, 1 << (G - 1).bit_length())
    return gt, -(-G // gt)


def _prepare(name, q, kq, ks, vq, vs, cur_pos, bits, group_size, scale,
             rows: tuple):
    """Checks shared by both kernels; ``rows`` is the (lead, rows) shape of
    the code and scale tensors — (B, Hkv, S) dense, (NB, Hkv, bs) paged.
    Returns (q contiguous, G, n_groups, f32 scale, out in q's dtype)."""
    if bits not in (4, 8):
        raise ValueError(f"{name}: bits={bits} not in (4, 8)")
    code_t = torch.int8 if bits == 8 else torch.int32
    dtype_in(name, "q", q, (torch.bfloat16, torch.float32))
    dtype_in(name, "kq", kq, (code_t,))
    dtype_in(name, "vq", vq, (code_t,))
    dtype_in(name, "ks", ks, (torch.float32,))
    dtype_in(name, "vs", vs, (torch.float32,))
    dtype_in(name, "cur_pos", cur_pos, (torch.int32,))
    B, H, one, Dh = q.shape
    Hkv = rows[1]
    g = group_size or Dh
    ngr = Dh // g
    if (one != 1 or H % Hkv or tuple(kq.shape[:3]) != rows
            or vq.shape != kq.shape
            or kq.shape[3] != (Dh if bits == 8 else Dh // 8)
            or ks.shape != (*rows, ngr) or vs.shape != ks.shape
            or cur_pos.shape != (B,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, codes "
                         f"{tuple(kq.shape)}, scales {tuple(ks.shape)}, "
                         f"cur_pos {tuple(cur_pos.shape)} disagree")
    if rows[0] * rows[1] * rows[2] >= 2 ** 31:
        raise ValueError(f"{name}: {rows} cache rows do not fit 32-bit "
                         f"row indices")
    G = H // Hkv
    if Dh % 8 or Dh > 512 or Dh % g or g % 8:
        raise ValueError(f"{name}: unsupported Dh={Dh}, group={g}")
    sc = scale if scale is not None else Dh ** -0.5
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    return aligned(q), G, ngr, float(sc), out


def ttq_decode_attention(q, kq, ks, vq, vs, cur_pos, *, bits: int = 8,
                         group_size: int = 0, scale: float | None = None,
                         soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,H,1,Dh) bf16 or f32; kq/vq codes (B,Hkv,S,Dc) int8 or int32
    (int4 packed); ks/vs (B,Hkv,S,Dh//g) f32; cur_pos (B,) int32 →
    (B,H,1,Dh) in q's dtype.  Rows past ``cur_pos`` are masked.  On the
    card q is scaled (default Dh^-1/2) and the output cast inside the
    kernel: one launch per call, at the split :func:`attn_splits` picks."""
    if q.device.type == "cpu":
        return ref.kv_attn_ref(q, kq, ks, vq, vs, cur_pos, bits=bits,
                               group_size=group_size, scale=scale,
                               soft_cap=soft_cap)
    return _launch(q, kq, ks, vq, vs, None, cur_pos, None, bits=bits,
                   group_size=group_size, scale=scale, soft_cap=soft_cap)


def ttq_paged_decode_attention(q, kq, ks, vq, vs, block_table, cur_pos, *,
                               bits: int = 8, group_size: int = 0,
                               scale: float | None = None,
                               soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,H,1,Dh) bf16 or f32; kq/vq pool codes (NB,Hkv,bs,Dc) int8 or
    int32 (int4 packed); ks/vs (NB,Hkv,bs,Dh//g) f32; block_table (B, nblk)
    int32 physical block per logical block; cur_pos (B,) int32 →
    (B,H,1,Dh) in q's dtype.  Rows past ``cur_pos`` are masked and never
    read.  The block table's entries are not checked on the host (that
    would sync): they must lie in [0, NB).  One launch per call, as for
    :func:`ttq_decode_attention`."""
    if q.device.type == "cpu":
        return ref.kv_paged_attn_ref(q, kq, ks, vq, vs, block_table, cur_pos,
                                     bits=bits, group_size=group_size,
                                     scale=scale, soft_cap=soft_cap)
    return _launch(q, kq, ks, vq, vs, block_table, cur_pos, None, bits=bits,
                   group_size=group_size, scale=scale, soft_cap=soft_cap)


def _launch(q, kq, ks, vq, vs, block_table, cur_pos, splits, *, bits=8,
            group_size=0, scale=None, soft_cap=0.0) -> torch.Tensor:
    """Launch the dense kernel (``block_table`` None) or the paged one on
    CUDA tensors at split ``splits`` (None: :func:`attn_splits`); the
    kernel refuses one not in SPLITS.  The wrappers pass None; the tests
    and ``chip_smoke.py`` force each C through here."""
    paged = block_table is not None
    name = PAGED_NAME if paged else NAME
    on_cuda(name, q, kq, ks, vq, vs, cur_pos,
            *((block_table,) if paged else ()))
    B, H, _, Dh = q.shape
    lead, Hkv, rows, _ = kq.shape
    nblk = 0
    if paged:
        dtype_in(name, "block_table", block_table, (torch.int32,))
        if block_table.dim() != 2 or block_table.shape[0] != B:
            raise ValueError(f"{name}: block_table "
                             f"{tuple(block_table.shape)} is not (B={B}, nblk)")
        nblk = block_table.shape[1]
        if not 0 < nblk <= 2048 or not 0 < rows <= 1024:
            raise ValueError(f"{name}: nblk={nblk} not in 1..2048 or "
                             f"block size {rows} not in 1..1024")
    q, G, ngr, sc, out = _prepare(name, q, kq, ks, vq, vs, cur_pos, bits,
                                  group_size, scale, (lead, Hkv, rows))
    gt, tiles = head_tile(G, Dh)
    if splits is None:
        splits = attn_splits(B, Hkv * tiles, nblk * rows if paged else rows,
                             sm_count(q.device))
    kq, ks, vq, vs, cur_pos = map(aligned, (kq, ks, vq, vs, cur_pos))
    head = (q.data_ptr(), int(q.dtype == torch.bfloat16), sc, kq.data_ptr(),
            ks.data_ptr(), vq.data_ptr(), vs.data_ptr())
    tail = (Dh, ngr, bits, float(soft_cap), splits,
            torch.cuda.current_stream(q.device).cuda_stream)
    if paged:
        block_table = aligned(block_table)
        err = build.lib().ttq_paged_decode_attention_launch(
            *head, block_table.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
            B, Hkv, G, gt, rows, nblk, *tail)
    else:
        err = build.lib().ttq_decode_attention_launch(
            *head, cur_pos.data_ptr(), out.data_ptr(), B, Hkv, G, gt, rows,
            *tail)
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return out
