"""Wrappers of the ``ttq_decode_attention`` and
``ttq_paged_decode_attention`` CUDA kernels (``csrc/ttq_attn.cu``).

CPU tensors take the plain versions (:func:`repro_torch.kernels.ref.
kv_attn_ref`, :func:`~repro_torch.kernels.ref.kv_paged_attn_ref`); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import build, ref
from ._checks import aligned, dtype_in, on_cuda

NAME = "ttq_decode_attention"
PAGED_NAME = "ttq_paged_decode_attention"


def _prepare(name, q, kq, ks, vq, vs, cur_pos, bits, group_size, scale,
             rows: tuple):
    """Checks shared by both kernels; ``rows`` is the (lead, rows) shape of
    the code and scale tensors — (B, Hkv, S) dense, (NB, Hkv, bs) paged.
    Returns (qg (B, Hkv, G, Dh) f32 pre-scaled, G, n_groups, f32 out)."""
    if bits not in (4, 8):
        raise ValueError(f"{name}: bits={bits} not in (4, 8)")
    code_t = torch.int8 if bits == 8 else torch.int32
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
    G = H // Hkv
    nch = -(-Dh // 256)
    if Dh % 8 or Dh % g or g % 8 or G not in (1, 2, 4) or G * nch > 4:
        raise ValueError(f"{name}: unsupported Dh={Dh}, group={g}, G={G}")
    sc = scale if scale is not None else Dh ** -0.5
    qg = (q[:, :, 0].float() * sc).reshape(B, Hkv, G, Dh).contiguous()
    out = torch.empty((B, Hkv, G, Dh), dtype=torch.float32, device=q.device)
    return qg, G, ngr, out


def ttq_decode_attention(q, kq, ks, vq, vs, cur_pos, *, bits: int = 8,
                         group_size: int = 0, scale: float | None = None,
                         soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,H,1,Dh); kq/vq codes (B,Hkv,S,Dc) int8 or int32 (int4 packed);
    ks/vs (B,Hkv,S,Dh//g) f32; cur_pos (B,) int32 → (B,H,1,Dh) in q's
    dtype.  Rows past ``cur_pos`` are masked."""
    if q.device.type == "cpu":
        return ref.kv_attn_ref(q, kq, ks, vq, vs, cur_pos, bits=bits,
                               group_size=group_size, scale=scale,
                               soft_cap=soft_cap)
    on_cuda(NAME, q, kq, ks, vq, vs, cur_pos)
    B, H, _, Dh = q.shape
    _, Hkv, S, _ = kq.shape
    qg, G, ngr, out = _prepare(NAME, q, kq, ks, vq, vs, cur_pos, bits,
                               group_size, scale, (B, Hkv, S))
    kq, ks, vq, vs, cur_pos = map(aligned, (kq, ks, vq, vs, cur_pos))
    err = build.lib().ttq_decode_attention_launch(
        qg.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), cur_pos.data_ptr(), out.data_ptr(), B, Hkv, G, S, Dh,
        ngr, bits, float(soft_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out.reshape(B, H, 1, Dh).to(q.dtype)


def ttq_paged_decode_attention(q, kq, ks, vq, vs, block_table, cur_pos, *,
                               bits: int = 8, group_size: int = 0,
                               scale: float | None = None,
                               soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,H,1,Dh); kq/vq pool codes (NB,Hkv,bs,Dc) int8 or int32 (int4
    packed); ks/vs (NB,Hkv,bs,Dh//g) f32; block_table (B, nblk) int32
    physical block per logical block; cur_pos (B,) int32 → (B,H,1,Dh) in
    q's dtype.  Rows past ``cur_pos`` are masked and never read.  The block
    table's entries are not checked on the host (that would sync): they
    must lie in [0, NB)."""
    if q.device.type == "cpu":
        return ref.kv_paged_attn_ref(q, kq, ks, vq, vs, block_table, cur_pos,
                                     bits=bits, group_size=group_size,
                                     scale=scale, soft_cap=soft_cap)
    on_cuda(PAGED_NAME, q, kq, ks, vq, vs, block_table, cur_pos)
    dtype_in(PAGED_NAME, "block_table", block_table, (torch.int32,))
    B, H, _, Dh = q.shape
    NB, Hkv, bs, _ = kq.shape
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"{PAGED_NAME}: block_table "
                         f"{tuple(block_table.shape)} is not (B={B}, nblk)")
    nblk = block_table.shape[1]
    if not 0 < nblk <= 2048:
        raise ValueError(f"{PAGED_NAME}: nblk={nblk} not in 1..2048")
    qg, G, ngr, out = _prepare(PAGED_NAME, q, kq, ks, vq, vs, cur_pos, bits,
                               group_size, scale, (NB, Hkv, bs))
    kq, ks, vq, vs, block_table, cur_pos = map(
        aligned, (kq, ks, vq, vs, block_table, cur_pos))
    err = build.lib().ttq_paged_decode_attention_launch(
        qg.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), block_table.data_ptr(), cur_pos.data_ptr(),
        out.data_ptr(), B, Hkv, G, bs, nblk, Dh, ngr, bits, float(soft_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, PAGED_NAME)
    build.LAUNCHES[PAGED_NAME] += 1
    return out.reshape(B, H, 1, Dh).to(q.dtype)
