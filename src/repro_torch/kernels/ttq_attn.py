"""Wrapper of the ``ttq_decode_attention`` CUDA kernel
(``csrc/ttq_attn.cu``).

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
kv_attn_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import build, ref
from ._checks import aligned, dtype_in, on_cuda

NAME = "ttq_decode_attention"


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
    if bits not in (4, 8):
        raise ValueError(f"{NAME}: bits={bits} not in (4, 8)")
    code_t = torch.int8 if bits == 8 else torch.int32
    dtype_in(NAME, "kq", kq, (code_t,))
    dtype_in(NAME, "vq", vq, (code_t,))
    dtype_in(NAME, "ks", ks, (torch.float32,))
    dtype_in(NAME, "vs", vs, (torch.float32,))
    dtype_in(NAME, "cur_pos", cur_pos, (torch.int32,))
    B, H, one, Dh = q.shape
    _, Hkv, S, Dc = kq.shape
    g = group_size or Dh
    ngr = Dh // g
    if (one != 1 or H % Hkv or kq.shape[0] != B or vq.shape != kq.shape
            or Dc != (Dh if bits == 8 else Dh // 8)
            or ks.shape != (B, Hkv, S, ngr) or vs.shape != ks.shape
            or cur_pos.shape != (B,)):
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, codes "
                         f"{tuple(kq.shape)}, scales {tuple(ks.shape)}, "
                         f"cur_pos {tuple(cur_pos.shape)} disagree")
    G = H // Hkv
    nch = -(-Dh // 256)
    if Dh % 8 or Dh % g or g % 8 or G not in (1, 2, 4) or G * nch > 4:
        raise ValueError(f"{NAME}: unsupported Dh={Dh}, group={g}, G={G}")
    sc = scale if scale is not None else Dh ** -0.5
    qg = (q[:, :, 0].float() * sc).reshape(B, Hkv, G, Dh).contiguous()
    kq, ks, vq, vs, cur_pos = map(aligned, (kq, ks, vq, vs, cur_pos))
    out = torch.empty((B, Hkv, G, Dh), dtype=torch.float32, device=q.device)
    err = build.lib().ttq_decode_attention_launch(
        qg.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), cur_pos.data_ptr(), out.data_ptr(), B, Hkv, G, S, Dh,
        ngr, bits, float(soft_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out.reshape(B, H, 1, Dh).to(q.dtype)
