"""Wrapper of the ``ttq_quantize`` CUDA kernel (``csrc/ttq_quantize.cu``).

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
ttq_quantize_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import build, ref
from ._checks import aligned, dtype_in, on_cuda

NAME = "ttq_quantize"


def ttq_quantize(W: torch.Tensor, D: torch.Tensor, *, bits: int = 4,
                 group_size: int = 32):
    """W (n, d', d) or (d', d), bf16 or f32; D (n, d) or (d,) f32 →
    (packed int32 (..., d', d·bits/32), S, Z f32 (..., d', d/g))."""
    if W.device.type == "cpu":
        return ref.ttq_quantize_ref(W, D, bits=bits, group_size=group_size)
    on_cuda(NAME, W, D)
    dtype_in(NAME, "W", W, (torch.bfloat16, torch.float32))
    dtype_in(NAME, "D", D, (torch.float32,))
    squeeze = W.dim() == 2
    if squeeze:
        W, D = W[None], D[None]
    if W.dim() != 3 or D.shape != (W.shape[0], W.shape[2]):
        raise ValueError(f"{NAME}: W {tuple(W.shape)} / D {tuple(D.shape)} "
                         f"must be (n, d', d) / (n, d)")
    n, dp, d = W.shape
    g = group_size
    if bits not in (2, 4, 8):
        raise ValueError(f"{NAME}: bits={bits} not in (2, 4, 8)")
    per = 32 // bits
    if g & (g - 1) or g < per or g > 512 or d % g:
        raise ValueError(f"{NAME}: group_size={g} must be a power of two in "
                         f"[{per}, 512] dividing d={d}")
    W, D = aligned(W), aligned(D)
    packed = torch.empty((n, dp, d // per), dtype=torch.int32, device=W.device)
    S = torch.empty((n, dp, d // g), dtype=torch.float32, device=W.device)
    Z = torch.empty_like(S)
    err = build.lib().ttq_quantize_launch(
        W.data_ptr(), int(W.dtype == torch.bfloat16), D.data_ptr(),
        packed.data_ptr(), S.data_ptr(), Z.data_ptr(), n, dp, d, bits, g,
        torch.cuda.current_stream(W.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    if squeeze:
        return packed[0], S[0], Z[0]
    return packed, S, Z
