"""Wrapper of the ``ttq_gemm`` CUDA kernel (``csrc/ttq_gemm.cu``).

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
ttq_gemm_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import build, ref
from ._checks import aligned, dtype_in, on_cuda

NAME = "ttq_gemm"


def ttq_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
             zero: torch.Tensor, dinv: torch.Tensor | None = None, *,
             bits: int = 4, group_size: int = 32) -> torch.Tensor:
    """x (..., d) → (..., d') in x's dtype.  packed (d', d·bits/32) int32;
    scale, zero (d', d/g) f32; dinv (d,) f32 or None."""
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
    if d % (4 * per) or d % g or g % per:
        raise ValueError(f"{NAME}: d={d} must divide by {4 * per} and by "
                         f"group_size={g}, and g by {per}")
    T = x2.shape[0]
    x2, packed, scale, zero = map(aligned, (x2, packed, scale, zero))
    dinv = None if dinv is None else aligned(dinv)
    y = torch.empty((T, dp), dtype=x.dtype, device=x.device)
    err = build.lib().ttq_gemm_launch(
        x2.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
        scale.data_ptr(), zero.data_ptr(),
        None if dinv is None else dinv.data_ptr(), y.data_ptr(),
        T, dp, d, bits, g, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return y.reshape(*lead, dp)
