"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def on_cuda(name: str, *tensors: torch.Tensor):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors (CPU tensors take "
                             f"the plain version), got {t.device}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")


def dtype_in(name: str, what: str, t: torch.Tensor, allowed):
    if t.dtype not in allowed:
        raise TypeError(f"{name}: {what} has dtype {t.dtype}, expected one of "
                        f"{[str(a) for a in allowed]}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels use vector loads).  A
    misaligned view is copied, never routed elsewhere."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t
