"""Argument checks and device facts shared by the kernel wrappers."""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count (what the split rules aim the grid at)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
