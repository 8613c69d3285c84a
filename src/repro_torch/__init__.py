"""repro_torch — the TTQ serving loop in PyTorch with hand-written Hopper
kernels (CUDA C++ for sm_90a).

Mirrors the layout of the JAX package ``repro`` (``core/ kernels/ models/
quant/ serving/ configs/``) and its names.  Entry points run on the card
unless the caller passes ``device="cpu"``; on the CPU every kernel wrapper
uses its plain PyTorch version.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
