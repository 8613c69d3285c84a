"""Carry a parameter tree of the JAX package across to the port.

``params_from_jax(tree)`` takes the JAX package's parameter tree with its
arrays already turned into numpy (``jax.tree.map(np.asarray, tree)``) and
returns the port's tree: dicts and lists keep their structure, bf16 arrays
go through f32 into torch bf16, and a quantized weight (any object with the
reference ``QuantizedTensor``'s fields) becomes the port's
:class:`~repro_torch.core.ttq.QuantizedTensor`.  It reads the objects by
their fields and imports nothing of the JAX package.

``lowrank_from_jax(tree)`` carries the JAX package's ``lowrank_tree`` (its
numpy form) across the same way, so both packages quantize the residual of
the same factors: SVD signs are ambiguous, and factors computed on each side
need not agree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.ttq import QuantizedTensor

_QT_FIELDS = ("wint", "packed", "scale", "zero", "dinv", "B", "A")


def _tensor(a, dev):
    if a is None:
        return None
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def params_from_jax(tree, device="cuda"):
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if all(hasattr(x, f) for f in _QT_FIELDS + ("bits", "group_size")):
            return QuantizedTensor(
                *(_tensor(getattr(x, f), dev) for f in _QT_FIELDS),
                bits=int(x.bits), group_size=int(x.group_size),
                out_features=int(x.out_features),
                in_features=int(x.in_features))
        return _tensor(x, dev)

    return conv(tree)


def lowrank_from_jax(tree, device="cuda"):
    """A JAX ``lowrank_tree`` (numpy leaves; a {'B', 'A'} pair at each
    factored weight, None elsewhere, or None for no factors at all) → the
    port's tree of the same nesting, for ``QuantizedModel(lowrank=)``."""
    return None if tree is None else params_from_jax(tree, device)
