"""Quantization-method registry: methods are registered objects, not string
``if`` chains.  A method is a :class:`Quantizer` registered under a name::

    @register_quantizer("my_method")
    class MyQuantizer:
        requires_stats = True
        def diag(self, stat, count, acfg, d): ...
        def quantize_weight(self, W, stat, count, policy, acfg, B=None, A=None): ...

Built-ins, as in the reference:

* ``ttq``  — D from the live workload's statistics;
* ``awq``  — the same closed form, statistics from an offline set;
* ``rtn``  — round-to-nearest, activation-unaware (D = 1);
* ``gptq`` — on the tree path the diagonal closed form (only diag[XXᵀ] is
  an additive online statistic, and with a diagonal Hessian the OBS
  compensation vanishes); the column-serial algorithm against raw
  activations is ``qdq_reference`` (:func:`repro_torch.core.gptq.gptq_qdq`);
* ``none`` — disabled (full precision).
"""
from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable

import torch

from repro_torch.core.awq import AWQConfig, diag_from_stats


@runtime_checkable
class Quantizer(Protocol):
    """What every registered quantization method implements."""

    name: str               # filled in by @register_quantizer
    enabled: bool           # False → the method leaves params in fp
    requires_stats: bool    # True → needs accumulated activation statistics

    def diag(self, stat: Any, count: Any, acfg: AWQConfig,
             d: int) -> torch.Tensor:
        """Activation scaling D (..., d) from the statistic (..., d)."""
        ...

    def quantize_weight(self, W, stat, count, policy, acfg, B=None, A=None):
        """One (d', d) weight → :class:`repro_torch.core.ttq.QuantizedTensor`."""
        ...


_REGISTRY: Dict[str, Quantizer] = {}


def register_quantizer(name: str):
    def deco(cls):
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def get_quantizer(name: str) -> Quantizer:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown quantization method {name!r}; registered: "
                       f"{registered_methods()}") from None


def registered_methods() -> tuple:
    return tuple(sorted(_REGISTRY))


class _BaseQuantizer:
    enabled = True
    requires_stats = True

    def diag(self, stat, count, acfg: AWQConfig, d: int):
        return diag_from_stats(stat, count, acfg)

    def quantize_weight(self, W, stat, count, policy, acfg, B=None, A=None):
        from repro_torch.core.ttq import quantize_weight
        return quantize_weight(W, self.diag(stat, count, acfg, W.shape[-1]),
                               policy, B, A)


@register_quantizer("ttq")
class TTQQuantizer(_BaseQuantizer):
    """Test-time quantization: D from the live workload's statistics."""


@register_quantizer("awq")
class AWQQuantizer(_BaseQuantizer):
    """The same closed form as TTQ; statistics from an offline set."""


@register_quantizer("rtn")
class RTNQuantizer(_BaseQuantizer):
    """Round-to-nearest: activation-unaware, D = 1 (one row per leading
    index of ``stat``: the fused requant passes an (n, d) stack)."""

    requires_stats = False

    def diag(self, stat, count, acfg: AWQConfig, d: int):
        return torch.ones((*stat.shape[:-1], d), dtype=torch.float32,
                          device=stat.device)


@register_quantizer("gptq")
class GPTQQuantizer(_BaseQuantizer):
    """Diagonal-Hessian GPTQ on the tree path (the activation-aware closed
    form); ``qdq_reference`` runs the column-serial algorithm."""

    @staticmethod
    def qdq_reference(W, X, qcfg):
        from repro_torch.core.gptq import gptq_qdq
        return gptq_qdq(W, X, qcfg)


@register_quantizer("none")
class NoneQuantizer(_BaseQuantizer):
    """Quantization disabled — parameters stay in full precision."""

    enabled = False
    requires_stats = False

    def quantize_weight(self, W, stat, count, policy, acfg, B=None, A=None):
        return W
