"""Quantization-method registry: methods are registered objects, not string
``if`` chains.  Slice 1 ports ``ttq`` (D from the live statistics) and
``none`` (quantization off); ``awq``/``rtn``/``gptq`` come later."""
from __future__ import annotations

from typing import Dict

from repro_torch.core.awq import AWQConfig, diag_from_stats

_REGISTRY: Dict[str, object] = {}


def register_quantizer(name: str):
    def deco(cls):
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def get_quantizer(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown or not yet ported quantization method "
                       f"{name!r}; registered: {registered_methods()}") from None


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


@register_quantizer("none")
class NoneQuantizer(_BaseQuantizer):
    """Quantization disabled — parameters stay in full precision."""

    enabled = False
    requires_stats = False

    def quantize_weight(self, W, stat, count, policy, acfg, B=None, A=None):
        return W
