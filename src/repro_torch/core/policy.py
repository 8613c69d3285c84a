"""Per-layer quantization policy — which matmuls get TTQ'd and how.

Same shape as the reference: a frozen ``QuantPolicy`` with fnmatch
``skip`` patterns and ordered ``overrides`` ((pattern, delta) pairs,
resolved against the full parameter path such as ``stack.0.u0.mix.wq``).
The method name resolves through :mod:`repro_torch.quant.registry`.
"""
from __future__ import annotations

import dataclasses
import fnmatch

from .awq import AWQConfig
from .kvquant import KVCacheConfig
from .qdq import QuantConfig

_QCFG_FIELDS = {f.name for f in dataclasses.fields(QuantConfig)}
_ACFG_FIELDS = {f.name for f in dataclasses.fields(AWQConfig)}


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Weight-kernel dispatch.  ``use_pallas=True`` (the reference's field
    name) routes every decode matmul over a packed
    :class:`~repro_torch.core.ttq.QuantizedTensor` through the ``ttq_gemm``
    kernel and the packed requantization through ``ttq_quantize``; False →
    plain PyTorch.  The reference's Pallas block sizes (``bm/bn/bk``,
    ``qbm/qbk``) have no counterpart: the CUDA kernels pick their own
    tiles."""

    use_pallas: bool = False


FUSED_KERNELS = KernelConfig(use_pallas=True)


def override(pattern: str, **delta) -> tuple:
    known = _QCFG_FIELDS | _ACFG_FIELDS | {"method", "rank", "packed",
                                           "per_expert_stats"}
    unknown = set(delta) - known
    if unknown:
        raise ValueError(f"unknown override field(s) {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    return (pattern, tuple(sorted(delta.items())))


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    method: str = "ttq"
    qcfg: QuantConfig = QuantConfig(bits=4, group_size=32, layout="row")
    acfg: AWQConfig = AWQConfig()
    rank: int = 0                  # low-rank residual rank (0 = off)
    skip: tuple = ("embed*", "lm_head", "*norm*", "router*",
                   "w_gate*", "conv*", "pos_embed", "gamma", "beta")
    packed: bool = False           # real int path (kernel) vs fake-quant
    per_expert_stats: bool = True  # the reference's field; read nowhere
                                   # there, so it selects no code path
    overrides: tuple = ()
    kvcache: KVCacheConfig = KVCacheConfig()
    kernel: KernelConfig = KernelConfig()

    @property
    def quantizer(self):
        from repro_torch.quant.registry import get_quantizer
        return get_quantizer(self.method)

    @property
    def enabled(self) -> bool:
        return self.quantizer.enabled

    def methods(self) -> tuple:
        names = [self.method]
        for _, delta in self.overrides:
            for k, v in delta:
                if k == "method" and v not in names:
                    names.append(v)
        return tuple(names)

    @property
    def any_enabled(self) -> bool:
        from repro_torch.quant.registry import get_quantizer
        return any(get_quantizer(m).enabled for m in self.methods())

    def quantizes(self, name: str) -> bool:
        if not self.enabled:
            return False
        return not any(fnmatch.fnmatch(name, pat) for pat in self.skip)

    def with_(self, **kw) -> "QuantPolicy":
        return dataclasses.replace(self, **kw)

    def with_overrides(self, *ovr) -> "QuantPolicy":
        norm = tuple(
            o if isinstance(o[1], tuple) else override(o[0], **o[1])
            for o in ovr)
        return dataclasses.replace(self, overrides=self.overrides + norm)

    def _apply(self, delta: tuple) -> "QuantPolicy":
        top, qkw, akw = {}, {}, {}
        for k, v in delta:
            if k in _QCFG_FIELDS:
                qkw[k] = v
            elif k in _ACFG_FIELDS:
                akw[k] = v
            else:
                top[k] = v
        if qkw:
            top["qcfg"] = dataclasses.replace(self.qcfg, **qkw)
        if akw:
            top["acfg"] = dataclasses.replace(self.acfg, **akw)
        return dataclasses.replace(self, **top)

    def resolve(self, path: str) -> "QuantPolicy":
        """Effective policy for one parameter path (all matches, in order)."""
        eff = self
        for pat, delta in self.overrides:
            if fnmatch.fnmatch(path, pat):
                eff = eff._apply(delta)
        return eff

    def draft_variant(self, bits: int = 4,
                      group_size: int = 0) -> "QuantPolicy":
        """The uniform low-bit sibling that drafts for self-speculative
        decoding: the same method, skip set, KV layout and kernel dispatch,
        one flat ``bits`` (``group_size`` 0 keeps the base group), rank 0
        and no overrides.  A disabled policy is its own draft."""
        if not self.enabled:
            return self
        gs = group_size or self.qcfg.group_size
        return dataclasses.replace(
            self, qcfg=dataclasses.replace(self.qcfg, bits=bits,
                                           group_size=gs),
            rank=0, overrides=())


NO_QUANT = QuantPolicy(method="none")


def ttq_policy(bits: int = 4, group_size: int = 32, rank: int = 16,
               packed: bool = False, kv_dtype: str = "bf16",
               kv_group_size: int = 0, **kw) -> QuantPolicy:
    kw.setdefault("kvcache", KVCacheConfig(dtype=kv_dtype,
                                           group_size=kv_group_size))
    return QuantPolicy(
        method="ttq",
        qcfg=QuantConfig(bits=bits, group_size=group_size, layout="row"),
        rank=rank, packed=packed, **kw,
    )
