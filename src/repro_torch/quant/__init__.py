"""repro_torch.quant — method registry, calibration session, requantization."""
from repro_torch.core.kvquant import BF16_KV, KVCacheConfig
from repro_torch.core.policy import (FUSED_KERNELS, KernelConfig, NO_QUANT,
                                     QuantPolicy, override, ttq_policy)

from .api import FusedRequantPlan, lowrank_tree, quantize_params
from .guards import GuardConfig, qt_health, stats_summary
from .model import QuantizedModel
from .registry import (Quantizer, get_quantizer, register_quantizer,
                       registered_methods)
from .session import CalibrationSession, QuarantineRecord

__all__ = [
    "BF16_KV", "CalibrationSession", "FUSED_KERNELS", "FusedRequantPlan",
    "GuardConfig", "KVCacheConfig", "KernelConfig", "NO_QUANT", "QuantPolicy",
    "QuantizedModel", "Quantizer", "QuarantineRecord", "get_quantizer",
    "lowrank_tree", "override", "qt_health", "quantize_params",
    "register_quantizer", "registered_methods", "stats_summary", "ttq_policy",
]
