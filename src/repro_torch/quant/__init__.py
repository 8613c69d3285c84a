"""repro_torch.quant — method registry, calibration session, requantization."""
from repro_torch.core.kvquant import BF16_KV, KVCacheConfig
from repro_torch.core.policy import (FUSED_KERNELS, KernelConfig, NO_QUANT,
                                     QuantPolicy, override, ttq_policy)

from .api import FusedRequantPlan, lowrank_tree, quantize_params
from .model import QuantizedModel
from .registry import (Quantizer, get_quantizer, register_quantizer,
                       registered_methods)
from .session import CalibrationSession

__all__ = [
    "BF16_KV", "CalibrationSession", "FUSED_KERNELS", "FusedRequantPlan",
    "KVCacheConfig", "KernelConfig", "NO_QUANT", "QuantPolicy",
    "QuantizedModel", "Quantizer", "get_quantizer", "lowrank_tree", "override",
    "quantize_params", "register_quantizer", "registered_methods",
    "ttq_policy",
]
