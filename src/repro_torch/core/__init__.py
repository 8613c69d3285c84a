"""TTQ core: groupwise QDQ, activation statistics, KV quantization, policy,
low-rank factors, the quantized weight type."""
from .awq import AWQConfig, awq_qdq, awq_quantize, diag_from_stats
from .kvquant import BF16_KV, KVCacheConfig, dequantize_kv, quantize_kv
from .lowrank import (alternating_refine, svd_factors, ttq_lowrank_qdq,
                      ttq_lowrank_quantize)
from .policy import (FUSED_KERNELS, KernelConfig, NO_QUANT, QuantPolicy,
                     override, ttq_policy)
from .qdq import QuantConfig, dequantize, pack_bits, quantize, unpack_bits
from .ttq import (QuantizedTensor, dequant, qt_index, quantize_weight,
                  ttq_linear, ttq_matmul)

__all__ = [
    "AWQConfig", "BF16_KV", "FUSED_KERNELS", "KVCacheConfig", "KernelConfig",
    "NO_QUANT", "QuantConfig", "QuantPolicy", "QuantizedTensor",
    "alternating_refine", "awq_qdq", "awq_quantize", "dequant", "dequantize",
    "dequantize_kv", "diag_from_stats", "override", "pack_bits",
    "qt_index", "quantize", "quantize_kv", "quantize_weight", "svd_factors",
    "ttq_linear", "ttq_lowrank_qdq", "ttq_lowrank_quantize", "ttq_matmul",
    "ttq_policy", "unpack_bits",
]
